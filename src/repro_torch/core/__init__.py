"""GredoDB core: unified multi-model storage, graph-centric operators,
GCDI optimizer, and parallel GCDA (the paper's contribution)."""
from .engine import GredoEngine, Profile
from .interbuffer import InterBuffer
from .observe import (FlightRecorder, HealthReport, ReplayMismatch,
                      WorkloadRecorder, evaluate_health, replay)
from .schema import (AnalyticsTask, GCDIATask, JoinPred, Pattern, Predicate,
                     Query, chain_pattern)
from .storage import Database, Graph, Table, shred_documents
from .telemetry import (QErrorMonitor, QueryTrace, Registry, Telemetry,
                        TraceCollector, default_registry,
                        validate_chrome_trace)

__all__ = [
    "GredoEngine", "Profile", "InterBuffer", "Database", "Graph", "Table",
    "shred_documents", "Query", "Pattern", "Predicate", "JoinPred",
    "AnalyticsTask", "GCDIATask", "chain_pattern",
    "Telemetry", "Registry", "TraceCollector", "QueryTrace", "QErrorMonitor",
    "default_registry", "validate_chrome_trace",
    "FlightRecorder", "HealthReport", "WorkloadRecorder", "ReplayMismatch",
    "evaluate_health", "replay",
]
