"""Production observability: flight recorder, health rules, workload replay.

This is the always-on layer *above* ``repro_torch.core.telemetry``. Telemetry is a
scalpel — spans, registry, q-error monitor — that the user switches on for a
profiling session. This module is the seatbelt that is worn in production:

**Flight recorder** (`FlightRecorder`) — a bounded ring of recent query
records (label, plan fingerprint, operator stats, inter-buffer / registry
deltas, q-error flags, verify report). Capture is cheap enough to stay on
when tracing is off: everything in a record is data the engine already
computed for ``explain_last``. On a *trigger* — latency over the template's
SLO (or an EWMA-based anomaly), a q-error flag, a ``PlanVerificationError``,
a kernel overflow-retry storm, an inter-buffer hit-rate collapse — the ring
is dumped to ``experiments/flight_*.json`` so the incident is debuggable
after the fact.

**Health rules** (`evaluate_health`) — a rule table over registry snapshots
and the recorder's per-template latency EWMAs (latency vs SLO, q-error
drift, inter-buffer hit rate, shard skew, exchange reuse, index refresh
churn, kernel retry storms), folded into an ok/warn/critical
``HealthReport``. ``GredoEngine.health()`` renders it in ``explain_last``
and exports it as gauges; ``Registry.to_openmetrics()`` serves the whole
registry as Prometheus/OpenMetrics text.

**Workload capture & replay** (`WorkloadRecorder`, `replay`) — the
interleaved query/mutation stream is recorded to JSONL (queries with result
fingerprints and the source epochs they saw; graph mutations with full
payloads) and replayed deterministically against a fresh database, so any
flight-recorder dump or bench regression is reproducible offline.

Import discipline: this module must not import ``engine`` at module scope
(engine imports us); ``replay`` imports it lazily.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import collections
from typing import Any, Optional

import numpy as np

from .schema import (AnalyticsTask, GCDIATask, JoinPred, Pattern,
                     PatternEdge, PatternVertex, Predicate, Query)

__all__ = [
    "FlightRecorder", "QueryRecord", "HealthCheck", "HealthReport",
    "WorkloadRecorder", "ReplayMismatch", "ReplayReport", "replay",
    "evaluate_health", "query_to_dict", "query_from_dict", "task_to_dict",
    "task_from_dict", "result_fingerprint",
]


# =========================================================================
# serialization helpers (queries, tasks, arrays, results)
# =========================================================================

def _scalar(v):
    """numpy scalar -> python scalar (JSON-safe); passthrough otherwise."""
    return v.item() if isinstance(v, np.generic) else v


def _encode_value(v):
    """JSON-encode a mutation-payload value: ndarray -> tagged dict with
    dtype preserved; nested lists (ragged column data) recurse."""
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    return _scalar(v)


def _decode_value(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
    if isinstance(v, dict):
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


def _detuple(v):
    """JSON round-trips tuples as lists; analytics task inputs are nested
    tuples of str/int — restore them so replayed plan signatures match."""
    return tuple(_detuple(x) for x in v) if isinstance(v, list) else v


def query_to_dict(q: Query) -> dict:
    d: dict[str, Any] = {"select": list(q.select), "froms": list(q.froms)}
    if q.match is not None:
        d["match"] = {
            "graph": q.match.graph,
            "vertices": [[v.var, v.label] for v in q.match.vertices],
            "edges": [[e.var, e.label, e.src, e.dst] for e in q.match.edges],
        }
    d["joins"] = [[j.left, j.right] for j in q.joins]
    d["where"] = [[p.attr, p.op, _scalar(p.value), _scalar(p.value2)]
                  for p in q.where]
    return d


def query_from_dict(d: dict) -> Query:
    match = None
    if d.get("match"):
        m = d["match"]
        match = Pattern(
            graph=m["graph"],
            vertices=tuple(PatternVertex(*v) for v in m["vertices"]),
            edges=tuple(PatternEdge(*e) for e in m["edges"]))
    return Query(
        select=tuple(d["select"]), froms=tuple(d["froms"]), match=match,
        joins=tuple(JoinPred(*j) for j in d.get("joins", ())),
        where=tuple(Predicate(*w) for w in d.get("where", ())))


def task_to_dict(t: GCDIATask) -> dict:
    a = t.analytics
    return {"integration": query_to_dict(t.integration),
            "analytics": {"op": a.op,
                          "inputs": [_encode_value(i) for i in a.inputs],
                          "params": dict(a.params)}}


def task_from_dict(d: dict) -> GCDIATask:
    a = d["analytics"]
    return GCDIATask(
        integration=query_from_dict(d["integration"]),
        analytics=AnalyticsTask(a["op"],
                                [_detuple(i) for i in a["inputs"]],
                                dict(a.get("params", {}))))


def result_fingerprint(out) -> str:
    """Stable 16-hex content hash of a query/task result. Tables hash every
    column (dictionary columns by *decoded* values, so vocab numbering can't
    alias; ragged columns by values+offsets); arrays hash dtype+bytes.
    Device arrays are pulled to host — call this off the hot path."""
    import hashlib
    h = hashlib.sha256()
    cols = getattr(out, "columns", None)
    if cols is not None:                              # Table
        for name in cols:
            col = cols[name]
            h.update(name.encode())
            if hasattr(col, "codes"):                 # DictColumn
                vals = col.decode(col.codes)
                h.update("|".join(str(v) for v in vals).encode())
            elif hasattr(col, "offsets"):             # RaggedColumn
                h.update(np.ascontiguousarray(
                    np.asarray(col.values)).tobytes())
                h.update(np.ascontiguousarray(
                    np.asarray(col.offsets)).tobytes())
            else:
                a = np.ascontiguousarray(np.asarray(col))
                h.update(str(a.dtype).encode())
                h.update(a.tobytes())
        return h.hexdigest()[:16]
    if isinstance(out, tuple):                        # e.g. (weights, loss)
        for part in out:
            h.update(result_fingerprint(part).encode())
        return h.hexdigest()[:16]
    if hasattr(out, "detach"):                        # tensor: to host first
        out = out.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(out))
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def _finite(d: dict) -> dict:
    """Drop NaN/inf values (empty-histogram percentiles etc.) and coerce
    numpy scalars so the dict is strict-JSON dumpable."""
    out = {}
    for k, v in d.items():
        v = _scalar(v)
        if isinstance(v, float) and not math.isfinite(v):
            continue
        out[k] = v
    return out


# =========================================================================
# flight recorder
# =========================================================================

@dataclasses.dataclass
class QueryRecord:
    """One entry of the flight-recorder ring — everything needed to explain
    a single execution after the fact, already JSON-shaped."""

    seq: int
    ts: float                     # wall-clock (time.time) at capture
    label: str                    # query/task template label
    kind: str                     # "query" | "analyze" | "verify"
    mode: str
    plan_fingerprint: str         # fingerprint(dag.signature()) — epoch-aware
    seconds: Optional[float]
    shard_count: int
    operators: list               # physical.collect_stats rows
    interbuffer: dict             # this query's inter-buffer counter delta
    registry_delta: dict          # per-query registry delta (telemetry on)
    qerrors: list                 # flagged MisEstimates (telemetry on)
    verify: list                  # verify-report lines (debug mode)
    spans: list                   # span tree (tracing on), bounded
    triggers: list                # trigger names that fired on this record

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


_MAX_RECORD_SPANS = 512


def _span_tree(trace) -> list:
    """Serialize a QueryTrace's spans (id/parent/name/dur/detail), bounded
    so one pathological plan can't bloat every dump."""
    if trace is None:
        return []
    spans = list(getattr(trace, "spans", ()))[:_MAX_RECORD_SPANS]
    return [{"id": s.id, "parent": s.parent, "name": s.name, "cat": s.cat,
             "dur": round(s.dur, 9), "detail": s.detail,
             "args": _finite({k: v for k, v in s.args.items()
                              if isinstance(v, (int, float, str, bool))})}
            for s in spans]


class FlightRecorder:
    """Bounded ring of recent :class:`QueryRecord` s with trigger-driven
    auto-dump. Default-on per engine (``GredoEngine(observe=False)`` opts
    out); capture reuses the engine's ``last_*`` state so the per-query cost
    is a handful of dict builds.

    Triggers (each dumps the ring to ``dump_dir/flight_*.json``):

    - ``slo-breach`` — latency over the template's explicit SLO
      (``slo={"template": seconds}`` or ``default_slo``).
    - ``latency-anomaly`` — latency over ``anomaly_factor`` x the template's
      latency EWMA after ``warmup`` samples (and over ``anomaly_floor_s``,
      so micro-query jitter never fires it).
    - ``qerror`` — the telemetry q-error monitor flagged this plan.
    - ``verify-error`` — the static plan verifier raised (record captured
      via :meth:`record_verify_error` before the exception propagates).
    - ``kernel-retry-storm`` — >= ``retry_storm`` traversal-kernel overflow
      retries/recompiles within one query.
    - ``interbuffer-collapse`` — the hit-rate EWMA fell below
      ``collapse_frac`` of its historical peak (after the peak cleared
      ``collapse_min_peak``).
    """

    def __init__(self, ring: int = 64,
                 slo: Optional[dict] = None,
                 default_slo: Optional[float] = None,
                 anomaly_factor: float = 8.0,
                 anomaly_floor_s: float = 0.25,
                 ewma_alpha: float = 0.2,
                 warmup: int = 8,
                 retry_storm: int = 2,
                 collapse_frac: float = 0.25,
                 collapse_min_peak: float = 0.5,
                 dump_dir: str = "experiments",
                 auto_dump: bool = True,
                 max_dumps: int = 8):
        self.ring: "collections.deque[QueryRecord]" = \
            collections.deque(maxlen=ring)
        self.slo = dict(slo) if slo else {}
        self.default_slo = default_slo
        self.anomaly_factor = anomaly_factor
        self.anomaly_floor_s = anomaly_floor_s
        self.ewma_alpha = ewma_alpha
        self.warmup = warmup
        self.retry_storm = retry_storm
        self.collapse_frac = collapse_frac
        self.collapse_min_peak = collapse_min_peak
        self.dump_dir = dump_dir
        self.auto_dump = auto_dump
        self.max_dumps = max_dumps
        self.seq = 0
        self.latency_ewma: dict[str, float] = {}     # per-template seconds
        self.latency_n: dict[str, int] = {}
        self.hit_ewma: Optional[float] = None        # inter-buffer hit rate
        self.hit_peak = 0.0
        self.trigger_counts: dict[str, int] = {}
        self.dump_paths: list[str] = []
        self.dumps_suppressed = 0
        self._retries0 = 0

    # ---------------------------------------------------------- capture
    def begin(self, label: str) -> None:
        """Pre-query hook: snapshot the traversal-kernel retry counters so
        ``observe`` can attribute a retry storm to this query alone."""
        from . import pattern_jit
        c = pattern_jit.COUNTERS
        self._retries0 = c.retries + c.recompiles

    def observe(self, engine, kind: str = "query") -> Optional[QueryRecord]:
        """Post-query hook (engine._finish_query): build a record from the
        engine's ``last_*`` state, evaluate triggers, append to the ring,
        dump if anything fired."""
        stats = engine.last_stats
        if stats is None or engine.last_dag is None:
            return None
        from . import pattern_jit, physical
        tel = engine.telemetry
        trace = tel.collector.last() if tel is not None else None
        qerrors = (list(tel.qerror.last_plan) if tel is not None else [])
        label = getattr(engine, "_last_label", "") or kind
        seconds = stats.seconds
        rec = QueryRecord(
            seq=self.seq, ts=time.time(), label=label, kind=kind,
            mode=engine.mode,
            plan_fingerprint=physical.plan_fingerprint(engine.last_dag),
            seconds=seconds, shard_count=engine.last_shard_count,
            operators=list(stats.operators or ()),
            interbuffer=_finite(engine.last_interbuffer_delta),
            registry_delta=(_finite({k: v for k, v
                                     in engine.last_registry_delta.items()
                                     if v})
                            if tel is not None else {}),
            qerrors=[dataclasses.asdict(m) for m in qerrors],
            verify=(engine.last_verify.render()
                    if engine.debug and engine.last_verify is not None
                    else []),
            spans=_span_tree(trace),
            triggers=[])
        self.seq += 1
        rec.triggers = self._evaluate(rec, engine)
        self.ring.append(rec)
        for t in rec.triggers:
            self._dump(t, rec)
        return rec

    def record_verify_error(self, engine, label: str, dag,
                            report) -> Optional[str]:
        """Called by the engine just before ``PlanVerificationError``
        propagates: capture the failing plan + report and dump."""
        from . import physical
        rec = QueryRecord(
            seq=self.seq, ts=time.time(), label=label, kind="verify",
            mode=engine.mode,
            plan_fingerprint=(physical.plan_fingerprint(dag)
                              if dag is not None else ""),
            seconds=None, shard_count=engine.last_shard_count,
            operators=[], interbuffer={}, registry_delta={}, qerrors=[],
            verify=report.render(), spans=[], triggers=["verify-error"])
        self.seq += 1
        self.ring.append(rec)
        return self._dump("verify-error", rec)

    # --------------------------------------------------------- triggers
    def _evaluate(self, rec: QueryRecord, engine) -> list[str]:
        fired: list[str] = []
        label, seconds = rec.label, rec.seconds or 0.0

        # 1. explicit SLO / EWMA latency anomaly
        slo = self.slo.get(label, self.default_slo)
        if slo is not None and seconds > slo:
            fired.append("slo-breach")
        ewma = self.latency_ewma.get(label)
        n = self.latency_n.get(label, 0)
        if (ewma is not None and n >= self.warmup
                and seconds > max(self.anomaly_factor * ewma,
                                  self.anomaly_floor_s)):
            fired.append("latency-anomaly")
        a = self.ewma_alpha
        self.latency_ewma[label] = (seconds if ewma is None
                                    else (1 - a) * ewma + a * seconds)
        self.latency_n[label] = n + 1

        # 2. q-error flag (telemetry on)
        if rec.qerrors:
            fired.append("qerror")

        # 3. traversal-kernel overflow-retry storm within this query
        from . import pattern_jit
        c = pattern_jit.COUNTERS
        if (c.retries + c.recompiles) - self._retries0 >= self.retry_storm:
            fired.append("kernel-retry-storm")

        # 4. inter-buffer hit-rate collapse (EWMA vs. historical peak)
        ib = rec.interbuffer
        lookups = ib.get("hits", 0) + ib.get("misses", 0)
        if lookups > 0:
            rate = ib.get("hits", 0) / lookups
            self.hit_ewma = (rate if self.hit_ewma is None
                             else (1 - a) * self.hit_ewma + a * rate)
            self.hit_peak = max(self.hit_peak, self.hit_ewma)
            if (self.hit_peak >= self.collapse_min_peak
                    and self.hit_ewma < self.collapse_frac * self.hit_peak):
                fired.append("interbuffer-collapse")
        return fired

    # ------------------------------------------------------------- dump
    def _dump(self, trigger: str, rec: QueryRecord) -> Optional[str]:
        self.trigger_counts[trigger] = self.trigger_counts.get(trigger, 0) + 1
        if not self.auto_dump:
            return None
        if len(self.dump_paths) >= self.max_dumps:
            self.dumps_suppressed += 1      # bound incident-storm disk cost
            return None
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(self.dump_dir,
                            f"flight_{rec.seq:05d}_{trigger}.json")
        doc = {"version": 1, "trigger": trigger, "captured_at": rec.ts,
               "record": rec.to_json(),
               "ring": [r.to_json() for r in self.ring],
               "latency_ewma": {k: round(v, 9)
                                for k, v in self.latency_ewma.items()},
               "trigger_counts": dict(self.trigger_counts)}
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
        self.dump_paths.append(path)
        return path

    def metrics(self) -> dict:
        """Registry-source snapshot (namespace ``flight.``)."""
        out = {"records": float(self.seq),
               "dumps": float(len(self.dump_paths)),
               "dumps_suppressed": float(self.dumps_suppressed)}
        for t, n in self.trigger_counts.items():
            out[f"triggers.{t}"] = float(n)
        return out


# =========================================================================
# health rules
# =========================================================================

OK, WARN, CRITICAL = "ok", "warn", "critical"
_LEVELS = (OK, WARN, CRITICAL)          # index == severity order


@dataclasses.dataclass
class HealthCheck:
    name: str
    level: str        # ok | warn | critical
    detail: str


@dataclasses.dataclass
class HealthReport:
    status: str
    checks: list

    def render(self) -> list[str]:
        lines = [f"status: {self.status}"]
        lines += [f"[{c.level:>8}] {c.name}: {c.detail}" for c in self.checks]
        return lines

    def as_metrics(self) -> dict:
        """Gauge view (0=ok 1=warn 2=critical) — exported by
        ``engine.health()`` so OpenMetrics scrapes carry the verdicts."""
        out = {"health.status": float(_LEVELS.index(self.status))}
        for c in self.checks:
            out[f"health.{c.name}"] = float(_LEVELS.index(c.level))
        return out


def _rule_latency_slo(snap, fr) -> HealthCheck:
    if fr is None or not (fr.slo or fr.default_slo):
        return HealthCheck("latency_slo", OK, "no SLO configured")
    worst, level = "all templates within SLO", OK
    for label, ewma in sorted(fr.latency_ewma.items()):
        slo = fr.slo.get(label, fr.default_slo)
        if slo is None:
            continue
        if ewma > slo and level != CRITICAL:
            worst, level = (f"{label}: ewma {ewma:.3f}s > slo {slo:.3f}s",
                            CRITICAL)
        elif ewma > 0.8 * slo and level == OK:
            worst, level = (f"{label}: ewma {ewma:.3f}s within 20% of "
                            f"slo {slo:.3f}s", WARN)
    return HealthCheck("latency_slo", level, worst)


def _rule_qerror_drift(snap, fr) -> HealthCheck:
    obs = snap.get("qerror.observations", 0)
    flagged = snap.get("qerror.flagged", 0)
    if obs < 20:
        return HealthCheck("qerror_drift", OK,
                           f"{int(obs)} observations (need 20)")
    frac = flagged / obs
    level = CRITICAL if frac > 0.5 else WARN if frac > 0.2 else OK
    return HealthCheck("qerror_drift", level,
                       f"{int(flagged)}/{int(obs)} estimates flagged "
                       f"({frac:.0%})")


def _rule_interbuffer(snap, fr) -> HealthCheck:
    hits = snap.get("interbuffer.hits", 0)
    misses = snap.get("interbuffer.misses", 0)
    lookups = hits + misses
    if fr is not None and fr.hit_peak >= fr.collapse_min_peak \
            and fr.hit_ewma is not None \
            and fr.hit_ewma < fr.collapse_frac * fr.hit_peak:
        return HealthCheck("interbuffer", CRITICAL,
                           f"hit-rate ewma {fr.hit_ewma:.2f} collapsed from "
                           f"peak {fr.hit_peak:.2f}")
    if lookups < 16:
        return HealthCheck("interbuffer", OK,
                           f"{int(lookups)} lookups (need 16)")
    rate = hits / lookups
    level = WARN if rate < 0.05 else OK
    return HealthCheck("interbuffer", level,
                       f"hit rate {rate:.2f} over {int(lookups)} lookups")


def _rule_shard_skew(snap, fr) -> HealthCheck:
    parts = snap.get("shard.shard_partitions", 0)
    if parts < 4:
        return HealthCheck("shard_skew", OK, "no sharded partitions yet")
    mean = snap.get("shard.rows_shard_mean", 0.0)
    peak = snap.get("shard.rows_shard_max", 0.0)
    if mean <= 0:
        return HealthCheck("shard_skew", OK, "no shard rows recorded")
    skew = peak / mean
    level = CRITICAL if skew > 8 else WARN if skew > 3 else OK
    return HealthCheck("shard_skew", level,
                       f"max/mean rows per shard = {skew:.1f}")


def _rule_exchange_reuse(snap, fr) -> HealthCheck:
    built = snap.get("shard.exchanges_built", 0)
    reused = snap.get("shard.exchanges_reused", 0)
    total = built + reused
    if total < 8:
        return HealthCheck("exchange_reuse", OK,
                           f"{int(total)} exchanges (need 8)")
    rate = reused / total
    level = WARN if rate < 0.1 else OK
    return HealthCheck("exchange_reuse", level,
                       f"reuse rate {rate:.2f} ({int(reused)}/{int(total)})")


def _rule_index_churn(snap, fr) -> HealthCheck:
    lookups = refreshes = 0.0
    for k, v in snap.items():
        if not k.startswith("index."):
            continue
        if k.endswith(".lookups"):
            lookups += v
        elif k.endswith(".refreshes") or k.endswith(".rebuilds"):
            refreshes += v
    if lookups < 16:
        return HealthCheck("index_churn", OK,
                           f"{int(lookups)} index lookups (need 16)")
    churn = refreshes / lookups
    level = CRITICAL if churn > 0.5 else WARN if churn > 0.2 else OK
    return HealthCheck("index_churn", level,
                       f"{int(refreshes)} refreshes / {int(lookups)} lookups "
                       f"({churn:.0%} staleness churn)")


def _rule_kernel_retries(snap, fr) -> HealthCheck:
    matches = snap.get("traversal_kernels.matches", 0)
    retries = (snap.get("traversal_kernels.retries", 0)
               + snap.get("traversal_kernels.recompiles", 0))
    if matches < 8:
        return HealthCheck("kernel_retries", OK,
                           f"{int(matches)} kernel matches (need 8)")
    rate = retries / matches
    level = CRITICAL if rate > 1.0 else WARN if rate > 0.25 else OK
    return HealthCheck("kernel_retries", level,
                       f"{int(retries)} overflow retries over "
                       f"{int(matches)} matches")


_HEALTH_RULES = (
    ("latency_slo", _rule_latency_slo),
    ("qerror_drift", _rule_qerror_drift),
    ("interbuffer", _rule_interbuffer),
    ("shard_skew", _rule_shard_skew),
    ("exchange_reuse", _rule_exchange_reuse),
    ("index_churn", _rule_index_churn),
    ("kernel_retries", _rule_kernel_retries),
)


def evaluate_health(snapshot: dict,
                    recorder: Optional[FlightRecorder] = None
                    ) -> HealthReport:
    """Fold the rule table over a registry snapshot (flat ``ns.key`` ->
    number dict, e.g. ``engine.metrics_snapshot()``) plus the flight
    recorder's EWMAs. Rules that lack enough evidence report ``ok`` with a
    "(need N)" note rather than guessing."""
    checks = [fn(snapshot, recorder) for _, fn in _HEALTH_RULES]
    status = max((c.level for c in checks), key=_LEVELS.index, default=OK)
    return HealthReport(status=status, checks=checks)


# =========================================================================
# workload capture & replay
# =========================================================================

class ReplayMismatch(AssertionError):
    """Replay produced a different result relation than was captured."""


@dataclasses.dataclass
class ReplayReport:
    queries: int = 0
    analytics: int = 0
    mutations: int = 0
    mismatches: list = dataclasses.field(default_factory=list)
    results: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


class WorkloadRecorder:
    """Context manager that records the interleaved query/mutation stream
    of one engine to JSONL (``engine.record(path)``). Each query event
    carries the result fingerprint and the source write-epochs it observed;
    graph mutations are captured via ``Graph.listeners`` with their full
    payloads, so ``replay`` can reproduce the stream — including epoch
    bumps, delta-store growth, and compactions — on a fresh database."""

    def __init__(self, engine, path: str):
        self.engine = engine
        self.path = path
        self.events = 0
        self._fh = None
        self._graphs: list = []

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "WorkloadRecorder":
        eng, db = self.engine, self.engine.db
        self._fh = open(self.path, "w")
        self._write({"kind": "header", "version": 1, "mode": eng.mode,
                     "n_shards": eng.n_shards,
                     "epochs": self._epochs()})
        eng._recorder = self
        for g in db.graphs.values():
            g.listeners.append(self._on_graph)
            self._graphs.append(g)
        db.listeners.append(self._on_db)
        return self

    def __exit__(self, *exc) -> None:
        self.engine._recorder = None
        for g in self._graphs:
            if self._on_graph in g.listeners:
                g.listeners.remove(self._on_graph)
        db = self.engine.db
        if self._on_db in db.listeners:
            db.listeners.remove(self._on_db)
        self._fh.close()
        self._fh = None

    def _epochs(self) -> dict:
        db = self.engine.db
        out = {name: db.epoch_of(name) for name in db.tables}
        out.update({name: g.epoch for name, g in db.graphs.items()})
        return out

    def _write(self, ev: dict) -> None:
        self._fh.write(json.dumps(ev, default=str) + "\n")
        self.events += 1

    # --------------------------------------------------------------- events
    def log_query(self, q: Query, result, seconds: float) -> None:
        self._write({"kind": "query", "query": query_to_dict(q),
                     "rows": getattr(result, "nrows", None),
                     "fp": result_fingerprint(result),
                     "seconds": round(seconds, 9),
                     "epochs": self._epochs()})

    def log_analyze(self, task: GCDIATask, out, *, iters: int,
                    use_kernel, seconds: float) -> None:
        self._write({"kind": "analyze", "task": task_to_dict(task),
                     "iters": iters, "use_kernel": use_kernel,
                     "fp": result_fingerprint(out),
                     "seconds": round(seconds, 9),
                     "epochs": self._epochs()})

    def _on_graph(self, graph, op: str, payload: dict) -> None:
        self._write({"kind": op, "graph": graph.name,
                     "payload": {k: _encode_value(v)
                                 for k, v in payload.items()}})

    def _on_db(self, op: str, name: str) -> None:
        self._write({"kind": op, "name": name})


def _apply_mutation(db, ev: dict) -> None:
    g = db.graphs[ev["graph"]]
    p = {k: _decode_value(v) for k, v in ev["payload"].items()}
    if ev["kind"] == "insert_vertices":
        g.insert_vertices(p["label"], p["rows"])
    elif ev["kind"] == "insert_edges":
        g.insert_edges(p["rows"])
    elif ev["kind"] == "delete_edges":
        g.delete_edges(p["edge_tids"])
    else:
        raise ValueError(f"unknown mutation event {ev['kind']!r}")


def replay(db, path: str, *, mode: Optional[str] = None,
           n_shards: Optional[int] = None, strict: bool = True,
           engine=None, keep_results: bool = False,
           **engine_kw) -> ReplayReport:
    """Replay a captured workload against ``db`` (normally a fresh
    ``m2bench.generate`` twin of the recorded database). Queries re-execute
    through a ``GredoEngine`` (mode/shards default to the recorded header);
    mutations re-apply via the graph write path, reproducing epoch bumps
    and delta-store growth. Each query's result fingerprint is checked
    against the capture — ``strict=True`` raises :class:`ReplayMismatch`
    on the first divergence."""
    from .engine import GredoEngine     # lazy: engine imports this module
    with open(path) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    header = events[0] if events and events[0].get("kind") == "header" else {}
    body = events[1:] if header else events
    eng = engine
    if eng is None:
        eng = GredoEngine(db, mode=mode or header.get("mode", "gredo"),
                          n_shards=n_shards or header.get("n_shards", 1),
                          **engine_kw)
    report = ReplayReport()
    for i, ev in enumerate(body):
        kind = ev["kind"]
        if kind == "query":
            out = eng.query(query_from_dict(ev["query"]))
            report.queries += 1
        elif kind == "analyze":
            out = eng.analyze(task_from_dict(ev["task"]),
                              iters=ev.get("iters", 100),
                              use_kernel=ev.get("use_kernel"))
            report.analytics += 1
        elif kind == "touch_table":
            db.touch_table(ev["name"])
            report.mutations += 1
            continue
        else:
            _apply_mutation(db, ev)
            report.mutations += 1
            continue
        fp = result_fingerprint(out)
        if ev.get("fp") and fp != ev["fp"]:
            msg = (f"event {i}: replayed {kind} fingerprint {fp} != "
                   f"captured {ev['fp']} (label={ev.get('query') or ev.get('task')})")
            report.mismatches.append(msg)
            if strict:
                raise ReplayMismatch(msg)
        if keep_results:
            report.results.append(out)
    return report
