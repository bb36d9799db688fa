"""Unified observability: span tracing, metrics registry, q-error monitor.

The engine's instrumentation was a handful of disconnected counters
(module-global write counters, cumulative inter-buffer tallies, per-index
staleness counts) plus a text-only ``explain_last``. This module unifies
them behind three primitives, all off-by-default and designed so the
*disabled* path costs a few pointer checks per operator:

* **Metrics** — :class:`Counter` / :class:`Gauge` / :class:`Histogram`
  (fixed log-spaced latency buckets with p50/p95/p99 readout) under one
  namespaced :class:`Registry`. Existing subsystem counters plug in as
  *sources* (pull-based collectors), so ``Registry.snapshot()`` is one flat
  ``name -> value`` dict and :func:`Registry.delta` turns the
  cumulative-forever tallies into correct per-query numbers.
* **Spans** — every physical-operator execution emits a :class:`Span`
  (op kind, wall seconds, rows/bytes, est vs. actual rows, access-path and
  cache provenance) into a bounded per-engine :class:`TraceCollector`.
  Traces export as Chrome trace-event JSON (:meth:`TraceCollector.to_chrome`,
  loadable in Perfetto / ``chrome://tracing``) and as an ``EXPLAIN
  ANALYZE``-style annotated tree (:meth:`QueryTrace.render`).
* **Q-error monitor** — per-operator ``max(est/actual, actual/est)`` row
  ratios land in a bounded misestimate log; operators above a configurable
  threshold are flagged per plan (:class:`QErrorMonitor`) — the feedback
  hook the optimizer's stats revalidation will consume.

GCDA kernel spans carry ``dispatch_s`` (host time until the call returns)
and ``sync_s`` (device synchronise wait), so device time is
attributed separately from host time; ``benchmarks/roofline.py`` consumes
these via its ``from_trace`` helper.

Everything here is dependency-free within the engine (numpy + stdlib; torch
only inside ``fence``), so every core module may import it without cycles.
"""
from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from typing import Any, Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Metrics: counters, gauges, fixed-bucket histograms
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter. ``snapshot()`` values subtract cleanly.
    ``inc`` is lock-guarded — ``+=`` is not atomic under threads and morsel
    workers increment shared counters concurrently."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Point-in-time value (resident bytes, entry counts, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


# Per-decade 1/2.5/5 steps from 1µs to 10s — fixed bucket bounds so two
# histograms (or two snapshots of one) are always mergeable/comparable.
DEFAULT_LATENCY_BUCKETS: tuple = tuple(
    m * 10.0 ** e for e in range(-6, 2) for m in (1.0, 2.5, 5.0))


class Histogram:
    """Fixed-bucket histogram with percentile readout. Buckets are upper
    bounds; an observation lands in the first bucket whose bound is >= the
    value (the last bucket is open-ended). Percentiles interpolate linearly
    inside the winning bucket and clamp to the observed min/max."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, bounds: tuple = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[int(np.searchsorted(self.bounds, v, side="left"))] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """q in [0, 100]. 0 observations -> nan."""
        if self.count == 0:
            return float("nan")
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = 1.0 - (cum - rank) / c
                est = lo + frac * (hi - lo)
                return float(min(max(est, self.min), self.max))
        return self.max

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def summary(self) -> dict:
        if self.count == 0:
            # finite zeros, never NaN: empty histograms flow through
            # snapshots into JSON dumps / OpenMetrics text, where NaN is
            # invalid. `percentile()` itself keeps returning NaN — "no
            # observations" and "p99 == 0.0" are different claims.
            return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "p50": self.p50, "p95": self.p95, "p99": self.p99}

    def reset(self) -> None:
        with self._lock:
            self.counts[:] = 0
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = float("-inf")


class Registry:
    """Namespaced metric registry. Besides push-style metrics (``counter`` /
    ``gauge`` / ``histogram``), subsystems with their own counters register
    as *sources*: a callable returning a flat ``{name: number}`` dict,
    evaluated at :meth:`snapshot` time. That absorbs the pre-existing
    scattered tallies (delta-store write counters, inter-buffer admission,
    index staleness/rebuild counts) without rewriting their hot paths.

    ``snapshot()`` -> flat dict; :func:`Registry.delta` subtracts two
    snapshots — cumulative counters become per-interval numbers (for gauges
    the delta is the net change). Histograms contribute
    ``name.count/.sum/.p50/.p95/.p99``; the percentile keys are absolute
    (session-cumulative) and excluded from deltas."""

    _ABSOLUTE_SUFFIXES = (".p50", ".p95", ".p99")

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._sources: dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: tuple = DEFAULT_LATENCY_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(name, bounds)
            elif not isinstance(m, Histogram):
                raise TypeError(f"{name} is a {type(m).__name__}, not Histogram")
            return m

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"{name} is a {type(m).__name__}, not {cls.__name__}")
            return m

    def register_source(self, namespace: str, fn: Callable[[], dict]) -> None:
        """``fn()`` contributes ``{f"{namespace}.{k}": v}`` per snapshot."""
        with self._lock:
            self._sources[namespace] = fn

    def snapshot(self) -> dict:
        out: dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.items())
            sources = list(self._sources.items())
        for name, m in metrics:
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        for ns, fn in sources:
            try:
                vals = fn()
            except Exception:       # a dead source never breaks a snapshot
                continue
            for k, v in vals.items():
                out[f"{ns}.{k}"] = v
        return out

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """after - before per key (new keys pass through); percentile keys
        are reported as-is from ``after`` (quantiles don't subtract)."""
        out = {}
        for k, v in after.items():
            if k.endswith(Registry._ABSOLUTE_SUFFIXES):
                out[k] = v
                continue
            try:
                out[k] = v - before.get(k, 0)
            except TypeError:
                out[k] = v
        return out

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    @staticmethod
    def _om_name(name: str) -> str:
        """Metric-name sanitizer for the OpenMetrics grammar:
        ``[a-zA-Z_:][a-zA-Z0-9_:]*`` — dots and slashes become
        underscores."""
        n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
        return n if re.match(r"[a-zA-Z_:]", n) else "_" + n

    @staticmethod
    def _om_value(v) -> str:
        v = float(v)
        return repr(int(v)) if v == int(v) else repr(v)

    def to_openmetrics(self) -> str:
        """Render the registry as Prometheus/OpenMetrics exposition text:
        counters as ``<name>_total``, gauges bare, histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``. Source metrics
        (pull-style subsystem tallies) export as gauges under their
        namespace. This is the scrape endpoint payload for serving-layer
        deployments — pair with ``engine.health()``, whose verdicts land
        here as ``health_*`` gauges."""
        with self._lock:
            metrics = sorted(self._metrics.items())
            sources = sorted(self._sources.items())
        lines: list[str] = []
        for name, m in metrics:
            n = self._om_name(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {n} counter",
                          f"{n}_total {self._om_value(m.value)}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {n} gauge",
                          f"{n} {self._om_value(m.value)}"]
            else:                                   # Histogram
                lines.append(f"# TYPE {n} histogram")
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += int(c)
                    lines.append(f'{n}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{n}_bucket{{le="+Inf"}} {m.count}')
                lines += [f"{n}_sum {self._om_value(m.sum)}",
                          f"{n}_count {m.count}"]
        for ns, fn in sources:
            try:
                vals = fn()
            except Exception:       # a dead source never breaks a scrape
                continue
            for k, v in sorted(vals.items()):
                n = self._om_name(f"{ns}.{k}")
                lines += [f"# TYPE {n} gauge", f"{n} {self._om_value(v)}"]
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def __len__(self):
        return len(self._metrics)


_DEFAULT_REGISTRY = Registry()


def default_registry() -> Registry:
    """Process-global registry for callers that want one shared sink.
    New code should prefer a per-engine / per-test Registry (write-path
    counters live per graph in ``Graph.write_counters``)."""
    return _DEFAULT_REGISTRY


# ---------------------------------------------------------------------------
# Spans: per-operator tracing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One operator execution (or cache pseudo-event) in a query trace.
    ``ts``/``dur`` are seconds relative to the owning trace's origin; spans
    of a query nest strictly (a parent opens before and closes after all of
    its children)."""

    id: int
    parent: int             # -1 for the query root
    name: str               # operator kind ("MatchPattern", "EquiJoin", ...)
    cat: str                # "gcdi" | "gcda" | "cache" | "query"
    ts: float
    dur: float = 0.0
    detail: str = ""        # PhysicalOp.describe()
    args: dict = dataclasses.field(default_factory=dict)


class QueryTrace:
    """The span tree of one query/analyze execution. ``begin``/``end`` keep
    an explicit open-span stack, matching the executor's recursion; an
    ``instant`` span records cache hits (inter-buffer / memo) as zero-ish
    duration pseudo-spans so the trace covers every DAG node touched."""

    def __init__(self, label: str, origin: Optional[float] = None):
        self.label = label
        self.t0 = time.perf_counter() if origin is None else origin
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._lock = threading.Lock()
        root = Span(id=0, parent=-1, name="query", cat="query",
                    ts=0.0, detail=label)
        self.spans.append(root)
        self._stack.append(0)

    # -- recording --
    def begin(self, name: str, cat: str = "gcdi", detail: str = "") -> int:
        with self._lock:
            sid = len(self.spans)
            self.spans.append(Span(id=sid, parent=self._stack[-1], name=name,
                                   cat=cat, ts=time.perf_counter() - self.t0,
                                   detail=detail))
            self._stack.append(sid)
            return sid

    def end(self, sid: int, **args) -> None:
        with self._lock:
            s = self.spans[sid]
            s.dur = (time.perf_counter() - self.t0) - s.ts
            if args:
                s.args.update(args)
            while self._stack and self._stack[-1] != sid:
                self._stack.pop()       # tolerate unbalanced ends
            if self._stack:
                self._stack.pop()

    def instant(self, name: str, detail: str = "", **args) -> int:
        sid = self.begin(name, cat="cache", detail=detail)
        self.end(sid, **args)
        return sid

    def close(self, **args) -> None:
        """Close the query root (and anything left open)."""
        for sid in reversed(self._stack[1:]):
            self.end(sid)
        self.end(0, **args)

    # -- views --
    def children_of(self, sid: int) -> list[Span]:
        return [s for s in self.spans if s.parent == sid]

    def shape(self) -> list:
        """Nested ``(name, [children...])`` of the operator spans — directly
        comparable to the physical DAG's structure in tests."""
        def rec(sid: int):
            return [(s.name, rec(s.id)) for s in self.children_of(sid)]
        return rec(0)

    def total_seconds(self) -> float:
        return self.spans[0].dur

    def render(self, top: int = 0) -> str:
        """EXPLAIN ANALYZE-style annotated tree: per-operator wall seconds,
        % of the query total, rows, est vs. actual, cache/access provenance.
        ``top > 0`` appends the k hottest operators by self-time."""
        total = max(self.total_seconds(), 1e-12)
        lines: list[str] = []

        def self_seconds(s: Span) -> float:
            return s.dur - sum(c.dur for c in self.children_of(s.id))

        def rec(sid: int, depth: int):
            for s in self.children_of(sid):
                bits = [f"ms={s.dur * 1e3:.3f}", f"pct={s.dur / total * 100:.1f}%"]
                for k in ("rows", "est_rows", "q_error", "nbytes", "access",
                          "cache", "dispatch_s", "sync_s"):
                    if k in s.args:
                        v = s.args[k]
                        bits.append(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}")
                lines.append("  " * depth + (s.detail or s.name)
                             + "  (" + ", ".join(bits) + ")")
                rec(s.id, depth + 1)

        lines.append(f"{self.label}  (total_ms={total * 1e3:.3f})")
        rec(0, 1)
        if top > 0:
            ops = [s for s in self.spans if s.cat in ("gcdi", "gcda")]
            ops.sort(key=self_seconds, reverse=True)
            lines.append(f"== top {top} operators by self time ==")
            for s in ops[:top]:
                lines.append(f"  {s.detail or s.name}: "
                             f"self_ms={self_seconds(s) * 1e3:.3f} "
                             f"({self_seconds(s) / total * 100:.1f}%)")
        return "\n".join(lines)


class TraceCollector:
    """Bounded per-engine store of recent :class:`QueryTrace` objects. The
    bound is on total retained spans — when a new query would exceed it, the
    oldest whole traces are dropped (``dropped_spans`` counts them)."""

    def __init__(self, max_spans: int = 65536):
        self.max_spans = int(max_spans)
        self.traces: list[QueryTrace] = []
        self.dropped_spans = 0
        self._lock = threading.Lock()

    def start_query(self, label: str) -> QueryTrace:
        qt = QueryTrace(label)
        with self._lock:
            self.traces.append(qt)
            self._trim_locked()
        return qt

    def trim(self) -> None:
        with self._lock:
            self._trim_locked()

    def _trim_locked(self) -> None:
        total = sum(len(t.spans) for t in self.traces)
        while len(self.traces) > 1 and total > self.max_spans:
            victim = self.traces.pop(0)
            total -= len(victim.spans)
            self.dropped_spans += len(victim.spans)

    def last(self) -> Optional[QueryTrace]:
        return self.traces[-1] if self.traces else None

    def clear(self) -> None:
        self.traces.clear()

    # -- export --
    def to_chrome(self, pid: int = 1) -> dict:
        """Chrome trace-event JSON (the "Trace Event Format"), loadable in
        Perfetto / chrome://tracing: one complete ("ph": "X") event per
        span, ts/dur in microseconds, one tid per query trace."""
        events = []
        for tid, qt in enumerate(self.traces):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": qt.label}})
            for s in qt.spans:
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X", "pid": pid,
                    "tid": tid, "ts": s.ts * 1e6, "dur": s.dur * 1e6,
                    "args": {**s.args,
                             **({"detail": s.detail} if s.detail else {})},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_chrome_json(self, pid: int = 1) -> str:
        return json.dumps(self.to_chrome(pid=pid), default=_json_default)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    return str(o)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check of an exported trace (used by the bench-trace smoke
    step and tests). Returns a list of problems — empty means valid."""
    problems: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents"]
    by_tid: dict[int, list[dict]] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key}")
        if ev.get("ph") == "X":
            if not (isinstance(ev.get("ts"), (int, float))
                    and isinstance(ev.get("dur"), (int, float))):
                problems.append(f"event {i}: X event without numeric ts/dur")
            elif ev["ts"] < 0 or ev["dur"] < 0:
                problems.append(f"event {i}: negative ts/dur")
            else:
                by_tid.setdefault(ev["tid"], []).append(ev)
    # spans of one query must nest: each event lies inside its enclosing
    # predecessor (stack discipline over [ts, ts+dur), small float slack)
    eps = 0.5   # µs
    for tid, evs in by_tid.items():
        stack: list[dict] = []
        for ev in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack:
                parent = stack[-1]
                if ev["ts"] + ev["dur"] > parent["ts"] + parent["dur"] + eps:
                    problems.append(
                        f"tid {tid}: span {ev['name']} overlaps parent "
                        f"{parent['name']} without nesting")
            stack.append(ev)
    return problems


# ---------------------------------------------------------------------------
# Q-error monitor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MisEstimate:
    """One flagged operator: estimated vs. actual rows and the q-error
    ratio, with enough provenance to find the plan that produced it."""

    query: str
    op: str
    detail: str
    est_rows: float
    actual_rows: float
    q_error: float

    def __repr__(self):
        return (f"q_error={self.q_error:.1f} {self.op} "
                f"est={self.est_rows:.3g} actual={self.actual_rows:.3g} "
                f"[{self.query}] {self.detail}")


def q_error(est: float, actual: float) -> float:
    """max(est/actual, actual/est) with both sides clamped to >= 1 row —
    the standard cardinality-quality metric (1.0 = perfect)."""
    e = max(float(est), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)


class QErrorMonitor:
    """Per-operator est-vs-actual regression log. Every observation lands
    in the session histogram; observations at or above ``threshold`` are
    kept in a bounded misestimate log (worst-first eviction). The per-plan
    ``flagged`` list is the feedback the optimizer's stats-revalidation
    hook consumes: re-collect statistics for exactly the operators that
    misestimated."""

    def __init__(self, threshold: float = 4.0, max_log: int = 512):
        self.threshold = float(threshold)
        self.max_log = int(max_log)
        self.observations = 0
        self.flagged_total = 0
        self.log: list[MisEstimate] = []
        self.last_plan: list[MisEstimate] = []

    def start_plan(self) -> None:
        self.last_plan = []

    def record(self, query: str, op: str, detail: str,
               est_rows: float, actual_rows: float) -> float:
        qe = q_error(est_rows, actual_rows)
        self.observations += 1
        if qe >= self.threshold:
            self.flagged_total += 1
            m = MisEstimate(query, op, detail, float(est_rows),
                            float(actual_rows), qe)
            self.last_plan.append(m)
            self.log.append(m)
            if len(self.log) > self.max_log:
                self.log.sort(key=lambda x: x.q_error, reverse=True)
                del self.log[self.max_log:]
        return qe

    def worst(self, k: int = 5) -> list[MisEstimate]:
        return sorted(self.log, key=lambda m: m.q_error, reverse=True)[:k]

    def metrics(self) -> dict:
        return {"observations": self.observations,
                "flagged": self.flagged_total,
                "log_size": len(self.log)}


# ---------------------------------------------------------------------------
# GCDA kernel attribution helpers
# ---------------------------------------------------------------------------

GCDA_KINDS = ("Rel2Matrix", "RandomAccessMatrix", "MatMul", "Similarity",
              "Regression", "Const", "DeviceMatchPattern")


def _on_cuda(value) -> bool:
    if isinstance(value, tuple):
        return any(_on_cuda(v) for v in value)
    return getattr(getattr(value, "device", None), "type", None) == "cuda"


def fence(value) -> float:
    """Synchronise the device when ``value`` (a tensor or a tuple of them)
    lives on a CUDA device; returns the seconds spent waiting. Host values
    and CPU tensors cost one attribute probe and never synchronise."""
    t0 = time.perf_counter()
    if _on_cuda(value):
        import torch
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernel_args(kind: str, inputs: tuple, out, iters: int = 1) -> dict:
    """Analytic flops/bytes of one GCDA operator execution, derived from
    runtime shapes (the flop model lives with the kernels in
    ``analytics.flops_estimate``) — the span payload
    ``roofline.from_trace()`` reads."""
    from . import analytics

    def shape(v):
        return tuple(int(d) for d in getattr(v, "shape", ()) or ())

    def nbytes(v):
        n = getattr(v, "nbytes", None)
        return int(n) if n is not None else 0

    args: dict[str, Any] = {}
    shapes = [shape(v) for v in inputs]
    flops = analytics.flops_estimate(kind, shapes, iters=iters)
    if flops:
        args["flops"] = flops
    total_bytes = sum(nbytes(v) for v in inputs) + nbytes(out)
    if total_bytes:
        args["bytes"] = total_bytes
    if shapes:
        args["in_shapes"] = [list(s) for s in shapes]
    return args


# ---------------------------------------------------------------------------
# The per-engine telemetry session
# ---------------------------------------------------------------------------


class Telemetry:
    """One engine's observability session: a :class:`Registry`, a bounded
    :class:`TraceCollector`, and a :class:`QErrorMonitor`. Constructed via
    ``GredoEngine(telemetry=True)`` / ``GredoEngine(telemetry=Telemetry(...))``
    or transiently by ``engine.profile``. ``fence_device`` controls whether
    GCDA outputs are synchronized (``block_until_ready``) inside their span
    so device time is attributed to the producing operator — tracing-only
    behavior; the disabled path never fences."""

    def __init__(self, registry: Optional[Registry] = None,
                 max_spans: int = 65536, qerror_threshold: float = 4.0,
                 fence_device: bool = True):
        self.registry = registry if registry is not None else Registry()
        self.collector = TraceCollector(max_spans=max_spans)
        self.qerror = QErrorMonitor(threshold=qerror_threshold)
        self.fence_device = fence_device
        self.registry.register_source("qerror", self.qerror.metrics)

    def last_trace(self) -> Optional[QueryTrace]:
        return self.collector.last()
