"""GredoEngine — the unified query processing engine facade (paper Fig. 2).

GCDI: parse(SFMW AST) -> plan (optimizer §6.2) -> physical DAG -> execute.
GCDA: the same DAG grows matrix-generation and analytical-operator nodes;
intermediate results are materialized in the inter-buffer keyed by node
*signatures* (structural plan matching §6.4), so a repeated GCDIA with a
different analytics op reuses the GCDI relation and matrices mid-plan.

``mode`` selects the ablation variant (§7.2):
  * "gredo"   — full system (operators + optimizations)      [GredoDB]
  * "dual"    — topology traversal, no pushdown/optimization  [GredoDB-D]
  * "single"  — no topology store: matches run as edge-table
                equi-joins in the relational engine           [GredoDB-S]

All three modes execute through the same physical executor — they differ
only in the plan shape that DAG construction emits (``physical.build_gcdi``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import join as join_mod, optimizer as optimizer_mod
from . import observe as observe_mod
from . import pattern as pattern_mod, physical, planner
from . import telemetry as telemetry_mod
from . import verify as verify_mod
from .interbuffer import InterBuffer
from .schema import GCDIATask, Query
from .storage import Database, Table
from . import traversal

# moved to repro_torch.core.join; alias kept for existing importers
_match_by_joins = join_mod.match_by_joins


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The engine's device: the CUDA card unless the caller names another.
    Without a card and without an explicit device this raises — the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("GredoEngine runs on a CUDA device and none "
                               "is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass
class ExecStats:
    plan_notes: list
    seconds: float
    record_fetches: int
    cpu_ops: int
    interbuffer_hit: bool = False
    # per-operator rows/bytes/seconds of the executed physical DAG
    # (pre-order; see physical.collect_stats)
    operators: list = dataclasses.field(default_factory=list)
    # optimizer rewrite log (join reordering, semi-join siding, CSE, ...)
    rewrites: list = dataclasses.field(default_factory=list)
    # inter-buffer reuse below the root: # of DAG nodes satisfied from cache
    nodes_reused: int = 0
    # write-path observability: pending-delta state of the matched graph
    # (segments / delta_edges / delta_vertices / tombstones) + lifetime
    # compaction counters (see repro_torch.core.deltastore)
    delta: dict = dataclasses.field(default_factory=dict)
    compactions: int = 0


@dataclasses.dataclass
class Profile:
    """What ``GredoEngine.profile`` returns: the query result plus every
    telemetry view of that one execution."""

    result: object
    trace: Optional["telemetry_mod.QueryTrace"]
    registry_delta: dict                # per-query metric deltas
    qerrors: list                       # flagged MisEstimates of this plan
    seconds: float

    def render(self, top: int = 0) -> str:
        lines = [self.trace.render(top=top) if self.trace is not None else ""]
        if self.qerrors:
            lines.append("== q-error flags ==")
            lines += [f"  {m!r}" for m in self.qerrors]
        return "\n".join(l for l in lines if l)


class GredoEngine:
    def __init__(self, db: Database, mode: str = "gredo",
                 interbuffer_bytes: int = 2 << 30,
                 enable_optimizer: bool = True,
                 admit_cost_per_byte: float = 0.05,
                 join_enum: str = "dp",
                 telemetry: "bool | telemetry_mod.Telemetry | None" = None,
                 n_shards: int = 1,
                 debug: bool = False,
                 observe: "bool | observe_mod.FlightRecorder" = True,
                 device: "torch.device | str | None" = None):
        assert mode in ("gredo", "dual", "single")
        assert join_enum in ("dp", "dp-leftdeep", "greedy")
        self.db = db
        self.device = resolve_device(device)
        self.mode = mode
        # debug mode: statically verify every plan (naive, post-optimizer,
        # post-shard-rewrite) before execution and raise
        # PlanVerificationError on ERROR-severity violations; explain output
        # grows `verify:` lines. See repro_torch.core.verify for the rule catalog.
        self.debug = debug
        self.last_verify: Optional[verify_mod.VerifyReport] = None
        # morsel-parallel sharded execution (repro_torch.core.shard). n_shards is
        # the *requested* shard count; the §6.3 sharded cost model may still
        # choose serial execution per query (small dominant inputs) — the
        # actual per-query choice lands in ``last_shard_count``.
        self.n_shards = max(int(n_shards), 1)
        self._shard_runtime = None
        self.last_shard_count = 1
        self.enable_optimizer = enable_optimizer
        self.join_enum = join_enum
        self.interbuffer = InterBuffer(interbuffer_bytes,
                                       admit_cost_per_byte=admit_cost_per_byte,
                                       device=self.device)
        # §6.3 estimate memo shared across this engine's planner invocations;
        # keyed on the catalog write-epoch snapshot inside optimize(), so a
        # delta-store append invalidates every cached cardinality (and the
        # plan decisions that would have been built on them)
        self._opt_cache: dict = {}
        self.last_stats: Optional[ExecStats] = None
        self.last_dag: Optional[physical.PhysicalOp] = None
        self.last_naive_dag: Optional[physical.PhysicalOp] = None
        self._last_ests: Optional[dict] = None
        self.last_report: Optional[optimizer_mod.OptReport] = None
        # flight recorder (repro_torch.core.observe): always-on bounded ring of
        # recent query records with trigger-driven auto-dump; pass a shared
        # FlightRecorder to pool SLO state across engines, or observe=False
        # to opt out entirely. Built before telemetry so enable_telemetry
        # can register it as the `flight` registry source.
        self.observer: Optional[observe_mod.FlightRecorder] = None
        if observe:
            self.observer = (observe
                             if isinstance(observe, observe_mod.FlightRecorder)
                             else observe_mod.FlightRecorder())
        self._recorder: Optional[observe_mod.WorkloadRecorder] = None
        self._last_label = ""
        # telemetry (off by default — the hot path then only pays
        # `trace is None` checks). `telemetry=True` builds a fresh session;
        # passing a Telemetry instance shares a registry across engines.
        self.telemetry: Optional[telemetry_mod.Telemetry] = None
        if telemetry:
            self.enable_telemetry(telemetry if not isinstance(telemetry, bool)
                                  else None)
        # per-query inter-buffer counter delta (cheap: 6 ints), kept even
        # with telemetry off so explain_last never shows cumulative drift
        self.last_interbuffer_delta: dict = {}
        self.last_registry_delta: dict = {}
        self._pre_snapshot: dict = {}

    # ------------------------------------------------------------- telemetry
    def _metric_sources(self) -> dict:
        """The subsystem pull-sources this engine exposes, namespace -> fn.
        ``enable_telemetry`` registers them on the session registry;
        ``metrics_snapshot`` reads them directly when telemetry is off."""
        db = self.db

        def _graph_writes() -> dict:
            out: dict[str, float] = {}
            for name, g in db.graphs.items():
                for k, v in g.write_counters.metrics().items():
                    out[f"{name}.{k}"] = v
            return out

        def _index_counters() -> dict:
            im = getattr(db, "_index_manager", None)
            return im.metrics() if im is not None else {}

        def _shard_metrics() -> dict:
            rt = self._shard_runtime
            return rt.metrics() if rt is not None else {}

        from . import pattern_jit
        sources = {"interbuffer": self.interbuffer.metrics,
                   "deltastore": _graph_writes,
                   "index": _index_counters,
                   "traversal_kernels": pattern_jit.metrics,
                   "shard": _shard_metrics}
        if self.observer is not None:
            sources["flight"] = self.observer.metrics
        return sources

    def enable_telemetry(self, session: Optional["telemetry_mod.Telemetry"]
                         = None) -> "telemetry_mod.Telemetry":
        """Attach (or build) a telemetry session and register this engine's
        subsystems as registry sources: inter-buffer admission, per-graph
        delta-store write counters, secondary-index maintenance, traversal
        kernels, shard runtime, and the flight recorder."""
        tel = session if session is not None else telemetry_mod.Telemetry()
        for ns, fn in self._metric_sources().items():
            tel.registry.register_source(ns, fn)
        self.telemetry = tel
        return tel

    def metrics_snapshot(self) -> dict:
        """Flat ``ns.key -> number`` view of every subsystem metric. With a
        telemetry session attached this is the registry snapshot (includes
        engine counters/histograms and q-error figures); without one it
        reads the subsystem sources directly — health checks work either
        way."""
        if self.telemetry is not None:
            return self.telemetry.registry.snapshot()
        out: dict[str, float] = {}
        for ns, fn in self._metric_sources().items():
            for k, v in fn().items():
                out[f"{ns}.{k}"] = v
        return out

    def health(self) -> "observe_mod.HealthReport":
        """Evaluate the observability rule table (repro_torch.core.observe) over
        the current metrics snapshot and the flight recorder's latency
        EWMAs. With telemetry attached, the verdicts are also exported as
        ``health.*`` gauges (0=ok 1=warn 2=critical) so OpenMetrics scrapes
        carry them."""
        report = observe_mod.evaluate_health(self.metrics_snapshot(),
                                             self.observer)
        if self.telemetry is not None:
            for k, v in report.as_metrics().items():
                self.telemetry.registry.gauge(k).set(v)
        return report

    def record(self, path: str) -> "observe_mod.WorkloadRecorder":
        """Capture this engine's interleaved query/mutation stream to JSONL
        for deterministic offline replay::

            with eng.record("experiments/workload.jsonl"):
                eng.query(q); g.insert_edges(rows); eng.analyze(task)
            observe.replay(fresh_db, "experiments/workload.jsonl")
        """
        return observe_mod.WorkloadRecorder(self, path)

    def profile(self, q: "Query | GCDIATask", **kw) -> Profile:
        """Run one GCDI query / GCDIA task with tracing on (temporarily
        enabling telemetry if the engine has none) and return the result
        together with its trace, per-query metric deltas, and q-error
        flags."""
        transient = self.telemetry is None
        tel = self.telemetry or self.enable_telemetry()
        try:
            result = (self.analyze(q, **kw) if isinstance(q, GCDIATask)
                      else self.query(q, **kw))
            return Profile(result=result, trace=tel.collector.last(),
                           registry_delta=dict(self.last_registry_delta),
                           qerrors=list(tel.qerror.last_plan),
                           seconds=self.last_stats.seconds)
        finally:
            if transient:
                self.telemetry = None

    @property
    def last_ests(self) -> Optional[dict]:
        """§6.3 estimates of the most recent DAG, computed lazily — GCDI
        queries don't pay the estimate walk unless explain_last (or a
        caller) actually reads it. analyze() fills it eagerly because the
        inter-buffer admission consumes the estimates during execution."""
        if self._last_ests is None and self.last_dag is not None:
            self._last_ests = physical.estimate(self.last_dag, self.db)
        return self._last_ests

    # ------------------------------------------------------------------ GCDI
    def plan(self, q: Query) -> planner.GCDIPlan:
        enable_opt = self.mode == "gredo"
        return planner.plan(self.db, q, enable_opt=enable_opt,
                            enable_pattern_pushdown=enable_opt)

    def physical_plan(self, q: Query) -> physical.PhysicalOp:
        """Lower a GCDI task to its *naive* physical DAG (pre-rewrite)."""
        return physical.build_gcdi(self.db, self.plan(q), mode=self.mode)

    def optimized_plan(self, q: Query) -> physical.PhysicalOp:
        """The DAG the engine actually executes (post-rewrite in gredo
        mode; identical to ``physical_plan`` otherwise). Updates the whole
        ``last_*`` family consistently, so a following ``explain_last``
        describes this plan (unexecuted: estimates only, no actuals)."""
        naive = self.physical_plan(q)
        dag, report = self._lower(naive)
        self.last_dag = dag
        self.last_naive_dag = naive
        self.last_report = report
        self._last_ests = None
        return dag

    def _lower(self, dag: physical.PhysicalOp):
        """Apply the cost-based optimizer in full-system mode. The ablation
        variants (-D / -S) run the naive DAG, as in the paper."""
        if self.mode == "gredo" and self.enable_optimizer:
            return optimizer_mod.optimize(dag, self.db, cache=self._opt_cache,
                                          join_enum=self.join_enum)
        return dag, None

    # ---------------------------------------------------- static verification
    def _verify_stages(self, naive: physical.PhysicalOp,
                       optimized: Optional[physical.PhysicalOp],
                       sharded: Optional[physical.PhysicalOp]
                       ) -> verify_mod.VerifyReport:
        """Run the static plan verifier over every rewrite stage of one
        plan: each stage's DAG is schema-checked against the live catalog,
        signatures are checked for coherence *across* stages (V-SIG: the
        inter-buffer spans them), and each rewrite boundary is checked for
        type equivalence (V-EQ: rewrites may reorder, never retype)."""
        report = verify_mod.VerifyReport()
        sigs: dict = {}
        verify_mod.verify_plan(naive, self.db, report, sigs)
        prev, prev_label = naive, "naive"
        for dag, label in ((optimized, "optimizer"), (sharded, "shard")):
            if dag is None or dag is prev:
                continue
            verify_mod.verify_plan(dag, self.db, report, sigs)
            verify_mod.verify_equivalence(prev, dag, self.db,
                                          f"{prev_label}->{label}", report)
            prev, prev_label = dag, label
        self.last_verify = report
        return report

    def verify(self, q: "Query | GCDIATask") -> verify_mod.VerifyReport:
        """Statically verify the plan this engine would run for ``q`` —
        naive build, optimizer rewrite, and shard rewrite — without
        executing anything. Returns the report (``report.ok`` means no
        ERROR-severity violations; WARNs flag silent promotions and runtime
        fallbacks)."""
        if isinstance(q, GCDIATask):
            p = self.plan(q.integration)
            naive = physical.build_gcdia(self.db, p, q, mode=self.mode)
        else:
            naive = self.physical_plan(q)
        dag, _ = self._lower(naive)
        sharded = None
        if self.n_shards > 1:
            from . import shard as shard_mod
            sharded, k = shard_mod.prepare_plan(dag, self.db, self.n_shards)
            if k <= 1:
                sharded = None
        return self._verify_stages(naive, dag, sharded)

    def _debug_verify(self, naive, dag, final) -> None:
        if not self.debug:
            return
        report = self._verify_stages(naive, dag if dag is not naive else None,
                                     final if final is not dag else None)
        if not report.ok:
            if self.observer is not None:
                # capture the failing plan + report before the exception
                # unwinds (the query never reaches _finish_query)
                self.observer.record_verify_error(self, self._last_label,
                                                  naive, report)
            raise verify_mod.PlanVerificationError(report)

    def _shard_plan(self, dag: physical.PhysicalOp
                    ) -> tuple[physical.PhysicalOp, Optional[object]]:
        """Rewrite the post-optimizer DAG for morsel-parallel execution when
        ``n_shards > 1`` *and* the sharded cost model picks k > 1 for this
        query's dominant input. Returns ``(dag, shard_runtime-or-None)``."""
        self.last_shard_count = 1
        if self.n_shards <= 1:
            return dag, None
        from . import shard as shard_mod
        dag2, k = shard_mod.prepare_plan(dag, self.db, self.n_shards)
        self.last_shard_count = k
        if k <= 1:
            return dag, None
        if self._shard_runtime is None:
            self._shard_runtime = shard_mod.ShardRuntime(self.n_shards)
        return dag2, self._shard_runtime

    def query(self, q: Query) -> Table:
        traversal.COUNTERS.reset()
        trace, ib0 = self._begin_query(f"query[{','.join(q.source_names())}]")
        t0 = time.perf_counter()
        p = self.plan(q)
        naive = physical.build_gcdi(self.db, p, mode=self.mode)
        dag, report = self._lower(naive)
        opt_dag = dag
        dag, shard_rt = self._shard_plan(dag)
        self._debug_verify(naive, opt_dag, dag)
        ctx = physical.ExecContext(self.db, trace=trace,
                                   fence_device=self._fence_device(),
                                   shard=shard_rt, device=self.device)
        result = physical.execute(dag, ctx)
        notes = list(p.notes)
        if self.mode == "single" and q.match is not None:
            notes.insert(0, "single-engine: match via edge-table equi-joins")
        if self.last_shard_count > 1:
            notes.append(f"sharded execution: k={self.last_shard_count}")
        self.last_dag = dag
        self.last_naive_dag = naive
        self.last_report = report
        self._last_ests = None
        self.last_stats = ExecStats(
            plan_notes=notes, seconds=time.perf_counter() - t0,
            record_fetches=traversal.COUNTERS.record_fetches,
            cpu_ops=traversal.COUNTERS.cpu_ops,
            operators=physical.collect_stats(dag),
            rewrites=report.notes() if report else [])
        self._attach_delta_stats(q)
        self._finish_query(trace, ctx, ib0)
        if self._recorder is not None:
            self._recorder.log_query(q, result, self.last_stats.seconds)
        return result

    def explain(self, q: Query) -> str:
        """Pre- and post-rewrite operator DAGs with §6.3 estimates per
        operator (run the query and use ``explain_last`` for est_rows next
        to actual rows)."""
        naive = self.physical_plan(q)
        dag, report = self._lower(naive)
        if report is None:
            lines = [physical.explain(naive, db=self.db)]
        else:
            lines = ["== naive DAG (pre-rewrite) ==",
                     physical.explain(naive, db=self.db),
                     "== optimized DAG (post-rewrite) ==",
                     physical.explain(dag, db=self.db),
                     "== rewrites =="]
            lines += ["  " + n for n in report.notes()]
        if self.debug:
            vr = self._verify_stages(naive, dag if dag is not naive else None,
                                     None)
            lines.append("== verify ==")
            lines += (["  " + l for l in vr.render()]
                      or ["  verify: plan ok (no violations)"])
        return "\n".join(lines)

    def explain_last(self, top: int = 0) -> str:
        """Pre/post-rewrite plans of the most recent execution, the executed
        DAG annotated with actual rows/bytes/seconds, the operator's share
        of total plan time, *and* the cost-model est_rows/est_cost per
        operator, plus inter-buffer counters (this query's delta, then the
        engine-lifetime cumulative figures). ``top > 0`` appends the k
        hottest operators sorted by wall seconds."""
        if self.last_dag is None:
            return "(nothing executed yet)"
        lines = []
        if self.last_naive_dag is not None and self.last_report is not None:
            lines += ["== naive DAG (pre-rewrite) ==",
                      physical.explain(self.last_naive_dag, db=self.db),
                      "== executed DAG (post-rewrite, actual vs. estimated) =="]
        lines.append(physical.explain(self.last_dag, stats=True,
                                      ests=self.last_ests, top=top))
        if self.last_report is not None:
            lines.append("== rewrites ==")
            lines += ["  " + n for n in self.last_report.notes()]
        if self.debug and self.last_verify is not None:
            lines.append("== verify ==")
            lines += (["  " + l for l in self.last_verify.render()]
                      or ["  verify: plan ok (no violations)"])
        if self.last_interbuffer_delta:
            d = self.last_interbuffer_delta
            lines.append("interbuffer (this query): "
                         + " ".join(f"{k}={d[k]:+g}" for k in
                                    ("hits", "misses", "bypasses", "evictions")
                                    if k in d))
        lines.append(f"interbuffer: {self.interbuffer.counters()} (cumulative)")
        tk = {k.split(".", 1)[1]: v
              for k, v in self.last_registry_delta.items()
              if k.startswith("traversal_kernels.") and v}
        if tk:
            lines.append("traversal kernels (this query): "
                         + " ".join(f"{k}={v:+g}"
                                    for k, v in sorted(tk.items())))
        if self.last_shard_count > 1:
            sm = {k.split(".", 1)[1]: v
                  for k, v in self.last_registry_delta.items()
                  if k.startswith("shard.") and v}
            lines.append(f"sharded execution: k={self.last_shard_count}"
                         + ("".join(f" {k}={v:+g}"
                                    for k, v in sorted(sm.items()))))
        if self.telemetry is not None and self.telemetry.qerror.last_plan:
            lines.append("== q-error flags ==")
            lines += [f"  {m!r}" for m in self.telemetry.qerror.last_plan]
        if self.observer is not None:
            lines.append("== health ==")
            lines += ["  " + l for l in self.health().render()]
        return "\n".join(lines)

    def _attach_delta_stats(self, q: Query) -> None:
        if q.match is not None and self.last_stats is not None:
            g = self.db.graphs[q.match.graph]
            self.last_stats.delta = g.delta.stats()
            self.last_stats.compactions = g.compactions

    # ---------------------------------------------------- telemetry plumbing
    def _fence_device(self) -> bool:
        return self.telemetry is not None and self.telemetry.fence_device

    def _begin_query(self, label: str):
        """Open the per-query observability window: an inter-buffer counter
        snapshot (always — 6 ints), the flight recorder's pre-query marks,
        and with telemetry on, a registry snapshot plus a fresh trace."""
        ib0 = self.interbuffer.metrics()
        self._last_label = label
        if self.observer is not None:
            self.observer.begin(label)
        tel = self.telemetry
        if tel is None:
            return None, ib0
        self._pre_snapshot = tel.registry.snapshot()
        tel.qerror.start_plan()
        return tel.collector.start_query(label), ib0

    def _finish_query(self, trace, ctx: physical.ExecContext,
                      ib0: dict, kind: str = "query") -> None:
        self.last_interbuffer_delta = telemetry_mod.Registry.delta(
            ib0, self.interbuffer.metrics())
        tel = self.telemetry
        if tel is None:
            # flight-recorder capture happens even without telemetry — the
            # record then carries plan fingerprint + operator stats +
            # inter-buffer delta (no span tree / registry delta).
            if self.observer is not None:
                self.observer.observe(self, kind=kind)
            return
        seconds = self.last_stats.seconds
        if trace is not None:
            trace.close(seconds=seconds, nodes_run=ctx.nodes_run,
                        nodes_reused=ctx.nodes_reused)
            tel.collector.trim()    # re-check the span bound now that this
                                    # query's spans are all recorded
        reg = tel.registry
        reg.counter("engine.queries").inc()
        reg.histogram("engine.query_seconds").observe(seconds)
        label = trace.label if trace is not None else "query"
        if self.last_report is not None:
            for rule, n in self.last_report.rule_counts().items():
                reg.counter(f"optimizer.rewrites.{rule}").inc(n)
        ests = self.last_ests or {}
        seen: set[int] = set()

        def walk(n: physical.PhysicalOp) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            acc = getattr(n, "access", None)
            if acc is not None and (n.stats.executed or n.stats.cached):
                reg.counter(f"optimizer.access.{acc}").inc()
            est = ests.get(id(n))
            if n.stats.executed and est is not None and n.stats.rows is not None:
                tel.qerror.record(label, n.kind, n.describe(),
                                  est[0], n.stats.rows)
            for c in n.children:
                walk(c)

        walk(self.last_dag)
        self.last_registry_delta = telemetry_mod.Registry.delta(
            self._pre_snapshot, reg.snapshot())
        if self.observer is not None:
            self.observer.observe(self, kind=kind)

    # ------------------------------------------------------------------ GCDA
    def analyze(self, task: GCDIATask, *, use_kernel: bool | None = None,
                iters: int = 100):
        """Run a full GCDIA: GCDI -> G (matrix gen) -> A (parallel op), as
        one physical DAG. Cacheable operators (the GCDI relation, generated
        matrices, analytics outputs) are keyed in the inter-buffer by node
        signature; signatures embed source write epochs, so reuse survives
        exactly until a source collection mutates."""
        traversal.COUNTERS.reset()
        trace, ib0 = self._begin_query(f"gcdia:{task.analytics.op}")
        t0 = time.perf_counter()
        p = self.plan(task.integration)
        naive = physical.build_gcdia(self.db, p, task, mode=self.mode,
                                     use_kernel=use_kernel, iters=iters)
        dag, report = self._lower(naive)
        opt_dag = dag
        dag, shard_rt = self._shard_plan(dag)
        self._debug_verify(naive, opt_dag, dag)
        ests = physical.estimate(dag, self.db)
        ctx = physical.ExecContext(self.db, interbuffer=self.interbuffer,
                                   ests=ests, trace=trace,
                                   fence_device=self._fence_device(),
                                   shard=shard_rt, device=self.device)
        out = physical.execute(dag, ctx)
        self.last_dag = dag
        self.last_naive_dag = naive
        self.last_report = report
        self._last_ests = ests
        notes = list(p.notes)
        if self.last_shard_count > 1:
            notes.append(f"sharded execution: k={self.last_shard_count}")
        self.last_stats = ExecStats(
            plan_notes=notes, seconds=time.perf_counter() - t0,
            record_fetches=traversal.COUNTERS.record_fetches,
            cpu_ops=traversal.COUNTERS.cpu_ops,
            interbuffer_hit=dag.stats.cached,
            operators=physical.collect_stats(dag),
            rewrites=report.notes() if report else [],
            nodes_reused=ctx.nodes_reused)
        self._attach_delta_stats(task.integration)
        self._finish_query(trace, ctx, ib0, kind="analyze")
        if self._recorder is not None:
            self._recorder.log_analyze(task, out, iters=iters,
                                       use_kernel=use_kernel,
                                       seconds=self.last_stats.seconds)
        return out

    # ------------------------------------------------------- graph utilities
    def shortest_path(self, graph: str, src_label: str, src_vids, dst_label: str,
                      dst_vids) -> np.ndarray:
        g = self.db.graphs[graph]
        return pattern_mod.shortest_path_lengths(
            g, g.nid_of(src_label, src_vids), g.nid_of(dst_label, dst_vids))
