"""Twin of ``tests/test_telemetry.py``: the port's telemetry nests spans like
the DAG, exports valid Chrome traces, keeps the same registry snapshot and
delta semantics, per-graph write counters, q-error records and OpenMetrics
text as the JAX package's on the same scenarios, and its disabled path
costs no more than the executor without tracing."""
import json
import time

import numpy as np
import pytest
from torch_twin import PKGS, PORT, both, fresh_matcher_counters, untimed


@pytest.fixture(autouse=True)
def _fresh_matcher_counters(monkeypatch):
    fresh_matcher_counters(monkeypatch)


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


def _expected_shape(node, memo):
    sig = node.signature()
    if sig in memo:
        return (node.kind, [])
    memo.add(sig)
    return (node.kind, [_expected_shape(c, memo) for c in node.children])


def _operator_spans(trace) -> list:
    """A trace's spans less the port's engine phases, which the reference
    does not record."""
    return [s for s in trace.spans if not getattr(s, "phase", False)]


@pytest.mark.parametrize("mode", ["gredo", "dual", "single"])
def test_span_tree_matches_dag_shape(dbs, mode):
    def scenario(P):
        eng = P.Engine(dbs[P.name], mode=mode, telemetry=True)
        eng.query(P.m2bench.q_g1())
        trace = eng.telemetry.last_trace()
        assert trace.shape() == [_expected_shape(eng.last_dag, set())]
        return trace.shape(), [(s.name, s.cat) for s in _operator_spans(trace)]
    ref, port = both(scenario)
    assert port == ref


def test_interbuffer_hit_pseudo_span(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.analyze(P.m2bench.a3_multiply())
        eng.analyze(P.m2bench.a3_multiply())
        trace = eng.telemetry.last_trace()
        hits = [s.name for s in trace.spans
                if s.args.get("cache") == "interbuffer-hit"]
        return hits, eng.last_dag.kind, eng.last_stats.interbuffer_hit
    ref, port = both(scenario)
    assert port == ref
    hits, root, hit = port
    assert hits and hits[0] == root and hit


def test_chrome_trace_round_trips_and_nests(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.analyze(P.m2bench.a3_multiply())
        eng.query(P.m2bench.q_g1())
        doc = json.loads(eng.telemetry.collector.to_chrome_json())
        assert P.telemetry.validate_chrome_trace(doc) == []
        events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        for tid in {e["tid"] for e in events}:
            evs = [e for e in events if e["tid"] == tid]
            ts = [e["ts"] for e in evs]
            assert ts == sorted(ts)
            root = evs[0]
            for e in evs[1:]:
                assert e["ts"] >= root["ts"] - 1e-6
                assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 0.5
        # the port's engine phases lie inside the root too; the reference
        # records none
        return [(e["name"], e["tid"], e.get("cat")) for e in events
                if not e["name"].startswith("engine.")]
    ref, port = both(scenario)
    assert port == ref and port


def test_validator_rejects_malformed_traces():
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                            "ts": -5, "dur": 2}]}
    overlap = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0, "dur": 10},
        {"name": "b", "ph": "X", "pid": 1, "tid": 0, "ts": 5, "dur": 10}]}
    ref, port = both(lambda P: [P.telemetry.validate_chrome_trace(d)
                                for d in ({}, bad, overlap)])
    assert port == ref
    assert port[0] == ["missing traceEvents"] and port[1]
    assert any("nesting" in p for p in port[2])


def test_histogram_percentiles():
    def scenario(P):
        h = P.telemetry.Histogram("t")
        for v in np.linspace(1e-4, 1e-1, 1000):
            h.observe(float(v))
        return (h.count, h.p50, h.p95, h.p99, h.max,
                np.isnan(P.telemetry.Histogram("e").p99))
    ref, port = both(scenario)
    assert port == ref
    count, p50, p95, p99, mx, empty_nan = port
    assert count == 1000 and p50 == pytest.approx(5e-2, rel=0.5)
    assert p50 <= p95 <= p99 <= mx and empty_nan


def test_registry_snapshot_delta_across_write_burst(dbs):
    def scenario(P):
        db = dbs[P.name]
        eng = P.Engine(db, telemetry=True)
        reg = eng.telemetry.registry
        g = db.graphs["Interested_in"]
        before = reg.snapshot()
        n0 = g.vertex_tables["Tags"].nrows
        for i in range(3):
            g.insert_vertices("Tags", {"tid": np.array([90000 + i]),
                                       "content": np.array([f"t{i}"]),
                                       "popularity": np.array([0.0])})
        delta = P.telemetry.Registry.delta(before, reg.snapshot())
        assert g.vertex_tables["Tags"].nrows == n0 + 3
        return {k: v for k, v in delta.items() if k.startswith("deltastore.")}
    ref, port = both(scenario)
    assert port == ref
    assert port["deltastore.Interested_in.write_batches"] == 3
    assert port["deltastore.Interested_in.write_rows"] == 3
    assert port.get("deltastore.Follows.write_batches", 0) == 0


def test_write_counters_per_graph(dbs):
    def scenario(P):
        db = dbs[P.name]
        g1 = db.graphs["Follows"]
        assert not hasattr(P.deltastore, "WRITE_COUNTERS")
        b0 = g1.write_counters.write_batches
        g1.insert_edges({"svid": np.array([0]), "tvid": np.array([1]),
                         "since": np.array([2020])})
        snap = P.Engine(db, telemetry=True).telemetry.registry.snapshot()
        return b0, g1.write_counters.write_batches, \
            snap["deltastore.Follows.write_batches"]
    ref, port = both(scenario)
    assert port == ref
    b0, b1, snap = port
    assert b1 == snap == b0 + 1


def test_per_query_interbuffer_delta(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.analyze(P.m2bench.a3_multiply())
        eng.analyze(P.m2bench.a3_multiply())
        return dict(eng.last_interbuffer_delta), eng.interbuffer.misses, \
            untimed(eng.explain_last())
    ref, port = both(scenario)
    assert port == ref
    delta, misses, out = port
    assert delta["hits"] == 1 and delta["misses"] == 0 and misses > 0
    assert "interbuffer (this query)" in out and "(cumulative)" in out


def test_oversize_outputs_show_in_explain_and_registry(dbs):
    """An inter-buffer smaller than one output matrix: each analysis admits
    its outputs and evicts them at once; ``explain_last`` and the registry
    delta count the oversize puts."""
    P = PORT
    eng = P.Engine(dbs[P.name], telemetry=True, interbuffer_bytes=1024)
    eng.analyze(P.m2bench.a3_multiply())
    eng.analyze(P.m2bench.a3_multiply())
    assert eng.last_registry_delta["interbuffer.oversize"] >= 1
    assert eng.last_interbuffer_delta["hits"] == 0
    assert eng.last_interbuffer_delta["oversize"] >= 1
    out = eng.explain_last()
    assert "oversize=+" in out and f"oversize={eng.interbuffer.oversize}" in out
    assert len(eng.interbuffer) == 0


def test_qerror_monitor_flags_misestimate():
    def scenario(P):
        mon = P.telemetry.QErrorMonitor(threshold=4.0, max_log=8)
        mon.start_plan()
        out = [mon.record("q", "Scan", "Scan[ok]", 100, 110),
               mon.record("q", "Join", "Join[bad]", 1000, 10),
               [r.op for r in mon.last_plan], mon.worst(1)[0].q_error,
               mon.record("q", "Sel", "Sel[empty]", 0, 0)]
        for i in range(20):
            mon.record("q", "Op", f"Op[{i}]", 10 ** (i % 5 + 1), 1)
        return out + [len(mon.log), mon.worst(1)[0].q_error,
                      [(r.op, r.detail, r.q_error) for r in mon.log]]
    ref, port = both(scenario)
    assert port == ref
    assert port[0] < 4.0 and port[1] == 100.0 and port[2] == ["Join"]
    assert port[3] == 100.0 and port[4] == 1.0
    assert port[5] <= 8 and port[6] == 100000.0


def test_engine_records_qerrors_per_plan(dbs):
    def scenario(P):
        tel = P.telemetry.Telemetry(qerror_threshold=1.000001)
        eng = P.Engine(dbs[P.name], telemetry=tel)
        eng.query(P.m2bench.q_g4())
        return (tel.qerror.observations,
                [(r.op, r.detail, r.est_rows, r.actual_rows, r.q_error)
                 for r in tel.qerror.last_plan],
                "q-error flags" in eng.explain_last(),
                eng.last_registry_delta.get("qerror.observations", 0))
    ref, port = both(scenario)
    assert port == ref
    obs, flagged, in_explain, delta = port
    assert obs > 0 and flagged and in_explain and delta > 0


def test_explain_last_shows_seconds_and_pct(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.query(P.m2bench.q_g1())
        out = eng.explain_last(top=3)
        assert "ms=" in out and "pct=" in out
        assert "top 3 operators by time" in out
        lines = untimed(out).splitlines()
        i = lines.index("== top 3 operators by time ==")
        j = next(k for k in range(i + 1, len(lines))
                 if lines[k].startswith("=="))
        # the top-k ranking follows wall-clock time; its size does not
        return lines[:i] + lines[j:], j - i - 1
    ref, port = both(scenario)
    assert port == ref
    assert port[1] == 3


def test_profile_returns_trace_without_permanent_telemetry(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        assert eng.telemetry is None
        prof = eng.profile(P.m2bench.q_g1())
        assert eng.telemetry is None
        assert prof.trace is not None and prof.trace.total_seconds() > 0
        assert "total_ms=" in prof.render(top=2)
        return (P.fingerprint(prof.result),
                prof.registry_delta.get("engine.queries"),
                prof.trace.shape())
    ref, port = both(scenario)
    assert port == ref
    assert port[1] == 1


def _execute_pre_telemetry(P, node, ctx):
    """Frozen copy of ``physical.execute`` as it was before span tracing —
    the honest baseline for the overhead bound (the reference's copy, on
    the port's modules)."""
    ph, ib = P.physical, P.interbuffer
    sig = node.signature()
    if sig in ctx.memo:
        node.stats.memoized = True
        return ctx.memo[sig]
    if ctx.interbuffer is not None and node.cacheable:
        hit = ctx.interbuffer.get(ib.fingerprint(sig))
        if hit is not None:
            node.stats.cached = True
            node.stats.rows = ph._result_rows(hit)
            node.stats.nbytes = ib.value_nbytes(hit)
            ctx.nodes_reused += 1
            ctx.memo[sig] = hit
            return hit
    inputs = [_execute_pre_telemetry(P, c, ctx) for c in node.children]
    t0 = time.perf_counter()
    out = node.run(ctx, *inputs)
    node.stats.seconds += time.perf_counter() - t0
    node.stats.executed = True
    node.stats.rows = ph._result_rows(out)
    if ctx.interbuffer is not None or ph.TRACK_NBYTES:
        node.stats.nbytes = ib.value_nbytes(out)
    ctx.nodes_run += 1
    if ctx.interbuffer is not None and node.cacheable:
        est = ctx.ests.get(id(node)) if ctx.ests is not None else None
        out = ctx.interbuffer.put(ib.fingerprint(sig), out,
                                  est_cost=None if est is None else est[1])
    ctx.memo[sig] = out
    return out


def test_disabled_telemetry_overhead_bounded(dbs):
    """The port's executor with ``trace=None`` against the frozen
    pre-telemetry executor on the same DAG: paired min-of-N, the
    reference's bound."""
    P, db = PORT, dbs[PORT.name]
    dag = P.Engine(db).optimized_plan(P.m2bench.q_g1())
    base_out = _execute_pre_telemetry(P, dag, P.ExecContext(db))
    assert P.fingerprint(base_out) == P.fingerprint(
        P.physical.execute(dag, P.ExecContext(db)))
    for _ in range(3):
        _execute_pre_telemetry(P, dag, P.ExecContext(db))
        P.physical.execute(dag, P.ExecContext(db))
    base, new = [], []
    for _ in range(15):
        t0 = time.perf_counter()
        _execute_pre_telemetry(P, dag, P.ExecContext(db))
        base.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        P.physical.execute(dag, P.ExecContext(db))
        new.append(time.perf_counter() - t0)
    assert min(new) <= min(base) * 1.25


def test_trace_collector_bounded():
    def scenario(P):
        coll = P.telemetry.TraceCollector(max_spans=10)
        for i in range(8):
            qt = coll.start_query(f"q{i}")
            for _ in range(3):
                qt.end(qt.begin("Op"))
            qt.close()
            coll.trim()
        return ([len(t.spans) for t in coll.traces], coll.dropped_spans,
                coll.last().label)
    ref, port = both(scenario)
    assert port == ref
    spans, dropped, last = port
    assert (sum(spans) <= 10 or len(spans) == 1) and dropped > 0
    assert last == "q7"


def test_empty_histogram_summary_is_finite():
    ref, port = both(lambda P: P.telemetry.Histogram("e").summary())
    assert port == ref == {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0,
                           "p99": 0.0}
    json.dumps(port)


def test_registry_to_openmetrics_exposition():
    def scenario(P):
        reg = P.telemetry.Registry()
        reg.counter("engine.queries").inc(3)
        reg.gauge("pool.bytes").set(1.5)
        h = reg.histogram("engine.query_seconds")
        h.observe(0.002)
        h.observe(5.0)
        reg.register_source("ib", lambda: {"hits": 7, "rate": 0.25})
        return reg.to_openmetrics()
    ref, port = both(scenario)
    assert port == ref
    lines = port.splitlines()
    assert "engine_queries_total 3" in lines and "pool_bytes 1.5" in lines
    assert 'engine_query_seconds_bucket{le="+Inf"} 2' in lines
    assert "ib_hits 7" in lines and lines[-1] == "# EOF"
    for line in lines:
        if not line.startswith("#"):
            name = line.split(" ")[0].split("{")[0]
            assert PORT.telemetry.Registry._om_name(name) == name


def test_engine_openmetrics_end_to_end(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.query(P.m2bench.q_g1())
        eng.health()
        text = eng.telemetry.registry.to_openmetrics()
        return [line for line in untimed(text).splitlines()
                if not line.startswith("#") and "seconds" not in line
                and "_s " not in line and "wall" not in line]
    ref, port = both(scenario)
    assert port == ref
    assert "engine_queries_total 1" in port and "flight_records 1" in port
    assert any(line.startswith("health_status") for line in port)


# --------------------------------------------------------------------------
# The port's engine phase spans
# --------------------------------------------------------------------------

GCDI_PHASES = ["engine.telemetry", "engine.record", "engine.plan",
               "engine.build", "engine.optimize", "engine.shard",
               "engine.execute", "engine.record", "engine.telemetry",
               "engine.record"]
GCDA_PHASES = GCDI_PHASES[:6] + ["engine.estimate"] + GCDI_PHASES[6:]


def _phases(trace):
    return [s for s in trace.spans if s.phase]


@pytest.mark.parametrize("task,cat,names", [
    ("q_g3", "gcdi", GCDI_PHASES), ("a3_multiply", "gcda", GCDA_PHASES)])
def test_phase_spans_tile_the_task(dbs, task, cat, names):
    """In order, disjoint, inside the root; the operator spans lie inside
    ``engine.execute``."""
    P = PORT
    eng = P.Engine(dbs[P.name], telemetry=True)
    (eng.query if cat == "gcdi" else eng.analyze)(getattr(P.m2bench, task)())
    trace = eng.telemetry.last_trace()
    phases = _phases(trace)
    assert [s.name for s in phases] == names
    assert all(s.cat == cat and s.parent == 0 for s in phases)
    root = trace.spans[0]
    assert phases[0].ts >= root.ts
    assert phases[-1].ts + phases[-1].dur == root.ts + root.dur
    for a, b in zip(phases, phases[1:]):
        assert a.dur >= 0 and a.ts + a.dur <= b.ts + 1e-12
    execute = next(s for s in phases if s.name == "engine.execute")
    ops = [s for s in _operator_spans(trace)[1:]]
    assert ops and all(s.parent != -1 for s in ops)
    for s in ops:
        assert execute.ts <= s.ts and s.ts + s.dur <= execute.ts + execute.dur
    # the Chrome export is on the profiler's clock: the same intervals,
    # shifted by the origin
    doc = eng.telemetry.collector.to_chrome()
    tid = len(eng.telemetry.collector.traces) - 1
    events = [e for e in doc["traceEvents"]
              if e["ph"] == "X" and e["tid"] == tid]
    assert len(events) == len(trace.spans)
    for e, s in zip(events, trace.spans):
        assert e["name"] == s.name
        assert e["ts"] == pytest.approx(trace.t0_ns / 1e3 + s.ts * 1e6,
                                         abs=1e-3)
        assert e["dur"] == pytest.approx(s.dur * 1e6, abs=1e-3)


@pytest.mark.parametrize("task", ["q_g3", "a3_multiply"])
def test_phase_spans_leave_the_operator_views_as_they_were(dbs, task):
    """``shape()``, ``render()`` and the flight recorder's tree show the
    operator DAG alone: the same as the trace with its phases taken out,
    and the same tree as the reference's."""
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        run = eng.query if task.startswith("q_") else eng.analyze
        run(getattr(P.m2bench, task)())
        trace = eng.telemetry.last_trace()
        flight = [(s["name"], s["parent"]) for s in eng.observer.ring[-1].spans]
        if P is PORT:
            bare = P.telemetry.QueryTrace(trace.label)
            bare.spans = _operator_spans(trace)
            assert trace.shape() == bare.shape()
            assert trace.render(top=3) == bare.render(top=3)
            assert flight == [(s.name, s.parent) for s in bare.spans]
        tree = untimed(trace.render()).splitlines()
        return trace.shape(), tree, [name for name, _ in flight]
    ref, port = both(scenario)
    assert port == ref


def test_a_session_that_is_off_records_no_span(dbs, monkeypatch):
    P = PORT
    calls = []
    for name in ("__init__", "begin", "phase", "close"):
        orig = getattr(P.telemetry.QueryTrace, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(P.telemetry.QueryTrace, name, spy)
    eng = P.Engine(dbs[P.name])
    eng.query(P.m2bench.q_g3())
    eng.analyze(P.m2bench.a3_multiply())
    assert eng.telemetry is None and calls == []
    assert eng.observer.ring[-1].spans == []
    prof = eng.profile(P.m2bench.q_g1())        # a session on records them
    assert "phase" in calls and _phases(prof.trace)


def test_phase_spans_lie_on_the_profiler_clock(dbs):
    """Under ``torch.profiler`` (on the CPU), every phase span's interval on
    the profiler's clock lies inside a ``record_function`` range around the
    call, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    P = PORT
    eng = P.Engine(dbs[P.name], telemetry=True)
    eng.query(P.m2bench.q_g3())                       # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("engine_call"):
            eng.query(P.m2bench.q_g3())
    trace = eng.telemetry.last_trace()
    (mark,) = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "engine_call"]
    lo, hi = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    slack = 1_000_000
    assert _phases(trace)
    for s in _phases(trace):
        start = trace.t0_ns + s.ts * 1e9
        end = start + s.dur * 1e9
        assert lo - slack <= start <= end <= hi + slack, s.name
    doc = json.loads(eng.telemetry.collector.to_chrome_json())
    roots = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "query"]
    assert lo / 1e3 - 1e3 <= roots[-1]["ts"] <= hi / 1e3 + 1e3
