"""Twin of ``tests/test_observe.py``: the port's flight recorder captures the
same records (plan fingerprints, operators, inter-buffer deltas, triggers)
and dumps as the JAX package's, its health rules judge alike, its query and
task serialization is the same, and a workload recorded by either package
replays strictly — fingerprint-checked per event — through the other's
``observe.replay``."""
import json
import os
import tempfile
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_twin import PKGS, PORT, REF, both, fresh_matcher_counters


@pytest.fixture(autouse=True)
def _fresh_matcher_counters(monkeypatch):
    fresh_matcher_counters(monkeypatch)


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


def _record_view(rec) -> dict:
    """A flight record without its wall-clock fields."""
    d = rec.to_json() if hasattr(rec, "to_json") else dict(rec)
    d = {k: v for k, v in d.items() if k not in ("ts", "seconds", "spans",
                                                 "registry_delta")}
    d["operators"] = [{k: v for k, v in o.items() if k != "seconds"}
                      for o in d["operators"]]
    d["qerrors"] = [{k: v for k, v in q.items()} for q in d["qerrors"]]
    return d


def test_flight_record_captured_per_query(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.query(P.m2bench.q_g1())
        assert eng.observer is not None and len(eng.observer.ring) == 1
        rec = eng.observer.ring[-1]
        assert rec.seconds > 0 and rec.spans == [] and rec.registry_delta == {}
        json.dumps(rec.to_json())
        return _record_view(rec)
    ref, port = both(scenario)
    assert port == ref
    assert port["kind"] == "query" and port["mode"] == "gredo"
    assert len(port["plan_fingerprint"]) == 16 and port["operators"]
    assert port["label"].startswith("query")


def test_ring_is_bounded(dbs):
    def scenario(P):
        fr = P.observe.FlightRecorder(ring=4, auto_dump=False)
        eng = P.Engine(dbs[P.name], observe=fr)
        for _ in range(7):
            eng.query(P.m2bench.q_edge_scan())
        return len(fr.ring), fr.seq, fr.metrics()["records"], \
            [r.seq for r in fr.ring]
    ref, port = both(scenario)
    assert port == ref
    assert port[:3] == (4, 7, 7.0)


def test_observe_false_opts_out(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], observe=False)
        eng.query(P.m2bench.q_edge_scan())
        return eng.observer is None, "== health ==" in eng.explain_last()
    ref, port = both(scenario)
    assert port == ref == (True, False)


def test_slo_breach_dump_has_fingerprint_spans_and_registry_delta(dbs):
    def scenario(P):
        with tempfile.TemporaryDirectory() as tmp:
            fr = P.observe.FlightRecorder(default_slo=1e-9, dump_dir=tmp)
            eng = P.Engine(dbs[P.name], telemetry=True, observe=fr)
            eng.query(P.m2bench.q_g1())
            assert len(fr.dump_paths) == 1
            assert os.path.basename(fr.dump_paths[0]).startswith("flight_")
            with open(fr.dump_paths[0]) as f:
                doc = json.load(f)
        rec = doc["record"]
        assert rec["spans"] and all("name" in s and "parent" in s
                                    for s in rec["spans"])
        assert rec["registry_delta"] and doc["ring"]
        return (doc["trigger"], dict(fr.trigger_counts), _record_view(rec),
                [s["name"] for s in rec["spans"]], doc["trigger_counts"])
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == "slo-breach" and port[1] == {"slo-breach": 1}
    assert len(port[2]["plan_fingerprint"]) == 16


def test_per_template_slo_only_fires_on_named_template(dbs):
    def scenario(P):
        with tempfile.TemporaryDirectory() as tmp:
            eng = P.Engine(dbs[P.name], observe=P.observe.FlightRecorder(
                slo={"nonexistent-template": 1e-9}, dump_dir=tmp))
            eng.query(P.m2bench.q_g1())
            label = eng.observer.ring[-1].label
            eng2 = P.Engine(dbs[P.name], observe=P.observe.FlightRecorder(
                slo={label: 1e-9}, dump_dir=tmp))
            eng2.query(P.m2bench.q_g1())
            return dict(eng.observer.trigger_counts), label, \
                dict(eng2.observer.trigger_counts)
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == {} and port[2] == {"slo-breach": 1}


def test_qerror_trigger_fires_when_monitor_flags(dbs):
    def scenario(P):
        fr = P.observe.FlightRecorder(auto_dump=False)
        eng = P.Engine(dbs[P.name],
                       telemetry=P.telemetry.Telemetry(qerror_threshold=1.0),
                       observe=fr)
        eng.query(P.m2bench.q_g1())
        return _record_view(fr.ring[-1])
    ref, port = both(scenario)
    assert port == ref
    assert "qerror" in port["triggers"]
    assert port["qerrors"] and {"op", "est_rows", "actual_rows",
                                "q_error"} <= set(port["qerrors"][0])


def test_verify_error_dumps_failing_plan_and_report():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        with tempfile.TemporaryDirectory() as tmp:
            fr = P.observe.FlightRecorder(dump_dir=tmp)
            eng = P.Engine(db, debug=True, observe=fr)
            q = P.m2bench.q_shard_join()
            eng.query(q)
            t = db.tables["Orders"]
            t.columns["customer_id"] = P.storage.DictColumn(
                ["c"] * len(np.asarray(t.columns["quantity"])))
            with pytest.raises(P.verify.PlanVerificationError):
                eng.query(q)
            path = fr.dump_paths[-1]
            assert "verify-error" in os.path.basename(path)
            with open(path) as f:
                doc = json.load(f)
        return (dict(fr.trigger_counts), _record_view(doc["record"]),
                [r["kind"] for r in doc["ring"]])
    ref, port = both(scenario)
    assert port == ref
    counts, rec, ring = port
    assert counts.get("verify-error") == 1
    assert rec["kind"] == "verify" and rec["verify"]
    assert "query" in ring


def test_kernel_retry_storm_trigger(dbs):
    def scenario(P):
        fr = P.observe.FlightRecorder(auto_dump=False, retry_storm=2)
        eng = P.Engine(dbs[P.name], observe=fr)
        eng.query(P.m2bench.q_g1())
        before = list(fr.ring[-1].triggers)
        fr._retries0 -= 5
        return before, list(fr.observe(eng).triggers)
    ref, port = both(scenario)
    assert port == ref
    assert "kernel-retry-storm" not in port[0]
    assert "kernel-retry-storm" in port[1]


def test_interbuffer_collapse_trigger(dbs):
    def scenario(P):
        fr = P.observe.FlightRecorder(auto_dump=False)
        eng = P.Engine(dbs[P.name], observe=fr)
        fr.hit_peak = 1.0
        eng.analyze(P.m2bench.a3_multiply(), iters=2)
        return _record_view(fr.ring[-1])
    ref, port = both(scenario)
    assert port == ref
    assert port["kind"] == "analyze" and port["interbuffer"]["misses"] > 0
    assert "interbuffer-collapse" in port["triggers"]


def test_latency_anomaly_after_warmup():
    def scenario(P):
        fr = P.observe.FlightRecorder(auto_dump=False, warmup=3,
                                      anomaly_floor_s=0.0,
                                      anomaly_factor=4.0)

        def rec(seconds):
            fr.begin("t")
            r = P.observe.QueryRecord(
                seq=fr.seq, ts=time.time(), label="t", kind="query",
                mode="gredo", plan_fingerprint="0" * 16, seconds=seconds,
                shard_count=1, operators=[], interbuffer={},
                registry_delta={}, qerrors=[], verify=[], spans=[],
                triggers=[])
            fr.seq += 1
            return fr._evaluate(r, None)
        return [list(rec(s)) for s in (0.01, 0.01, 0.01, 0.02, 1.0)]
    ref, port = both(scenario)
    assert port == ref
    assert all("latency-anomaly" not in t for t in port[:4])
    assert "latency-anomaly" in port[4]


def test_max_dumps_throttles_incident_storms(dbs):
    def scenario(P):
        with tempfile.TemporaryDirectory() as tmp:
            fr = P.observe.FlightRecorder(default_slo=0.0, dump_dir=tmp,
                                          max_dumps=2)
            eng = P.Engine(dbs[P.name], observe=fr)
            for _ in range(5):
                eng.query(P.m2bench.q_edge_scan())
            return (len(fr.dump_paths), len(os.listdir(tmp)),
                    fr.dumps_suppressed, fr.trigger_counts["slo-breach"],
                    fr.metrics()["dumps_suppressed"])
    ref, port = both(scenario)
    assert port == ref == (2, 2, 3, 5, 3.0)


def test_flight_metrics_exported_through_registry(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.query(P.m2bench.q_edge_scan())
        snap = eng.telemetry.registry.snapshot()
        return {k: v for k, v in snap.items() if k.startswith("flight.")}
    ref, port = both(scenario)
    assert port == ref
    assert port["flight.records"] == 1.0 and "flight.dumps" in port


# ---------------------------------------------------------------------------
# health rules
# ---------------------------------------------------------------------------


def _checks(rep):
    return rep.status, [(c.name, c.level, c.detail) for c in rep.checks]


def test_health_report_all_rules_on_quiet_engine(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.query(P.m2bench.q_g1())
        rep = eng.health()
        assert len(rep.checks) == len(P.observe._HEALTH_RULES)
        assert "== health ==" in eng.explain_last()
        assert any("status:" in line for line in rep.render())
        return _checks(rep)
    ref, port = both(scenario)
    assert port == ref
    assert port[0] in (PORT.observe.OK, PORT.observe.WARN,
                       PORT.observe.CRITICAL)


SNAPSHOTS = [
    {"qerror.observations": 100, "qerror.flagged": 60},
    {"qerror.observations": 100, "qerror.flagged": 30},
    {"shard.shard_partitions": 8, "shard.rows_shard_mean": 1.0,
     "shard.rows_shard_max": 20.0},
    {"index.T/c.lookups": 100.0, "index.T/c.refreshes": 30.0},
    {"traversal_kernels.matches": 10, "traversal_kernels.retries": 15},
    {},
]


def test_health_rules_on_synthetic_snapshots():
    ref, port = both(lambda P: [_checks(P.observe.evaluate_health(s))
                                for s in SNAPSHOTS])
    assert port == ref
    O = PORT.observe
    levels = [dict((n, l) for n, l, _ in checks) for _, checks in port]
    assert port[0][0] == O.CRITICAL and levels[0]["qerror_drift"] == O.CRITICAL
    assert levels[1]["qerror_drift"] == O.WARN
    assert levels[2]["shard_skew"] == O.CRITICAL
    assert levels[3]["index_churn"] == O.WARN
    assert levels[4]["kernel_retries"] == O.CRITICAL
    assert port[5][0] == O.OK
    assert all("need" in d or "no " in d.lower() for _, _, d in port[5][1])


def test_health_gauges_land_in_registry(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        eng.query(P.m2bench.q_edge_scan())
        rep = eng.health()
        snap = eng.telemetry.registry.snapshot()
        assert snap["health.status"] == float(
            P.observe._LEVELS.index(rep.status))
        for c in rep.checks:
            assert snap[f"health.{c.name}"] == float(
                P.observe._LEVELS.index(c.level))
        return {k: v for k, v in snap.items() if k.startswith("health.")}
    ref, port = both(scenario)
    assert port == ref


def test_health_slo_rule_uses_recorder_ewma(dbs):
    def scenario(P):
        fr = P.observe.FlightRecorder(auto_dump=False, default_slo=1e-9)
        eng = P.Engine(dbs[P.name], observe=fr)
        eng.query(P.m2bench.q_g1())
        rep = eng.health()
        return rep.status, {c.name: c.level for c in rep.checks}
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == PORT.observe.CRITICAL
    assert port[1]["latency_slo"] == PORT.observe.CRITICAL


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------


def test_query_round_trip_through_json():
    def scenario(P):
        out = []
        for name in ("q_g1", "q_g3", "q_shard_join", "q_point_lookup",
                     "q_range_narrow", "q_edge_scan"):
            q = getattr(P.m2bench, name)()
            d = json.loads(json.dumps(P.observe.query_to_dict(q)))
            assert P.observe.query_from_dict(d) == q
            out.append(d)
        return out
    ref, port = both(scenario)
    assert port == ref
    # each package reads the other's serialization back
    for d in ref:
        assert PORT.observe.query_from_dict(d) == \
            PORT.observe.query_from_dict(json.loads(json.dumps(d)))


def test_task_round_trip_through_json():
    def scenario(P):
        out = []
        for name in ("a3_multiply", "a2_similarity", "a_shard_reg"):
            t = getattr(P.m2bench, name)()
            d = json.loads(json.dumps(P.observe.task_to_dict(t)))
            assert P.observe.task_from_dict(d) == t
            out.append(d)
        return out
    ref, port = both(scenario)
    assert port == ref
    for d, name in zip(ref, ("a3_multiply", "a2_similarity", "a_shard_reg")):
        assert PORT.observe.task_from_dict(d) == getattr(PORT.m2bench, name)()


def test_result_fingerprint_is_content_addressed(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        fp = P.observe.result_fingerprint
        a = fp(eng.query(P.m2bench.q_g1()))
        b = fp(eng.query(P.m2bench.q_g1()))
        c = fp(eng.query(P.m2bench.q_edge_scan()))
        x = np.arange(8, dtype=np.int64)
        return a, b, c, fp(x), fp(x.astype(np.float64))
    ref, port = both(scenario)
    assert port == ref
    a, b, c, xi, xf = port
    assert a == b and a != c and len(a) == 16 and xi != xf


# ---------------------------------------------------------------------------
# workload capture & replay, across the two packages
# ---------------------------------------------------------------------------


def _capture_workload(P, path, mode="gredo"):
    db = P.m2bench.generate(sf=1)
    eng = P.Engine(db, mode=mode)
    g = db.graphs["Interested_in"]
    with eng.record(path) as rec:
        eng.query(P.m2bench.q_g1())
        g.insert_edges({"svid": np.array([0, 1, 2], dtype=np.int64),
                        "tvid": np.array([1, 2, 3], dtype=np.int64),
                        "weight": np.array([0.5, 0.25, 0.75])})
        eng.query(P.m2bench.q_g1())
        live = g.live_edge_ids()
        g.delete_edges(np.asarray(live[:2]))
        eng.analyze(P.m2bench.a3_multiply(), iters=3)
        db.touch_table("Orders")
        eng.query(P.m2bench.q_edge_scan())
        assert rec.events >= 7
    return db


def _write_state(db):
    return ({n: (g.epoch, g.write_counters.metrics())
             for n, g in db.graphs.items()},
            {n: db.epoch_of(n) for n in db.tables})


def _events(path, drop=("t", "seconds", "ts", "wall_s")):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


@pytest.mark.parametrize("recorder,replayer", [(REF, PORT), (PORT, REF),
                                               (PORT, PORT)])
def test_capture_replay_bit_for_bit(recorder, replayer):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.jsonl")
        db = _capture_workload(recorder, path)
        events = _events(path)
        assert events[0]["kind"] == "header" and events[0]["mode"] == "gredo"
        kinds = [e["kind"] for e in events[1:]]
        assert kinds.count("query") == 3 and kinds.count("analyze") == 1
        for e in events[1:]:
            if e["kind"] in ("query", "analyze"):
                assert len(e["fp"]) == 16 and e["epochs"]
        db2 = replayer.m2bench.generate(sf=1)
        rep = replayer.replay(db2, path, strict=True)
        assert rep.ok
        assert (rep.queries, rep.analytics, rep.mutations) == (3, 1, 3)
        assert _write_state(db2) == _write_state(db)


def test_captured_workloads_are_the_same_file_in_both():
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for P in PKGS:
            paths[P.name] = os.path.join(tmp, f"{P.name}.jsonl")
            _capture_workload(P, paths[P.name])
        ref, port = (_events(paths[P.name]) for P in PKGS)
    assert [e["kind"] for e in port] == [e["kind"] for e in ref]
    for r, t in zip(ref, port):
        for key in ("fp", "epochs", "query", "task", "label", "graph"):
            assert t.get(key) == r.get(key), (r["kind"], key)


def test_replay_strict_raises_on_divergence():
    def scenario(P):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "workload.jsonl")
            _capture_workload(P, path)
            with open(path) as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                ev = json.loads(line)
                if ev["kind"] == "query":
                    ev["fp"] = "0" * 16
                    lines[i] = json.dumps(ev)
                    break
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            with pytest.raises(P.observe.ReplayMismatch):
                P.replay(P.m2bench.generate(sf=1), path, strict=True)
            rep = P.replay(P.m2bench.generate(sf=1), path, strict=False)
            return rep.ok, len(rep.mismatches)
    ref, port = both(scenario)
    assert port == ref == (False, 1)


def test_recorder_detaches_listeners_on_exit(dbs):
    def scenario(P):
        db = dbs[P.name]
        eng = P.Engine(db)
        with tempfile.TemporaryDirectory() as tmp:
            with eng.record(os.path.join(tmp, "w.jsonl")):
                during = (eng._recorder is not None,
                          all(g.listeners for g in db.graphs.values()),
                          bool(db.listeners))
        return during, (eng._recorder is None,
                        all(not g.listeners for g in db.graphs.values()),
                        not db.listeners)
    ref, port = both(scenario)
    assert port == ref == ((True, True, True), (True, True, True))


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       mode=st.sampled_from(["gredo", "dual", "single"]))
def test_capture_replay_property(seed, mode):
    """A random query/mutation interleaving recorded by the port replays
    strictly through the reference, and one recorded by the reference
    through the port, with the same write state."""
    def capture(P, path):
        rng = np.random.default_rng(seed)
        steps = [["q_g1", "q_edge_scan", "q_vertex_scan", "edges",
                  "tombstone", "analyze"][rng.integers(0, 6)]
                 for _ in range(6)]
        db = P.m2bench.generate(sf=1)
        eng = P.Engine(db, mode=mode)
        g = db.graphs["Interested_in"]
        with eng.record(path):
            for op in steps:
                if op == "edges":
                    m = int(rng.integers(1, 20))
                    g.insert_edges({
                        "svid": rng.integers(0, 100, m).astype(np.int64),
                        "tvid": rng.integers(0, P.m2bench.N_TAGS,
                                             m).astype(np.int64),
                        "weight": rng.uniform(0.0, 1.0, m)})
                elif op == "tombstone":
                    live = g.live_edge_ids()
                    m = min(int(rng.integers(1, 10)), len(live))
                    if m:
                        g.delete_edges(rng.choice(live, m, replace=False))
                elif op == "analyze":
                    eng.analyze(P.m2bench.a3_multiply(), iters=2)
                else:
                    eng.query(getattr(P.m2bench, op)())
        return db, len(steps)

    with tempfile.TemporaryDirectory() as tmp:
        for recorder, replayer in ((PORT, REF), (REF, PORT)):
            path = os.path.join(tmp, f"{recorder.name}.jsonl")
            db, n_steps = capture(recorder, path)
            db2 = replayer.m2bench.generate(sf=1)
            rep = replayer.replay(db2, path, strict=True)
            assert rep.ok
            assert rep.queries + rep.analytics + rep.mutations >= n_steps
            assert _write_state(db2)[0] == _write_state(db)[0]


def test_observer_disabled_overhead_bounded(dbs):
    """The port's engine with the flight recorder on against it off."""
    db = dbs[PORT.name]
    q = PORT.m2bench.q_edge_scan()
    on, off = PORT.Engine(db), PORT.Engine(db, observe=False)
    for _ in range(3):
        on.query(q)
        off.query(q)
    t_on, t_off = [], []
    for _ in range(15):
        t0 = time.perf_counter()
        off.query(q)
        t_off.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        on.query(q)
        t_on.append(time.perf_counter() - t0)
    assert min(t_on) <= min(t_off) * 1.25
