"""Twin of ``tests/test_physical.py``: the port's operator DAG has the same
plan shapes per mode, the same explain text (estimates, rewrites, counters),
the same per-operator stats, signatures that behave alike, the same
operator-level inter-buffer reuse, and merged record views that evolve
alike under the same writes as the JAX package's."""
import numpy as np
import pytest
from torch_twin import PKGS, both, host, op_summary, untimed

GOLDEN_CASES = [("q_g1", "gredo"), ("q_g1", "dual"), ("q_g1", "single"),
                ("q_g4", "gredo"), ("q_vertex_scan", "gredo"),
                ("q_edge_scan", "gredo")]


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


@pytest.mark.parametrize("qname,mode", GOLDEN_CASES)
def test_plan_shape_snapshot(dbs, qname, mode):
    ref, port = both(lambda P: P.physical.explain(
        P.Engine(dbs[P.name], mode=mode).physical_plan(
            getattr(P.m2bench, qname)())))
    assert port == ref
    assert port.startswith("Project[")


def test_engine_explain_renders_pre_and_post_rewrite(dbs):
    ref, port = both(lambda P: (
        P.Engine(dbs[P.name]).explain(P.m2bench.q_g1()),
        P.Engine(dbs[P.name], mode="dual").explain(P.m2bench.q_g1())))
    assert port == ref
    out, out_dual = port
    assert "naive DAG (pre-rewrite)" in out
    assert "optimized DAG (post-rewrite)" in out
    assert "est_rows=" in out and "est_cost=" in out
    assert "== rewrites ==" in out
    assert "pre-rewrite" not in out_dual and "est_rows=" in out_dual


def test_explain_last_shows_est_vs_actual_and_counters(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.query(P.m2bench.q_g1())
        return untimed(eng.explain_last())
    ref, port = both(scenario)
    assert port == ref
    assert "rows=" in port and "est_rows=" in port
    assert "interbuffer: hits=" in port and "bypasses=" in port


def test_every_mode_executes_through_the_dag(dbs):
    def scenario(P):
        out = {}
        for mode in ("gredo", "dual", "single"):
            eng = P.Engine(dbs[P.name], mode=mode)
            r = eng.query(P.m2bench.q_g1())
            ops = [o["op"] for o in eng.last_stats.operators]
            assert ops[0] == "Project" and "GraphProject" in ops
            executed = [o for o in eng.last_stats.operators if o["executed"]]
            assert executed and all(o["seconds"] >= 0 for o in executed)
            assert r.nrows == eng.last_stats.operators[0]["rows"]
            out[mode] = (P.fingerprint(r), op_summary(eng.last_stats))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_cost_estimates_cover_every_operator(dbs):
    def scenario(P):
        db = dbs[P.name]
        out = []
        for qname in ("q_g1", "q_g4", "q_vertex_scan", "q_edge_scan"):
            for mode in ("gredo", "dual", "single"):
                dag = P.Engine(db, mode=mode).physical_plan(
                    getattr(P.m2bench, qname)())
                ests = P.physical.estimate(dag, db)
                assert ests and all(r >= 0 and c >= 0 and np.isfinite(r + c)
                                    for r, c in ests.values())
                rendered = P.physical.explain(dag, db=db)
                assert "est_cost=" in rendered and "est_rows=" in rendered
                out.append((rendered, sorted(ests.values())))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_node_signatures_embed_epochs_and_structure(dbs):
    def scenario(P):
        db = dbs[P.name]
        eng = P.Engine(db)
        s1 = eng.physical_plan(P.m2bench.q_g1()).signature()
        s2 = eng.physical_plan(P.m2bench.q_g1()).signature()
        s3 = eng.physical_plan(P.m2bench.q_g2()).signature()
        s4 = P.Engine(db, mode="single").physical_plan(
            P.m2bench.q_g1()).signature()
        assert s1 == s2 and s3 != s1 and s4 != s1
        return s1, s3, s4
    ref, port = both(scenario)
    assert port == ref


def _task(P, op, inputs):
    return P.schema.GCDIATask(integration=P.m2bench.q_g1(),
                              analytics=P.schema.AnalyticsTask(op, inputs))


def _reuse_observables(eng):
    return {"hits": eng.interbuffer.hits,
            "fetches": eng.last_stats.record_fetches,
            "nodes_reused": eng.last_stats.nodes_reused,
            "interbuffer_hit": eng.last_stats.interbuffer_hit,
            "operators": op_summary(eng.last_stats)}


def test_changed_analytics_op_reuses_gcdi_relation():
    def scenario(P):
        eng = P.Engine(P.m2bench.generate(sf=1))
        eng.analyze(_task(P, "MULTIPLY",
                          [("rel2matrix", ("Customer.id", "t.tid"))]))
        cold = _reuse_observables(eng)
        eng.analyze(_task(P, "SIMILARITY", [("random", "Customer.id",
                                             "t.tid", P.m2bench.N_TAGS)]))
        return cold, _reuse_observables(eng), "interbuffer-hit" in \
            eng.explain_last()
    ref, port = both(scenario)
    assert port == ref
    cold, warm, hit_in_explain = port
    assert cold["hits"] == 0 and cold["fetches"] > 0
    assert warm["hits"] == 1 and warm["fetches"] == 0
    by_op = {o["op"]: o for o in warm["operators"]}
    assert by_op["Project"]["cached"] and not by_op["Project"]["executed"]
    assert not by_op["MatchPattern"]["executed"]
    assert by_op["Similarity"]["executed"]
    assert warm["nodes_reused"] == 1 and hit_in_explain


def test_epoch_bump_invalidates_mid_plan_reuse():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        eng = P.Engine(db)
        eng.analyze(_task(P, "MULTIPLY",
                          [("rel2matrix", ("Customer.id", "t.tid"))]))
        db.graphs["Interested_in"].insert_edges(
            {"svid": np.array([0]), "tvid": np.array([1]),
             "weight": np.array([0.5])})
        eng.analyze(_task(P, "SIMILARITY", [("random", "Customer.id",
                                             "t.tid", P.m2bench.N_TAGS)]))
        return _reuse_observables(eng)
    ref, port = both(scenario)
    assert port == ref
    assert port["hits"] == 0 and port["fetches"] > 0
    by_op = {o["op"]: o for o in port["operators"]}
    assert by_op["Project"]["executed"] and not by_op["Project"]["cached"]


def test_identical_task_hits_at_the_root():
    def scenario(P):
        eng = P.Engine(P.m2bench.generate(sf=1))
        t = _task(P, "SIMILARITY", [("random", "Customer.id", "t.tid",
                                     P.m2bench.N_TAGS)])
        out1, out2 = host(eng.analyze(t)), host(eng.analyze(t))
        np.testing.assert_array_equal(out1, out2)
        return _reuse_observables(eng), out1
    (ref, ref_out), (port, port_out) = both(scenario)
    assert port == ref
    assert port["hits"] == 1 and port["interbuffer_hit"]
    np.testing.assert_allclose(port_out, ref_out, rtol=3e-4, atol=3e-5)


def test_shared_subplans_execute_once(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.query(P.m2bench.q_g1())
        return [o for o in op_summary(eng.last_stats)
                if o["op"] == "ScanTable"]
    ref, port = both(scenario)
    assert port == ref
    assert len(port) == 1


# ---------------------------------------------------------------------------
# Incremental merged record views (capacity-doubling column buffers)
# ---------------------------------------------------------------------------


def _small_graph(P):
    S = P.storage
    rng = np.random.default_rng(0)
    vt = S.Table("A", {"attr": rng.integers(0, 5, 10).astype(np.int64),
                       "tag": S.DictColumn(values=[("x", "y")[i % 2]
                                                   for i in range(10)]),
                       "xs": S.RaggedColumn(lists=[[i, i + 1]
                                                   for i in range(10)])})
    edges = S.Table("E", {"svid": rng.integers(0, 10, 30).astype(np.int64),
                          "tvid": rng.integers(0, 10, 30).astype(np.int64),
                          "w": rng.uniform(0, 1, 30)})
    return S.Graph("G", {"A": vt}, edges, "A", "A",
                   delta_config=P.deltastore.DeltaConfig(auto_compact=False))


def _columns(t):
    out = {}
    for name in t.columns:
        c = t.col(name)
        if hasattr(c, "codes"):
            out[name] = (c.codes.tolist(), list(c.vocab))
        elif hasattr(c, "offsets"):
            out[name] = (np.asarray(c.values).tolist(),
                         np.asarray(c.offsets).tolist(),
                         str(np.asarray(c.values).dtype))
        else:
            out[name] = (np.asarray(c).tolist(), str(np.asarray(c).dtype))
    return out


def test_merged_views_append_only_the_delta_tail():
    def scenario(P):
        g = _small_graph(P)
        g.insert_edges({"svid": np.array([0]), "tvid": np.array([1]),
                        "w": np.array([0.5])})
        e1 = g.edges
        merger = g._edge_merger
        assert merger is not None and merger._cached_runs == 1
        assert g.edges is e1
        g.insert_edges({"svid": np.array([2]), "tvid": np.array([3]),
                        "w": np.array([0.7])})
        e2 = g.edges
        assert g._edge_merger is merger and merger._cached_runs == 2
        np.testing.assert_array_equal(np.asarray(e2.col("svid"))[:31],
                                      np.asarray(e1.col("svid")))
        return _columns(e1), _columns(e2)
    ref, port = both(scenario)
    assert port == ref
    assert len(port[1]["w"][0]) == 32
    np.testing.assert_allclose(port[1]["w"][0][-2:], [0.5, 0.7])


def test_merged_vertex_views_all_column_kinds():
    def scenario(P):
        g = _small_graph(P)
        g.insert_vertices("A", {"attr": np.array([7]), "tag": ["z"],
                                "xs": [[99, 100]]})
        g.insert_vertices("A", {"attr": np.array([8]), "tag": ["x"],
                                "xs": [[]]})
        vt = g.vertex_tables["A"]
        assert g._vt_mergers["A"]._cached_runs == 2
        return vt.nrows, _columns(vt), \
            list(vt.col("tag").decode(vt.col("tag").codes))
    ref, port = both(scenario)
    assert port == ref
    nrows, cols, tags = port
    assert nrows == 12 and cols["attr"][0][-2:] == [7, 8]
    assert tags[-2:] == ["z", "x"] and len(cols["tag"][1]) == 3


def test_ragged_merge_promotes_float_into_int_values():
    def scenario(P):
        g = _small_graph(P)
        g.insert_vertices("A", {"attr": np.array([1]), "tag": ["x"],
                                "xs": [[1.5, 2.5]]})
        xs = g.vertex_tables["A"].col("xs")
        return str(np.asarray(xs.values).dtype), xs.row(10).tolist(), \
            xs.row(0).tolist()
    ref, port = both(scenario)
    assert port == ref
    assert port[0].startswith("float") and port[1] == [1.5, 2.5]
    assert port[2] == [0, 1]


def test_merged_views_survive_compaction_cycle():
    def scenario(P):
        g = _small_graph(P)
        g.insert_edges({"svid": np.array([0, 1]), "tvid": np.array([1, 2]),
                        "w": np.array([0.5, 0.6])})
        before = _columns(g.edges)
        g.compact()
        assert g._edge_merger is None
        after = _columns(g.edges)
        g.insert_edges({"svid": np.array([3]), "tvid": np.array([4]),
                        "w": np.array([0.9])})
        return before, after, _columns(g.edges)
    ref, port = both(scenario)
    assert port == ref
    before, after, last = port
    np.testing.assert_allclose(after["w"][0], before["w"][0])
    assert len(last["w"][0]) == 33
