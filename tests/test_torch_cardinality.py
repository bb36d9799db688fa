"""Twin of ``tests/test_cardinality.py``: the port's cardinality model gives
the same join overlaps (and provenance), the same q-errors on the Zipfian
workload, the same bushy plan and DP costs, the same per-hop label-aware
fan-out estimates, and the same epoch-keyed cache behaviour as the JAX
package's."""
import numpy as np
import pytest
from torch_twin import PKGS, both


@pytest.fixture(scope="module")
def skew_dbs():
    return {P.name: P.m2bench.generate_skew(sf=1) for P in PKGS}


def _qerr(est, actual):
    return max(est / max(actual, 1e-9), actual / max(est, 1e-9))


def _overlap(P, left, right):
    cs = P.storage.compute_stats
    return cs(left).join_overlap(cs(right))


def test_join_overlap_mcv_is_exact():
    ref, port = both(lambda P: _overlap(
        P, P.storage.DictColumn(values=["a"] * 90 + ["b"] * 10),
        P.storage.DictColumn(values=["a"] * 5 + ["c"] * 2)))
    assert port == ref
    assert port[0] == 90 * 5 and port[1].startswith("mcv×mcv")


def test_join_overlap_numeric_mcv_vs_histogram():
    rng = np.random.default_rng(0)
    big = rng.permutation(10_000).astype(np.float64)

    def scenario(P):
        s = P.storage.compute_stats(big)
        assert s.value_counts is None and s.hist is not None
        return _overlap(P, np.arange(10, dtype=np.float64), big)
    ref, port = both(scenario)
    assert port == ref
    assert 2.0 <= port[0] <= 50.0 and "hist" in port[1] and "mcv" in port[1]


def test_join_overlap_histogram_pair():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 10_000, 10_000).astype(np.float64)
    b = rng.integers(0, 10_000, 10_000).astype(np.float64)
    ref, port = both(lambda P: _overlap(P, a, b))
    assert port == ref
    assert 5_000 <= port[0] <= 20_000 and port[1].startswith("hist[")


def test_join_overlap_none_without_distribution_falls_back_to_ndv():
    def scenario(P):
        l = P.storage.ColumnStats(n=100, ndv=10)
        r = P.storage.ColumnStats(n=50, ndv=5)
        assert l.join_overlap(r) is None
        return P.physical.est_join_rows_detail(100, 50, l, r)
    ref, port = both(scenario)
    assert port == ref
    assert port[1] == "ndv" and port[0] == pytest.approx(100 * 50 / 10)


def test_join_overlap_matches_true_zipf_join_size(skew_dbs):
    def scenario(P):
        db = skew_dbs[P.name]
        c = db.tables["Clicks"].stats("user_id")
        p = db.tables["Purchases"].stats("user_id")
        cu = np.bincount(np.asarray(db.tables["Clicks"].col("user_id")))
        pu = np.bincount(np.asarray(db.tables["Purchases"].col("user_id")),
                         minlength=len(cu))
        matches, how = c.join_overlap(p)
        return (float(cu @ pu[:len(cu)]), matches, how,
                c.n * p.n / max(c.ndv, p.ndv))
    ref, port = both(scenario)
    assert port == ref
    true, matches, how, ndv_est = port
    assert how.startswith("mcv×mcv") and matches == pytest.approx(true)
    assert true / ndv_est > 5.0


def test_filtered_inputs_scale_the_overlap():
    def scenario(P):
        cs, D = P.storage.compute_stats, P.storage.DictColumn
        l = cs(D(values=["a"] * 80 + ["b"] * 20))
        r = cs(D(values=["a"] * 10))
        return (P.physical.est_join_rows(100, 10, l, r),
                P.physical.est_join_rows(50, 10, l, r))
    ref, port = both(scenario)
    assert port == ref == (pytest.approx(800), pytest.approx(400))


def test_overlap_maintained_across_delta_appends():
    def scenario(P):
        S = P.storage
        vt = S.Table("A", {"v": np.arange(10, dtype=np.float64)})
        edges = S.Table("E", {"svid": np.zeros(1, dtype=np.int64),
                              "tvid": np.zeros(1, dtype=np.int64)})
        g = S.Graph("G", {"A": vt}, edges, "A", "A",
                    delta_config=P.deltastore.DeltaConfig(auto_compact=False))
        probe = S.compute_stats(np.array([3.0, 3.0]))
        before = g.vertex_tables["A"].stats("v").join_overlap(probe)
        g.insert_vertices("A", {"v": np.array([3.0, 3.0, 3.0])})
        return before, g.vertex_tables["A"].stats("v").join_overlap(probe)
    ref, port = both(scenario)
    assert port == ref
    (before, _), (after, how) = port
    assert before == pytest.approx(2.0) and after == pytest.approx(8.0)
    assert how.startswith("mcv×mcv")


def test_skew_query_qerror_hist_beats_ndv(skew_dbs):
    def scenario(P):
        db = skew_dbs[P.name]
        q = P.m2bench.q_skew_3join()
        eng = P.Engine(db)
        r = eng.query(q)
        hist = (eng.last_ests[id(eng.last_dag)][0], r.nrows, P.fingerprint(r))
        P.physical.HIST_JOIN_EST = False
        try:
            eng_ndv = P.Engine(db)
            r2 = eng_ndv.query(q)
            ndv = (eng_ndv.last_ests[id(eng_ndv.last_dag)][0], r2.nrows,
                   P.fingerprint(r2))
        finally:
            P.physical.HIST_JOIN_EST = True
        return hist, ndv
    ref, port = both(scenario)
    assert port == ref
    hist, ndv = port
    assert hist[1:] == ndv[1:]
    q_hist, q_ndv = _qerr(*hist[:2]), _qerr(*ndv[:2])
    assert q_hist <= 4.0 and q_ndv >= 2.0 * q_hist


def test_skew_query_provenance_rendered(skew_dbs):
    ref, port = both(lambda P: P.physical.explain(
        P.Engine(skew_dbs[P.name]).optimized_plan(P.m2bench.q_skew_3join()),
        db=skew_dbs[P.name]))
    assert port == ref
    assert "est_via=mcv×mcv" in port


def _is_bushy(P, root) -> bool:
    ph = P.physical

    def has_join(n):
        return isinstance(n, (ph.EquiJoin, ph.IntraFilter)) \
            or any(has_join(c) for c in n.children)

    def walk(n):
        if isinstance(n, ph.EquiJoin) and all(map(has_join, n.children)):
            return True
        return any(walk(c) for c in n.children)
    return walk(root)


def test_bushy_plan_selected_on_4_source_query(skew_dbs):
    def scenario(P):
        eng = P.Engine(skew_dbs[P.name])
        dag = eng.optimized_plan(P.m2bench.q_bushy_4src())
        return P.physical.explain(dag), _is_bushy(P, dag), \
            eng.last_report.notes()
    ref, port = both(scenario)
    assert port == ref
    assert port[0].startswith("Project[SrcA.id, DstB.id]") and port[1]
    assert any(n.startswith("join-order: dp bushy") for n in port[2])


def test_every_left_deep_order_is_worse(skew_dbs):
    def scenario(P):
        db = skew_dbs[P.name]
        q = P.m2bench.q_bushy_4src()
        cache: dict = {}
        bushy_eng = P.Engine(db)
        ld_eng = P.Engine(db, join_enum="dp-leftdeep")
        bushy_dag = bushy_eng.optimized_plan(q)
        ld_dag = ld_eng.optimized_plan(q)
        costs = (P.optimizer._est_cost(bushy_dag, db, cache),
                 P.optimizer._est_cost(ld_dag, db, cache))
        r_bushy, r_ld = bushy_eng.query(q), ld_eng.query(q)

        def max_join_rows(eng):
            return max((o["rows"] or 0) for o in eng.last_stats.operators
                       if o["op"] == "EquiJoin")
        return (_is_bushy(P, ld_dag), costs, P.fingerprint(r_bushy),
                r_bushy.nrows, r_ld.nrows, max_join_rows(bushy_eng),
                max_join_rows(ld_eng))
    ref, port = both(scenario)
    assert port == ref
    ld_bushy, (c_bushy, c_ld), _, n_b, n_ld, j_b, j_ld = port
    assert not ld_bushy and c_bushy < c_ld and n_b == n_ld
    assert j_ld > 10 * j_b


def test_greedy_fallback_still_used_above_dp_cap(skew_dbs):
    def scenario(P):
        q = P.m2bench.q_bushy_4src()
        g = P.Engine(skew_dbs[P.name], join_enum="greedy").query(q)
        d = P.Engine(skew_dbs[P.name]).query(q)
        return g.nrows, d.nrows, P.fingerprint(g)
    ref, port = both(scenario)
    assert port == ref and port[0] == port[1]


def _bipartite_graph(P, n_a=10, n_b=1000, n_e=2000, seed=0):
    S = P.storage
    rng = np.random.default_rng(seed)
    va = S.Table("A", {"x": np.arange(n_a, dtype=np.int64)})
    vb = S.Table("B", {"y": np.arange(n_b, dtype=np.int64)})
    edges = S.Table("E", {"svid": rng.integers(0, n_a, n_e).astype(np.int64),
                          "tvid": rng.integers(0, n_b, n_e).astype(np.int64)})
    return S.Graph("G", {"A": va, "B": vb}, edges, "A", "B")


def test_hop_expansion_label_override():
    def scenario(P):
        g = _bipartite_graph(P)
        return (g.hop_expansion(), g.hop_expansion(reverse=True),
                g.hop_expansion(label="B"),
                g.hop_expansion(reverse=True, label="A"))
    ref, port = both(scenario)
    assert port == ref == pytest.approx((200.0, 2.0, 2.0, 200.0))


def _chain_estimate(P, kind, hops, reverse=False):
    g = _bipartite_graph(P)
    db = P.storage.Database()
    db.add_graph(g)
    pat = P.schema.chain_pattern("G", *hops)
    if kind == "TableJoinMatch":
        node = P.physical.TableJoinMatch("G", 0, pat, {})
    else:
        pplan = P.pattern.PatternPlan(pat, reverse=reverse, pushed={},
                                      deferred={}, fetch_vars=set())
        node = P.physical.MatchPattern("G", 0, pplan, ())
    return P.physical.estimate(node, db)[id(node)][0], \
        g.hop_expansion(reverse=True)


TWO_HOP = (("a", "A", "E", "b", "B"), ("b", "B", "E", "c", "B"))


def test_table_join_match_estimate_is_per_hop_label_aware():
    ref, port = both(_chain_estimate, "TableJoinMatch", TWO_HOP)
    assert port == ref
    assert port[0] == pytest.approx(2000 * 2.0)


def test_match_pattern_estimate_is_per_hop_label_aware():
    ref, port = both(_chain_estimate, "MatchPattern", TWO_HOP)
    assert port == ref
    assert port[0] == pytest.approx(10 * 200.0 * 2.0)


def test_single_hop_reverse_estimate_unchanged():
    ref, port = both(_chain_estimate, "MatchPattern",
                     (("a", "A", "E", "b", "B"),), reverse=True)
    assert port == ref
    assert port[0] == pytest.approx(1000 * port[1])


def _find_op(root, cls):
    if isinstance(root, cls):
        return root
    for c in root.children:
        hit = _find_op(c, cls)
        if hit is not None:
            return hit
    return None


def test_estimate_cache_invalidated_by_delta_appends():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        eng = P.Engine(db)
        q = P.m2bench.q_g1()
        eng.optimized_plan(q)
        snap1 = eng._opt_cache["__catalog__"]
        rows1 = P.optimizer._est_rows(
            _find_op(eng.last_dag, P.physical.MatchPattern), db,
            eng._opt_cache)
        db.graphs["Interested_in"].insert_edges(
            {"svid": np.arange(400, dtype=np.int64),
             "tvid": np.arange(400, dtype=np.int64) % 40,
             "weight": np.linspace(0, 1, 400)})
        eng.optimized_plan(q)
        snap2 = eng._opt_cache["__catalog__"]
        rows2 = P.optimizer._est_rows(
            _find_op(eng.last_dag, P.physical.MatchPattern), db,
            eng._opt_cache)
        return snap1, snap2, rows1, rows2
    ref, port = both(scenario)
    assert port == ref
    snap1, snap2, rows1, rows2 = port
    assert snap1 != snap2 and rows2 > rows1


def test_estimate_cache_invalidated_by_join_model_toggle():
    def scenario(P):
        db = P.m2bench.generate_skew(sf=1)
        eng = P.Engine(db)
        q = P.m2bench.q_skew_3join()
        eng.optimized_plan(q)
        hist_root = eng.last_ests[id(eng.last_dag)][0]
        P.physical.HIST_JOIN_EST = False
        try:
            eng.optimized_plan(q)
            flag = eng._opt_cache["__catalog__"][1]
            root = eng.last_dag
            ndv_root = P.physical.estimate(root, db,
                                           _cache=eng._opt_cache)[id(root)][0]
        finally:
            P.physical.HIST_JOIN_EST = True
        return hist_root, ndv_root, flag
    ref, port = both(scenario)
    assert port == ref
    hist_root, ndv_root, flag = port
    assert ndv_root < hist_root / 2 and flag is False


def test_shared_cache_cleared_when_catalog_moves():
    def scenario(P):
        db = P.m2bench.generate(sf=1)
        eng = P.Engine(db)
        cache: dict = {}
        P.optimizer.optimize(eng.physical_plan(P.m2bench.q_g1()), db,
                             cache=cache)
        cache["__sentinel__"] = True
        P.optimizer.optimize(eng.physical_plan(P.m2bench.q_g1()), db,
                             cache=cache)
        kept = cache.get("__sentinel__") is True
        db.graphs["Interested_in"].insert_edges(
            {"svid": np.array([0]), "tvid": np.array([0]),
             "weight": np.array([0.5])})
        P.optimizer.optimize(eng.physical_plan(P.m2bench.q_g1()), db,
                             cache=cache)
        epochs, hist_flag = cache["__catalog__"]
        return (kept, "__sentinel__" in cache,
                dict(epochs)["Interested_in"] == db.epoch_of("Interested_in"),
                hist_flag is P.physical.HIST_JOIN_EST, sorted(epochs))
    ref, port = both(scenario)
    assert port == ref
    assert port[:4] == (True, False, True, True)
