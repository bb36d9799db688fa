"""Twin of ``tests/test_optimizer.py``: the port's cost-based optimizer
rewrites to the same plans (join order, semi-join siding, CSE, sink-down,
pruning; the same rewrite log and estimates) as the JAX package's, its
results are the same, its statistics layer answers alike, and its
inter-buffer admits and bypasses alike."""
import numpy as np
import pytest
import torch
from torch_twin import PKGS, PORT, both, op_summary, rows_multiset, untimed


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


def test_skewed_three_join_is_reordered(dbs):
    def scenario(P):
        db = dbs[P.name]
        eng = P.Engine(db)
        q = P.m2bench.q_opt_skew()
        naive_text = P.physical.explain(eng.physical_plan(q))
        opt_text = P.physical.explain(eng.optimized_plan(q))
        naive = P.Engine(db, enable_optimizer=False).query(q)
        opt = eng.query(q)
        assert rows_multiset(naive) == rows_multiset(opt)
        return (naive_text, opt_text, P.fingerprint(opt),
                list(eng.last_stats.rewrites))
    ref, port = both(scenario)
    assert port == ref
    assert port[0] != port[1]
    assert "SemiJoinMask[Persons.pid ∈ person_id]" in port[1]
    assert "^shared:PruneCols[id, person_id]" in port[1]
    assert any(n.startswith("join-order") for n in port[3])


def test_semi_join_siding_picks_graph_mask_on_g4(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        dag = eng.optimized_plan(P.m2bench.q_g4())
        return P.physical.explain(dag), eng.last_report.notes()
    ref, port = both(scenario)
    assert port == ref
    assert "SemiJoinMask[Persons.pid ∈ person_id]" in port[0]
    assert any("semi-join" in n and "graph-side mask" in n for n in port[1])


def test_optimizer_preserves_semantics_across_workload(dbs):
    def scenario(P):
        db = dbs[P.name]
        out = {}
        for qname in ("q_g1", "q_g2", "q_g3", "q_g4", "q_g5", "q_opt_skew",
                      "q_edge_scan", "q_vertex_scan"):
            q = getattr(P.m2bench, qname)()
            naive = P.Engine(db, enable_optimizer=False).query(q)
            opt = P.Engine(db).query(q)
            assert rows_multiset(naive) == rows_multiset(opt), qname
            out[qname] = (P.fingerprint(naive), P.fingerprint(opt))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_build_side_is_the_smaller_input(dbs):
    def scenario(P):
        db = dbs[P.name]
        dag = P.Engine(db).optimized_plan(P.m2bench.q_opt_skew())
        ests = P.physical.estimate(dag, db)
        sides = []

        def walk(n):
            if isinstance(n, P.physical.EquiJoin):
                l, r = n.children
                assert ests[id(r)][0] <= ests[id(l)][0], n.describe()
                sides.append((n.describe(), ests[id(l)], ests[id(r)]))
            for c in n.children:
                walk(c)
        walk(dag)
        return sides
    ref, port = both(scenario)
    assert port == ref and port


def _count_nodes(root):
    seen = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            walk(c)
    walk(root)
    return len(seen)


def test_cse_unifies_duplicate_subtrees(dbs):
    def scenario(P):
        ph = P.physical
        db = dbs[P.name]
        ep = db.epoch_of("Customer")
        pred = P.schema.Predicate("Customer.age", ">=", 30)
        a = ph.Select(ph.ScanTable("Customer", ep), [pred])
        b = ph.Select(ph.ScanTable("Customer", ep), [pred])
        join = ph.EquiJoin(P.schema.JoinPred("Customer.id", "Customer.id"),
                           a, b)
        root = ph.Project(("Customer.id",), (("Customer", ep),), join)
        before = _count_nodes(root)
        opt, report = P.optimizer.optimize(root, db)
        l, r = opt.children[0].children
        return before, _count_nodes(opt), l is r, report.notes()
    ref, port = both(scenario)
    assert port == ref
    assert port[:3] == (6, 4, True)
    assert any("cse" in n for n in port[3])


def test_cse_shares_mask_and_cluster_scan(dbs):
    def scenario(P):
        dag = P.Engine(dbs[P.name]).optimized_plan(P.m2bench.q_g4())
        scans, seen = [], set()

        def walk(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, P.physical.ScanTable) and n.name == "Customer":
                scans.append(n.describe())
            for c in n.children:
                walk(c)
        walk(dag)
        return P.physical.explain(dag), scans
    ref, port = both(scenario)
    assert port == ref
    assert "^shared:" in port[0] and len(port[1]) == 1


def test_selection_sinks_below_joins_into_scan(dbs):
    def scenario(P):
        db = dbs[P.name]
        naive = P.Engine(db, mode="dual").physical_plan(P.m2bench.q_g2())
        naive_text = P.physical.explain(naive)
        opt, report = P.optimizer.optimize(naive, db)
        r_naive = P.physical.execute(naive, P.ExecContext(db))
        r_opt = P.physical.execute(opt, P.ExecContext(db))
        assert rows_multiset(r_naive) == rows_multiset(r_opt)
        return (naive_text, P.physical.explain(opt), report.notes(),
                P.fingerprint(r_opt))
    ref, port = both(scenario)
    assert port == ref
    naive_text, rendered, notes, _ = port
    assert "Residual" in naive_text and "Residual" not in rendered
    assert "Select[Orders.shipping.days <= 3]" in rendered
    assert any("sink-down" in n for n in notes)


def _wide_key_db(P, n_tbl=20_000, n_v=40, key_dom=20_000):
    S, Q = P.storage, P.schema
    rng = np.random.default_rng(0)
    db = S.Database()
    persons = S.Table("P", {"pid": np.arange(n_v, dtype=np.int64)})
    tags = S.Table("T", {"tid": np.arange(8, dtype=np.int64)})
    edges = S.Table("E", {"svid": rng.integers(0, n_v, 200).astype(np.int64),
                          "tvid": rng.integers(0, 8, 200).astype(np.int64)})
    db.add_graph(S.Graph("G", {"P": persons, "T": tags}, edges, "P", "T"))
    db.add_table(S.Table("C", {
        "id": np.arange(n_tbl, dtype=np.int64),
        "person_id": rng.integers(0, key_dom, n_tbl).astype(np.int64)}))
    q = Q.Query(select=("C.id", "t.tid"), froms=("C",),
                match=Q.chain_pattern("G", ("p", "P", "E", "t", "T")),
                joins=(Q.JoinPred("C.person_id", "p.pid"),))
    return db, q


def test_semi_join_sides_onto_the_table_when_vertices_are_small():
    def scenario(P):
        db, q = _wide_key_db(P)
        eng = P.Engine(db)
        rendered = P.physical.explain(eng.optimized_plan(q))
        notes = eng.last_report.notes()
        naive = P.Engine(db, enable_optimizer=False).query(q)
        opt = eng.query(q)
        assert rows_multiset(naive) == rows_multiset(opt)
        return rendered, notes, P.fingerprint(opt), op_summary(eng.last_stats)
    ref, port = both(scenario)
    assert port == ref
    rendered, notes, _, ops = port
    assert "SemiJoinReduce[person_id ∈ P.pid]" in rendered
    assert any("table-side reduce" in n for n in notes)
    reduce_ops = [o for o in ops if o["op"] == "SemiJoinReduce"]
    assert reduce_ops and reduce_ops[0]["rows"] < 20_000 / 100


CHECKED_KINDS = ("ScanTable", "Select", "MatchPattern", "EquiJoin",
                 "GraphProject", "Project", "VertexScan", "EdgeScan")


def test_est_rows_within_bounded_q_error(dbs):
    def scenario(P):
        out = []
        for qname in ("q_g1", "q_g2", "q_g4", "q_opt_skew", "q_vertex_scan",
                      "q_edge_scan"):
            eng = P.Engine(dbs[P.name])
            eng.query(getattr(P.m2bench, qname)())
            ests = eng.last_ests

            def walk(n, seen):
                if id(n) in seen:
                    return
                seen.add(id(n))
                if n.kind in CHECKED_KINDS and n.stats.executed \
                        and n.stats.rows and id(n) in ests:
                    est = ests[id(n)][0]
                    qerr = max(est / n.stats.rows,
                               n.stats.rows / max(est, 1e-9))
                    out.append((qname, n.describe(), est, n.stats.rows, qerr))
                for c in n.children:
                    walk(c, seen)
            walk(eng.last_dag, set())
        return out
    ref, port = both(scenario)
    assert port == ref
    assert max(r[-1] for r in port) < 16.0


def test_root_estimate_close_on_g1(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        r = eng.query(P.m2bench.q_g1())
        return eng.last_ests[id(eng.last_dag)][0], r.nrows
    ref, port = both(scenario)
    assert port == ref
    assert 0.5 <= port[0] / port[1] <= 2.0


def _selectivities(P, stats, preds):
    return [stats.selectivity(P.schema.Predicate(*p)) for p in preds]


def test_dict_column_equality_selectivity_is_value_exact():
    preds = [("t.x", "==", "a"), ("t.x", "==", "c"), ("t.x", "==", "nope"),
             ("t.x", "in", ["b", "c"])]

    def scenario(P):
        s = P.storage.compute_stats(P.storage.DictColumn(
            values=["a"] * 90 + ["b"] * 9 + ["c"]))
        return s.ndv, _selectivities(P, s, preds)
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == 3
    assert port[1] == pytest.approx([0.9, 0.01, 0.0, 0.1])


def test_histogram_range_selectivity():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(0, 1, 9000), rng.uniform(9, 10, 1000)])
    ref, port = both(lambda P: _selectivities(
        P, P.storage.compute_stats(vals),
        [("t.x", "range", 0.0, 1.0), ("t.x", ">", 9.0)]))
    assert port == ref
    assert 0.8 <= port[0] <= 1.0 and 0.05 <= port[1] <= 0.15


def _stats_graph(P):
    S = P.storage
    vt = S.Table("A", {"v": np.arange(10, dtype=np.float64),
                       "tag": S.DictColumn(values=[("x", "y")[i % 2]
                                                   for i in range(10)])})
    edges = S.Table("E", {"svid": np.arange(10, dtype=np.int64) % 5,
                          "tvid": np.arange(10, dtype=np.int64) % 7})
    return S.Graph("G", {"A": vt}, edges, "A", "A",
                   delta_config=P.deltastore.DeltaConfig(auto_compact=False))


def test_stats_maintained_across_delta_appends():
    def scenario(P):
        g = _stats_graph(P)
        g.insert_vertices("A", {"v": np.array([500.0, 600.0]),
                                "tag": ["z", "x"]})
        vt = g.vertex_tables["A"]
        sv, st = vt.stats("v"), vt.stats("tag")
        return (sv.n, sv.vmax, sv.hist.tolist(), st.n,
                dict(st.value_counts),
                _selectivities(P, st, [("A.tag", "==", "z")]))
    ref, port = both(scenario)
    assert port == ref
    n, vmax, hist, nt, counts, sel = port
    assert n == 12 and vmax == 600.0 and sum(hist) == pytest.approx(12)
    assert nt == 12 and counts["z"] == 1 and sel[0] == pytest.approx(1 / 12)


def test_live_edge_stats_consistent_with_pending_delta():
    def scenario(P):
        g = _stats_graph(P)
        seen = [(g.n_live_edges, g.avg_out_degree, g.hop_expansion())]
        g.insert_edges({"svid": np.array([0, 1]), "tvid": np.array([2, 3])})
        seen.append((g.n_live_edges, g.avg_out_degree, g.hop_expansion()))
        g.delete_edges(np.array([0, 1, 2]))
        seen.append((g.n_live_edges, g.hop_expansion(reverse=True)))
        g.insert_vertices("A", {"v": np.array([11.0]), "tag": ["x"]})
        seen.append((g.hop_expansion(),))
        return seen
    ref, port = both(scenario)
    assert port == ref
    e0 = port[0][0]
    assert port[0][2] == pytest.approx(e0 / 10)
    assert port[1][0] == e0 + 2
    assert port[1][1] == pytest.approx((e0 + 2) / 10) != port[0][1]
    assert port[2] == (e0 - 1, pytest.approx((e0 - 1) / 10))
    assert port[3][0] == pytest.approx((e0 - 1) / 11)


def test_admission_bypasses_cheap_bulky_entries():
    def scenario(P, big):
        buf = P.interbuffer.InterBuffer(capacity_bytes=1 << 20,
                                        admit_cost_per_byte=1.0,
                                        **({"device": "cpu"} if P is PORT
                                           else {}))
        assert buf.put("cheap", big, est_cost=10.0) is not None
        seen = [(len(buf), buf.bypasses)]
        buf.put("costly", big, est_cost=1e9)
        seen.append((len(buf), buf.get("costly") is not None))
        buf.put("unknown", big)
        seen.append((len(buf), buf.bypasses, buf.hits))
        return seen
    big = np.ones((4096,), np.float32)          # 16 KiB
    ref, port = both(scenario, big)
    assert port == ref
    assert port == [(0, 1), (1, True), (2, 1, 1)]
    # a tensor of the same size is sized alike
    assert scenario(PORT, torch.ones(4096)) == port


def test_engine_admission_threshold_bypasses_and_counts():
    def scenario(P):
        eng = P.Engine(P.m2bench.generate(sf=1), admit_cost_per_byte=1e12)
        t = P.schema.GCDIATask(
            integration=P.m2bench.q_g1(),
            analytics=P.schema.AnalyticsTask(
                "MULTIPLY", [("rel2matrix", ("Customer.id", "t.tid"))]))
        eng.analyze(t)
        first = (len(eng.interbuffer), eng.interbuffer.bypasses)
        eng.analyze(t)
        return first, eng.interbuffer.hits, eng.interbuffer.bypasses, \
            untimed(eng.explain_last())
    ref, port = both(scenario)
    assert port == ref
    (entries, bypasses), hits, _, text = port
    assert entries == 0 and bypasses > 0 and hits == 0
    assert "bypasses=" in text


def test_default_admission_keeps_expensive_gcdi_reuse():
    def scenario(P):
        eng = P.Engine(P.m2bench.generate(sf=1))
        t = P.schema.GCDIATask(
            integration=P.m2bench.q_g1(),
            analytics=P.schema.AnalyticsTask(
                "SIMILARITY", [("random", "Customer.id", "t.tid",
                                P.m2bench.N_TAGS)]))
        eng.analyze(t)
        bypasses = eng.interbuffer.bypasses
        eng.analyze(t)
        return bypasses, eng.last_stats.interbuffer_hit
    ref, port = both(scenario)
    assert port == ref == (0, True)
