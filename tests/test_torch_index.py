"""Twin of ``tests/test_index.py`` and ``tests/test_oracle_equivalence.py``:
the port's secondary indexes return the same postings as the JAX
package's (and as full scans) under the same mutation streams, refresh and
rebuild at the same moments, lead the optimizer to the same access paths
with the same ``traversal.COUNTERS``, and its vectorized matcher equals the
paper's pseudocode on the same random instances, with the same counters."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from test_oracle_equivalence import paper_match, small_instance
from torch_twin import PKGS, both, rows_multiset, untimed


def _mk_graph_db(P, n_vertices=3000, n_edges=9000, seed=0, name="G"):
    S = P.storage
    rng = np.random.default_rng(seed)
    verts = S.Table("V", {
        "vid": np.arange(n_vertices, dtype=np.int64),
        "attr": rng.integers(0, 50, n_vertices),
        "kind": S.DictColumn(values=[("a", "b", "c")[i % 3]
                                     for i in range(n_vertices)]),
    })
    edges = S.Table("E", {
        "svid": rng.integers(0, n_vertices, n_edges).astype(np.int64),
        "tvid": rng.integers(0, n_vertices, n_edges).astype(np.int64),
        "w": rng.uniform(0, 1, n_edges),
    })
    g = S.Graph(name, {"V": verts}, edges, "V", "V")
    db = S.Database()
    db.add_graph(g)
    return db, g


def _scan_rows(tbl, pred):
    return np.nonzero(tbl.eval_predicate(pred))[0]


def _lookups(P, im, preds, label=None):
    out = []
    for p in preds:
        got = im.lookup("G", P.schema.Predicate(*p), label=label)
        out.append(None if got is None else np.sort(got).tolist())
    return out


SORTED_PREDS = [("v.attr", "==", 7), ("v.attr", "in", (3, 5, 49)),
                ("v.attr", "range", 10, 20), ("v.attr", "<", 5),
                ("v.attr", "<=", 5), ("v.attr", ">", 44), ("v.attr", ">=", 44)]


def test_sorted_index_matches_scans_on_every_op():
    def scenario(P):
        db, g = _mk_graph_db(P)
        db.indexes.create("G", "attr", label="V")
        got = _lookups(P, db.indexes, SORTED_PREDS, label="V")
        tbl = g.vertex_tables["V"]
        assert got == [_scan_rows(tbl, P.schema.Predicate(*p)).tolist()
                       for p in SORTED_PREDS]
        return got
    ref, port = both(scenario)
    assert port == ref


def test_hash_index_matches_scans_and_misses_cleanly():
    preds = [("v.kind", "==", "b"), ("v.kind", "in", ("a", "c")),
             ("v.kind", "==", "zzz"), ("v.kind", ">", "a")]

    def scenario(P):
        db, g = _mk_graph_db(P)
        idx = db.indexes.create("G", "kind", label="V")
        got = _lookups(P, db.indexes, preds, label="V")
        tbl = g.vertex_tables["V"]
        for p, rows in zip(preds[:2], got[:2]):
            assert rows == _scan_rows(tbl, P.schema.Predicate(*p)).tolist()
        return idx.kind, got
    ref, port = both(scenario)
    assert port == ref
    kind, got = port
    assert kind == "hash" and got[2] == [] and got[3] is None


def test_table_index_and_unsupported_column():
    def scenario(P):
        S, Pr = P.storage, P.schema.Predicate
        db = S.Database()
        db.add_table(S.Table("T", {"k": np.arange(100, dtype=np.int64),
                                   "s": S.DictColumn(values=[
                                       str(i % 7) for i in range(100)])}))
        im = db.indexes
        im.create("T", "k")
        rows = np.sort(im.lookup("T", Pr("T.k", "range", 10, 19))).tolist()
        for kind in ("sorted", "zone"):
            with pytest.raises(ValueError):
                im.create("T", "s", kind=kind)
        return rows, im.lookup("T", Pr("T.missing_kind", "==", 1))
    ref, port = both(scenario)
    assert port == ref == (list(range(10, 20)), None)


def test_zone_maps_prune_clustered_and_handle_nan():
    def scenario(P):
        ZoneMap, Pr = P.index.ZoneMap, P.schema.Predicate
        vals = np.arange(10_000, dtype=np.float64)
        zm = ZoneMap(vals, chunk=1024)
        p = Pr("T.x", "range", 2000, 2100)
        out = [zm.candidate_chunks(p).tolist(), zm.fraction(p),
               zm.masked_eval(vals, p).tolist(),
               zm.matching_rows(vals, p).tolist()]
        vals2 = vals.copy()
        vals2[:1024] = np.nan
        zm2 = ZoneMap(vals2, chunk=1024)
        p2 = Pr("T.x", "<", 5000)
        out += [zm2.candidate_chunks(p2).tolist(),
                zm2.masked_eval(vals2, p2).tolist()]
        return out
    ref, port = both(scenario)
    assert port == ref
    cand, frac, masked, rows, cand2, masked2 = port
    vals = np.arange(10_000, dtype=np.float64)
    assert sum(cand) <= 2 and 0.0 < frac < 0.3
    assert masked == ((vals >= 2000) & (vals <= 2100)).tolist()
    assert rows == list(range(2000, 2101))
    assert not cand2[0] and sum(masked2) == 5000 - 1024


def test_zone_map_extend_absorbs_partial_chunks():
    def scenario(P):
        zm = P.index.ZoneMap(np.arange(1500, dtype=np.float64), chunk=1024)
        zm.extend(np.arange(1500, 2600, dtype=np.float64))
        vals = np.arange(2600, dtype=np.float64)
        return zm.n, zm.n_chunks, zm.matching_rows(
            vals, P.schema.Predicate("T.x", ">=", 2550)).tolist()
    ref, port = both(scenario)
    assert port == ref == (2600, 3, list(range(2550, 2600)))


@st.composite
def mutation_script(draw):
    ops = []
    for _ in range(draw(st.integers(3, 7))):
        kind = draw(st.sampled_from(("verts", "edges", "delete", "compact")))
        ops.append((kind, draw(st.integers(1, 60)), draw(st.integers(0, 10**6))))
    return ops


def _mutate_and_look_up(P, ops):
    db, g = _mk_graph_db(P, n_vertices=400, n_edges=1200)
    im = db.indexes
    idxs = [im.create("G", "attr", label="V"), im.create("G", "kind", label="V"),
            im.create("G", "w")]
    Pr = P.schema.Predicate
    pv, pk = Pr("v.attr", "range", 10, 30), Pr("v.kind", "==", "b")
    pe = Pr("e.w", ">", 0.8)
    trace = []
    for kind, size, seed in ops:
        rng = np.random.default_rng(seed)
        if kind == "verts":
            n0 = g.vertex_tables["V"].nrows
            g.insert_vertices("V", {
                "vid": np.arange(n0, n0 + size, dtype=np.int64),
                "attr": rng.integers(0, 50, size),
                "kind": [("a", "b", "c")[i % 3] for i in range(size)]})
        elif kind == "edges":
            n = g.vertex_tables["V"].nrows
            g.insert_edges({"svid": rng.integers(0, n, size).astype(np.int64),
                            "tvid": rng.integers(0, n, size).astype(np.int64),
                            "w": rng.uniform(0, 1, size)})
        elif kind == "delete":
            g.delete_edges(rng.integers(0, g.edges.nrows, size))
        else:
            g.compact()
        vt = g.vertex_tables["V"]
        got_v = np.sort(im.lookup("G", pv, label="V"))
        got_k = np.sort(im.lookup("G", pk, label="V"))
        got_e = np.sort(im.lookup("G", pe))
        assert np.array_equal(got_v, _scan_rows(vt, pv))
        assert np.array_equal(got_k, _scan_rows(vt, pk))
        live = _scan_rows(g.edges, pe)
        assert np.array_equal(got_e, live[g.live_edge_mask()[live]])
        trace.append((got_v.tolist(), got_k.tolist(), got_e.tolist(),
                      db.epoch_of("G"),
                      [(i.refreshes, i.rebuilds) for i in idxs]))
    return trace


@settings(max_examples=20, deadline=None)
@given(mutation_script())
def test_index_equals_scan_under_random_mutations(ops):
    ref, port = both(_mutate_and_look_up, ops)
    assert port == ref


def test_maintenance_is_incremental_and_rebuilds_only_at_compact():
    def scenario(P):
        db, g = _mk_graph_db(P)
        im = db.indexes
        idx = im.create("G", "attr", label="V")
        p = P.schema.Predicate("v.attr", "==", 11)
        im.lookup("G", p, label="V")
        seen = [(idx.refreshes, idx.rebuilds)]
        n0 = g.vertex_tables["V"].nrows
        g.insert_vertices("V", {"vid": np.arange(n0, n0 + 10, dtype=np.int64),
                                "attr": np.full(10, 11), "kind": ["a"] * 10})
        got = np.sort(im.lookup("G", p, label="V"))
        seen.append((idx.refreshes, idx.rebuilds,
                     set(range(n0, n0 + 10)) <= set(got.tolist())))
        g.compact()
        got = np.sort(im.lookup("G", p, label="V"))
        assert np.array_equal(got, _scan_rows(g.vertex_tables["V"], p))
        seen.append((idx.rebuilds,))
        n1 = g.vertex_tables["V"].nrows
        g.insert_vertices("V", {"vid": np.array([n1]), "attr": np.array([11]),
                                "kind": ["b"]})
        got = np.sort(im.lookup("G", p, label="V"))
        assert np.array_equal(got, _scan_rows(g.vertex_tables["V"], p))
        seen.append((idx.rebuilds, got.tolist()))
        return seen
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == (0, 0) and port[1] == (1, 0, True)
    assert port[2] == (0,) and port[3][0] == 1


def test_stale_epoch_is_refreshed_not_reused():
    def scenario(P):
        db, g = _mk_graph_db(P)
        idx = db.indexes.create("G", "attr", label="V")
        stamped = idx.epoch
        n0 = g.vertex_tables["V"].nrows
        g.insert_vertices("V", {"vid": np.array([n0]), "attr": np.array([49]),
                                "kind": ["c"]})
        bumped = db.epoch_of("G") != stamped
        rows = db.indexes.lookup("G", P.schema.Predicate("v.attr", "==", 49),
                                 label="V")
        return bumped, n0 in rows.tolist(), idx.epoch == db.epoch_of("G"), \
            idx.epoch
    ref, port = both(scenario)
    assert port == ref
    assert port[:3] == (True, True, True)


def test_table_replacement_rebuilds():
    def scenario(P):
        S = P.storage
        db = S.Database()
        db.add_table(S.Table("T", {"k": np.arange(50, dtype=np.int64)}))
        idx = db.indexes.create("T", "k")
        db.add_table(S.Table("T", {"k": np.arange(50, 100, dtype=np.int64)}))
        rows = db.indexes.lookup("T", P.schema.Predicate("T.k", "==", 75))
        return rows.tolist(), idx.rebuilds
    ref, port = both(scenario)
    assert port == ref == ([25], 1)


def test_tombstoned_edges_filtered_from_postings():
    def scenario(P):
        db, g = _mk_graph_db(P)
        p = P.schema.Predicate("e.w", ">=", 0.0)
        db.indexes.create("G", "w")
        before = db.indexes.lookup("G", p)
        g.delete_edges(np.array([0, 1, 2]))
        return len(before), sorted(db.indexes.lookup("G", p).tolist())
    ref, port = both(scenario)
    assert port == ref
    n_before, after = port
    assert len(after) == n_before - 3 and not ({0, 1, 2} & set(after))


# ---------------------------------------------------------------------------
# access-path selection, with traversal.COUNTERS parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dbs():
    """Per package: (plain db, indexed db) — identical m2bench content."""
    out = {}
    for P in PKGS:
        indexed = P.m2bench.generate(sf=1)
        P.m2bench.build_indexes(indexed)
        out[P.name] = (P.m2bench.generate(sf=1), indexed)
    return out


def _point_query(P, db):
    return P.m2bench.q_point_lookup(*P.m2bench.point_lookup_keys(db))


def _run(P, eng, q):
    r = eng.query(q)
    c = P.traversal.COUNTERS
    return {"fingerprint": P.fingerprint(r), "rows": rows_multiset(r),
            "counters": (c.record_fetches, c.cpu_ops),
            "stats": (eng.last_stats.record_fetches, eng.last_stats.cpu_ops),
            "rewrites": list(eng.last_stats.rewrites),
            "explain": untimed(eng.explain_last())}


def test_optimizer_picks_index_scan_and_reports_access(dbs):
    ref, port = both(lambda P: _run(P, P.Engine(dbs[P.name][1]),
                                    _point_query(P, dbs[P.name][1])))
    assert port == ref
    out = port["explain"]
    assert "IndexScan[Customer" in out and "access=sorted" in out
    assert "IndexSelect[Orders" in out and "access=zone" in out
    assert "access=index-seed[p]" in out
    assert any(n.startswith("access-path") for n in port["rewrites"])


def test_unservable_predicate_stays_full_scan(dbs):
    def scenario(P):
        Q = P.schema
        q = Q.Query(select=("Customer.id",), froms=("Customer",), joins=(),
                    where=(Q.Predicate("Customer.person_id", "!=", 3),))
        return _run(P, P.Engine(dbs[P.name][1]), q)
    ref, port = both(scenario)
    assert port == ref
    assert "IndexScan" not in port["explain"]
    assert "access=full-scan" in port["explain"]


def test_index_and_fullscan_agree_on_fixture_queries(dbs):
    def scenario(P):
        plain, indexed = dbs[P.name]
        out = []
        for q in (_point_query(P, indexed), P.m2bench.q_range_narrow(),
                  P.m2bench.q_g1(), P.m2bench.q_g4()):
            a = _run(P, P.Engine(plain), q)
            b = _run(P, P.Engine(indexed), q)
            assert a["rows"] == b["rows"]
            out.append((a, b))
        return out
    ref, port = both(scenario)
    assert port == ref


def test_index_seeding_reduces_record_fetches(dbs):
    def scenario(P):
        plain, indexed = dbs[P.name]
        q = _point_query(P, indexed)
        return (_run(P, P.Engine(plain), q)["counters"],
                _run(P, P.Engine(indexed), q)["counters"])
    ref, port = both(scenario)
    assert port == ref
    (io_plain, _), (io_idx, _) = port
    assert io_idx < io_plain / 5, (io_idx, io_plain)


def test_index_scan_falls_back_when_index_dropped(dbs):
    def scenario(P):
        indexed = dbs[P.name][1]
        q = _point_query(P, indexed)
        eng = P.Engine(indexed)
        want = rows_multiset(eng.query(q))
        dag = eng.optimized_plan(q)
        im = indexed.indexes
        im.drop("Customer", "person_id")
        im.drop("Orders", "order_id")
        try:
            got = P.physical.execute(dag, P.ExecContext(indexed))
        finally:
            im.create("Customer", "person_id")
            im.create("Orders", "order_id", kind="zone")
        assert rows_multiset(got) == want
        return P.fingerprint(got)
    ref, port = both(scenario)
    assert port == ref


def test_estimates_cover_index_operators(dbs):
    def scenario(P):
        indexed = dbs[P.name][1]
        dag = P.Engine(indexed).optimized_plan(_point_query(P, indexed))
        ests = P.physical.estimate(dag, indexed)
        assert all(np.isfinite(r + c) and r >= 0 and c >= 0
                   for r, c in ests.values())
        return P.physical.explain(dag, db=indexed)
    ref, port = both(scenario)
    assert port == ref
    assert "IndexScan" in port and "IndexSelect" in port


def test_small_labels_skip_the_index_machinery(dbs):
    ref, port = both(lambda P: _run(P, P.Engine(dbs[P.name][1]),
                                    P.m2bench.q_range_narrow()))
    assert port == ref
    assert "access=mask-scan" in port["explain"]


# ---------------------------------------------------------------------------
# the vectorized matcher against the paper's pseudocode
# ---------------------------------------------------------------------------


def _graph(P, n_a, svid, tvid, attr_a, attr_b, w, homogeneous):
    S = P.storage
    A = S.Table("A", {"attr": attr_a})
    E = S.Table("E", {"svid": svid, "tvid": tvid, "w": w})
    if homogeneous:
        return S.Graph("G", {"A": A}, E, "A", "A")
    return S.Graph("G", {"A": A, "B": S.Table("B", {"attr": attr_b})}, E,
                   "A", "B")


def _matched(P, g, hops, phi):
    pattern = P.schema.chain_pattern("G", *hops)
    phi = {v: [P.schema.Predicate(*p)] for v, p in phi.items()}
    P.traversal.COUNTERS.reset()
    plan = P.pattern.plan_pattern(g, pattern, phi, projected=set())
    rel = P.pattern.match(g, plan)
    c = P.traversal.COUNTERS
    chain = [pattern.vertices[0].var] + [e.dst for e in pattern.edges]
    evars = [e.var for e in pattern.edges]
    rows = sorted(
        tuple(g.nid_of(pattern.vertex(v).label, np.asarray(rel.col(v))[i])
              for v in chain)
        + tuple(int(np.asarray(rel.col(e))[i]) for e in evars)
        for i in range(rel.nrows))
    assert rows == sorted(paper_match(g, pattern, phi))
    return rows, (c.record_fetches, c.cpu_ops), repr(plan)


@given(small_instance(),
       st.sampled_from([None, 0, 1, 2]), st.sampled_from([None, 0, 1, 2]),
       st.sampled_from([None, 3, 7]))
@settings(max_examples=40, deadline=None)
def test_match_equals_paper_pseudocode(inst, pa, pb, pe):
    n_a, n_b, svid, tvid, attr_a, attr_b, w = inst
    phi = {}
    if pa is not None:
        phi["x"] = ("x.attr", "==", pa)
    if pb is not None:
        phi["y"] = ("y.attr", "==", pb)
    if pe is not None:
        phi["e0"] = ("e0.w", "<=", pe)
    ref, port = both(lambda P: _matched(
        P, _graph(P, n_a, svid, tvid, attr_a, attr_b, w, False),
        (("x", "A", "E", "y", "B"),), phi))
    assert port == ref


@given(small_instance(), st.integers(0, 2))
@settings(max_examples=20, deadline=None)
def test_two_hop_homogeneous(inst, pred_val):
    n_a, _, svid, tvid, attr_a, _, w = inst
    ref, port = both(lambda P: _matched(
        P, _graph(P, n_a, svid % n_a, tvid % n_a, attr_a, None, w, True),
        (("x", "A", "E", "y", "A"), ("y", "A", "E", "z", "A")),
        {"x": ("x.attr", "==", pred_val)}))
    assert port == ref
