"""Twin of ``tests/test_storage.py`` and ``tests/test_deltastore.py``: the
port's storage and delta store evolve exactly as the JAX package's under the
same insert, tombstone and ``compact()`` streams — compared step by step
(delta statistics, epochs, write counters, merged columns, live masks,
match results) — its base ⊕ delta reads equal a from-scratch rebuild, and
its epoch-keyed inter-buffer invalidates alike."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_twin import PORT, REF, both, host


# ---------------------------------------------------------------------------
# storage: CSR, shredding, columns, statistics
# ---------------------------------------------------------------------------


def _csr(P, n, src, dst, frontier):
    csr = P.storage.build_csr(n, src, dst)
    s_rep, d, eid = csr.neighbors(frontier)
    return ((csr.n_vertices, csr.n_edges), csr.row_ptr.tolist(),
            csr.col_idx.tolist(), csr.edge_id.tolist(),
            (s_rep.tolist(), d.tolist(), eid.tolist()),
            str(csr.row_ptr.dtype), str(csr.col_idx.dtype))


@given(st.integers(2, 30), st.integers(0, 60), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=50, deadline=None)
def test_csr_matches_edge_list(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ref, port = both(_csr, n, src, dst, np.arange(n))
    assert port == ref
    _, row_ptr, col_idx, edge_id, _, _, _ = port
    for v in range(n):
        assert sorted(col_idx[row_ptr[v]:row_ptr[v + 1]]) == \
            sorted(dst[src == v])
        for slot in range(row_ptr[v], row_ptr[v + 1]):
            assert src[edge_id[slot]] == v and dst[edge_id[slot]] == \
                col_idx[slot]


@given(st.integers(1, 20), st.integers(0, 40), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=30, deadline=None)
def test_frontier_expansion(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    frontier = rng.integers(0, n, min(n, 5))
    ref, port = both(_csr, n, src, dst, frontier)
    assert port == ref
    s_rep, d, _ = port[4]
    expect = [(f, x) for f in frontier for x in sorted(dst[src == f])]
    assert sorted(zip(s_rep, d)) == sorted(expect)


def _table_view(t):
    out = {}
    for name in sorted(t.columns):
        c = t.col(name)
        kind = type(c).__name__
        if hasattr(c, "codes"):
            out[name] = (kind, c.codes.tolist(), list(c.vocab))
        elif hasattr(c, "offsets"):
            out[name] = (kind, np.asarray(c.values).tolist(),
                         np.asarray(c.offsets).tolist())
        else:
            a = np.asarray(c)
            out[name] = (kind, str(a.dtype),
                         [None if x != x else x for x in a.tolist()])
    return out


def test_doc_shredding_paths_and_ragged():
    docs = [{"a": 1, "b": {"c": "x", "d": 2.5}, "tags": [1, 2]},
            {"a": 2, "b": {"c": "y"}, "tags": []},
            {"a": 3, "tags": [7]}]
    ref, port = both(lambda P: _table_view(P.storage.shred_documents("D",
                                                                     docs)))
    assert port == ref
    assert set(port) == {"a", "b.c", "b.d", "tags"}
    assert port["b.c"][0] == "DictColumn" and port["tags"][0] == "RaggedColumn"
    assert port["b.d"][2][2] is None                  # absent path -> NaN


def test_ragged_predicate_any_semantics():
    ref, port = both(lambda P: P.storage.shred_documents(
        "D", [{"xs": [1, 5]}, {"xs": [2]}, {"xs": []}]).eval_predicate(
        P.schema.Predicate("D.xs", ">=", 5)).tolist())
    assert port == ref == [True, False, False]


def test_dict_column_roundtrip_and_append():
    def scenario(P):
        D = P.storage.DictColumn
        c = D(values=["b", "a", "b", "c"])
        taken = c.take(np.array([0, 3]))
        c3 = D(values=["b", "a", "b"])
        c4 = c3.append(["a", "zz", "b", "zz"])
        return (list(c.decode(c.codes)), c.encode("zzz"),
                list(taken.decode(taken.codes)), c4.codes.tolist(),
                list(c4.vocab), c3.encode("zz"))
    ref, port = both(scenario)
    assert port == ref
    assert port[:3] == (["b", "a", "b", "c"], -1, ["b", "c"])
    assert len(port[4]) == 3 and port[5] == -1


def test_ragged_take_and_predicates_on_empty_rows():
    def scenario(P):
        R, Pr = P.storage.RaggedColumn, P.schema.Predicate
        r = R(lists=[[1, 2], [], [3, 4, 5]])
        t = r.take(np.array([2, 0]))
        r2 = R(lists=[[1, 2], [], [5]])
        empty = r2.take(np.array([], dtype=np.int64))
        dup = r2.take(np.array([1, 1]))
        tbl = P.storage.Table("D", {"xs": R(lists=[[], [], []])})
        tbl2 = P.storage.Table("D", {"xs": r2})
        return ([t.row(0).tolist(), t.row(1).tolist()],
                (len(empty), len(empty.values)), dup.lengths().tolist(),
                tbl.eval_predicate(Pr("D.xs", ">=", 0)).tolist(),
                tbl2.eval_predicate(Pr("D.xs", "==", 5)).tolist())
    ref, port = both(scenario)
    assert port == ref
    assert port == ([[3, 4, 5], [1, 2]], (0, 0), [0, 0],
                    [False] * 3, [False, False, True])


def test_selectivity_estimates():
    def scenario(P):
        s = P.storage.Table("T", {"x": np.arange(100)}).stats("x")
        Pr = P.schema.Predicate
        return (s.selectivity(Pr("T.x", "==", 5)),
                s.selectivity(Pr("T.x", "range", 0, 49)))
    ref, port = both(scenario)
    assert port == ref
    assert abs(port[0] - 0.01) < 1e-9 and 0.4 < port[1] < 0.6


# ---------------------------------------------------------------------------
# the delta store: the reference's mutation script, step by step
# ---------------------------------------------------------------------------


def _mk_tables(seed=0, n_a=15, n_b=8, n_e=60):
    rng = np.random.default_rng(seed)
    A = {"attr": rng.integers(0, 3, n_a),
         "tag": [("x", "y", "z")[i % 3] for i in range(n_a)]}
    B = {"attr": rng.integers(0, 3, n_b)}
    E = {"svid": rng.integers(0, n_a, n_e).astype(np.int64),
         "tvid": rng.integers(0, n_b, n_e).astype(np.int64),
         "w": rng.integers(0, 10, n_e).astype(np.int64)}
    return A, B, E


def _graph_from(P, A, B, E, cfg=None):
    S = P.storage
    return S.Graph("G",
                   {"A": S.Table("A", {"attr": np.asarray(A["attr"]),
                                       "tag": S.DictColumn(
                                           values=list(A["tag"]))}),
                    "B": S.Table("B", {"attr": np.asarray(B["attr"])})},
                   S.Table("E", {k: np.asarray(v) for k, v in E.items()}),
                   "A", "B", delta_config=cfg)


def _no_compact(P):
    return P.deltastore.DeltaConfig(auto_compact=False)


def _match_rows(P, g, phi=None):
    pattern = P.schema.chain_pattern("G", ("x", "A", "E", "y", "B"))
    phi = {k: [P.schema.Predicate(*p) for p in v]
           for k, v in (phi or {}).items()}
    rel = P.pattern.match(g, P.pattern.plan_pattern(g, pattern, phi,
                                                    projected=set()))
    w = np.asarray(g.edges.col("w"))[np.asarray(rel.col("e0"))]
    return sorted(zip(np.asarray(rel.col("x")).tolist(),
                      np.asarray(rel.col("y")).tolist(), w.tolist()))


def _graph_state(P, g):
    """Everything a write can change, as plain values."""
    c = g.write_counters
    return {"epoch": g.epoch, "delta": g.delta.stats(),
            "pending": g.delta.has_pending(), "n_live": g.n_live_edges,
            "n_vertices": g.n_vertices, "compactions": g.compactions,
            "counters": (c.write_batches, c.write_rows, c.write_ops,
                         c.compactions, c.compact_ops),
            "live_mask": g.live_edge_mask().tolist(),
            "edges": _table_view(g.edges),
            "vertices": {l: _table_view(g.vertex_tables[l]) for l in g.labels},
            "fwd": (g.fwd.row_ptr.tolist(), g.fwd.col_idx.tolist()),
            "match": _match_rows(P, g)}


SCRIPT = [
    ("ins_e", {"svid": np.array([0, 1, 2, 14]), "tvid": np.array([7, 0, 3, 1]),
               "w": np.array([11, 12, 13, 14])}),
    ("del_e", np.array([0, 5, 9, 61])),
    ("ins_vA", {"attr": np.array([1, 2]), "tag": ["q", "x"]}),
    ("ins_vB", {"attr": np.array([0])}),
    ("ins_e", {"svid": np.array([15, 16, 3]), "tvid": np.array([8, 8, 2]),
               "w": np.array([20, 21, 22])}),
    ("del_e", np.array([64])),
    ("compact", None),
    ("ins_e", {"svid": np.array([4]), "tvid": np.array([4]),
               "w": np.array([30])}),
    ("del_e", np.array([1, 1, 2])),
    ("compact", None),
]


def _apply(g, op, payload):
    if callable(payload):
        payload = payload(g)
    if op == "ins_e":
        g.insert_edges(payload)
    elif op == "del_e":
        g.delete_edges(payload)
    elif op == "ins_vA":
        g.insert_vertices("A", payload)
    elif op == "ins_vB":
        g.insert_vertices("B", payload)
    else:
        g.compact()


def _scripted(P, script, cfg=None):
    g = _graph_from(P, *_mk_tables(), cfg=cfg or _no_compact(P))
    states = [_graph_state(P, g)]
    for op, payload in script:
        _apply(g, op, payload)
        states.append(_graph_state(P, g))
    return states


def test_write_stream_step_by_step():
    ref, port = both(_scripted, SCRIPT)
    assert len(port) == len(SCRIPT) + 1
    for step, (r, t) in enumerate(zip(ref, port)):
        assert t == r, f"after step {step}: {SCRIPT[step - 1][0] if step else 'build'}"


@st.composite
def write_stream(draw):
    ops = []
    for _ in range(draw(st.integers(2, 8))):
        op = draw(st.sampled_from(("ins_e", "del_e", "ins_vA", "ins_vB",
                                   "compact")))
        size = draw(st.integers(1, 6))
        seed = draw(st.integers(0, 10_000))
        ops.append((op, size, seed))
    return ops


def _stream_payloads(ops):
    """Concrete payloads of a drawn stream (vertex ids are kept in range of
    the graph the stream builds: 15 + 2 per A insert, 8 + 1 per B insert)."""
    n_a, n_b = 15, 8
    out = []
    for op, size, seed in ops:
        rng = np.random.default_rng(seed)
        if op == "ins_e":
            out.append((op, {"svid": rng.integers(0, n_a, size),
                             "tvid": rng.integers(0, n_b, size),
                             "w": rng.integers(0, 40, size)}))
        elif op == "del_e":         # tids of the graph as it then stands
            out.append((op, lambda g, seed=seed, size=size:
                        np.random.default_rng(seed).integers(
                            0, g.edges.nrows, size)))
        elif op == "ins_vA":
            out.append((op, {"attr": rng.integers(0, 3, 2),
                             "tag": ["x", "n%d" % seed]}))
            n_a += 2
        elif op == "ins_vB":
            out.append((op, {"attr": rng.integers(0, 3, 1)}))
            n_b += 1
        else:
            out.append((op, None))
    return out


@settings(max_examples=15, deadline=None)
@given(write_stream(), st.booleans())
def test_random_write_streams_step_by_step(ops, auto_compact):
    script = _stream_payloads(ops)

    def run(P):
        cfg = P.deltastore.DeltaConfig(min_delta_edges=4,
                                       max_delta_ratio=0.05) \
            if auto_compact else None
        return _scripted(P, script, cfg)
    ref, port = both(run)
    for step, (r, t) in enumerate(zip(ref, port)):
        assert t == r, f"after step {step}"


def _apply_script(g, script):
    """The reference's oracle bookkeeping: mutate ``g`` and return the
    equivalent from-scratch (A, B, E_live) state."""
    A = {"attr": list(np.asarray(g.vertex_tables["A"].col("attr"))),
         "tag": list(g.vertex_tables["A"].col("tag").decode(
             g.vertex_tables["A"].col("tag").codes))}
    B = {"attr": list(np.asarray(g.vertex_tables["B"].col("attr")))}
    E = {k: list(np.asarray(g.edges.col(k))) for k in ("svid", "tvid", "w")}
    dead: set = set()
    for op, payload in script:
        _apply(g, op, payload)
        if op == "ins_e":
            for k in E:
                E[k].extend(np.asarray(payload[k]).tolist())
        elif op == "del_e":
            dead.update(np.asarray(payload).tolist())
        elif op == "ins_vA":
            A["attr"].extend(np.asarray(payload["attr"]).tolist())
            A["tag"].extend(list(payload["tag"]))
        elif op == "ins_vB":
            B["attr"].extend(np.asarray(payload["attr"]).tolist())
    live = [i for i in range(len(E["svid"])) if i not in dead]
    return A, B, {k: np.asarray(v)[live] for k, v in E.items()}


def _mutated_and_oracle(P):
    g = _graph_from(P, *_mk_tables(), cfg=_no_compact(P))
    oracle = _graph_from(P, *_apply_script(g, SCRIPT[:6]))
    assert g.delta.has_pending()
    return g, oracle


def _lv(g, nids):
    nids = np.asarray(nids)
    return list(zip(g.vertex_label_code[nids].tolist(),
                    g.vertex_vid_of[nids].tolist()))


def _reads(P, g):
    out = {"match": _match_rows(P, g),
           "match_pred": _match_rows(P, g, {"x": [("x.attr", "==", 1)],
                                            "e0": [("e0.w", "<=", 12)]}),
           "match_vocab": _match_rows(P, g, {"y": [("y.attr", "!=", 0)],
                                             "x": [("x.tag", "==", "q")]})}
    for reverse in (False, True):
        s, d, _ = P.traversal.nid_to_nid(g, np.arange(g.n_vertices),
                                         reverse=reverse)
        out[f"hop_{reverse}"] = sorted(zip(_lv(g, s), _lv(g, d)))
    src_vids = np.repeat(np.arange(4), 3)
    dst_vids = np.tile(np.array([0, 3, 8]), 4)
    out["paths"] = P.pattern.shortest_path_lengths(
        g, g.nid_of("A", src_vids), g.nid_of("B", dst_vids)).tolist()
    return out


def test_reads_over_base_and_delta_equal_rebuild():
    """Pattern matches (with predicates and a delta-extended vocabulary),
    traversal in both directions and shortest paths over base ⊕ delta equal
    a from-scratch rebuild, in both packages alike."""
    def scenario(P):
        g, oracle = _mutated_and_oracle(P)
        got, want = _reads(P, g), _reads(P, oracle)
        assert got == want
        return got
    ref, port = both(scenario)
    assert port == ref


def test_compaction_preserves_results_and_resets_delta():
    def scenario(P):
        g, oracle = _mutated_and_oracle(P)
        before, n_live = _match_rows(P, g), g.n_live_edges
        g.compact()
        assert not g.delta.has_pending()
        assert g.edges.nrows == n_live and g.fwd.n_edges == n_live
        assert _match_rows(P, g) == before == _match_rows(P, oracle)
        for lbl in g.labels:
            lo, hi = g.label_range(lbl)
            assert hi - lo == g.vertex_tables[lbl].nrows
        return _graph_state(P, g)
    ref, port = both(scenario)
    assert port == ref


def test_khop_joins_equal_rebuild():
    def scenario(P):
        S = P.storage
        rng = np.random.default_rng(3)
        n, e = 12, 40
        E = {"svid": rng.integers(0, n, e).astype(np.int64),
             "tvid": rng.integers(0, n, e).astype(np.int64),
             "w": rng.integers(0, 5, e).astype(np.int64)}

        def mk(Ed, cfg=None):
            return S.Graph("H", {"A": S.Table("A", {"attr": np.zeros(
                n, np.int64)})}, S.Table("E", {k: np.asarray(v)
                                               for k, v in Ed.items()}),
                "A", "A", delta_config=cfg)
        g = mk(E, _no_compact(P))
        g.insert_edges({"svid": np.array([0, 1]), "tvid": np.array([2, 0]),
                        "w": np.array([9, 9])})
        g.delete_edges(np.array([3, 4, 40]))
        live = [i for i in range(e) if i not in (3, 4)] + [41]
        full = {k: np.append(np.asarray(E[k]), {"svid": [0, 1],
                                                "tvid": [2, 0],
                                                "w": [9, 9]}[k]) for k in E}
        oracle = mk({k: v[live] for k, v in full.items()})
        pat = P.schema.chain_pattern("H", ("x", "A", "E", "y", "A"),
                                     ("y", "A", "E", "z", "A"))

        def rows(gr):
            t = P.engine._match_by_joins(gr, pat)
            w = np.asarray(gr.edges.col("w"))
            return sorted(zip(np.asarray(t.col("x")).tolist(),
                              np.asarray(t.col("y")).tolist(),
                              np.asarray(t.col("z")).tolist(),
                              w[np.asarray(t.col("e0"))].tolist(),
                              w[np.asarray(t.col("e1"))].tolist()))
        got = rows(g)
        assert got == rows(oracle)
        rel = P.pattern.match(g, P.pattern.plan_pattern(g, pat, {},
                                                        projected=set()))
        assert len(rel.columns["x"]) == len(got)
        return got
    ref, port = both(scenario)
    assert port == ref


def test_auto_compaction_triggers():
    def scenario(P):
        cfg = P.deltastore.DeltaConfig(min_delta_edges=8,
                                       max_delta_ratio=0.01)
        g = _graph_from(P, *_mk_tables(), cfg=cfg)
        states = []
        for _ in range(5):
            g.insert_edges({"svid": np.arange(3), "tvid": np.arange(3),
                            "w": np.array([1, 2, 3])})
            states.append(_graph_state(P, g))
        return states
    ref, port = both(scenario)
    assert port == ref
    assert port[-1]["compactions"] >= 1 and port[-1]["delta"]["segments"] <= 2


def test_write_path_performs_no_rebuild_work():
    def scenario(P):
        S = P.storage
        rng = np.random.default_rng(1)
        n, e, b = 2000, 10000, 100
        g = S.Graph("G", {"A": S.Table("A", {"attr": np.zeros(n, np.int64)})},
                    S.Table("E", {"svid": rng.integers(0, n, e).astype(np.int64),
                                  "tvid": rng.integers(0, n, e).astype(np.int64),
                                  "w": np.zeros(e, np.int64)}), "A", "A")
        base_fwd, base_rev = g.fwd, g.rev
        g.insert_edges({"svid": rng.integers(0, n, b).astype(np.int64),
                        "tvid": rng.integers(0, n, b).astype(np.int64),
                        "w": np.zeros(b, np.int64)})
        g.delete_edges(np.arange(10))
        assert g.fwd is base_fwd and g.rev is base_rev
        c = g.write_counters
        return (c.write_batches, c.write_rows, c.write_ops, c.compactions,
                c.compact_ops, g.n_live_edges)
    ref, port = both(scenario)
    assert port == ref
    batches, rows, ops, compactions, compact_ops, n_live = port
    assert compactions == 0 and compact_ops == 0
    assert ops <= 20 * 100 and n_live == 10000 + 100 - 10


def test_duplicate_and_empty_write_batches():
    def scenario(P):
        A, B, E = _mk_tables()
        g = _graph_from(P, A, B, E, cfg=_no_compact(P))
        g.delete_edges(np.array([0, 0, 3, 3]))
        first = _graph_state(P, g)
        g.delete_edges(np.array([0]))
        second = _graph_state(P, g)
        g2 = _graph_from(P, A, B, E)
        g2.insert_vertices("A", {"attr": np.array([], np.int64), "tag": []})
        g2.insert_edges({"svid": np.array([], np.int64),
                         "tvid": np.array([], np.int64),
                         "w": np.array([], np.int64)})
        g2.delete_edges(np.array([], np.int64))
        return first, second, _graph_state(P, g2)
    ref, port = both(scenario)
    assert port == ref
    first, second, empty = port
    assert first["delta"]["tombstones"] == 2
    assert second["delta"] == first["delta"]
    assert second["epoch"] == first["epoch"]
    assert not empty["pending"] and empty["epoch"] == 0


def test_compact_after_delete_advances_epoch():
    ref, port = both(_scripted, [
        ("ins_e", {"svid": np.array([0]), "tvid": np.array([0]),
                   "w": np.array([1])}),
        ("compact", None), ("del_e", np.array([2])), ("compact", None)])
    assert port == ref
    epochs = [s["epoch"] for s in port]
    assert epochs[2] == epochs[1] and epochs[4] == epochs[3] + 1


def test_insert_promotes_numeric_dtype_like_seed_path():
    ref, port = both(_scripted, [
        ("ins_vA", {"attr": np.array([4.5]), "tag": ["f"]})])
    assert port == ref
    kind, dtype, values = port[-1]["vertices"]["A"]["attr"]
    assert dtype.startswith("float") and values[-1] == 4.5


def test_device_matcher_refuses_pending_delta():
    def scenario(P):
        g = _graph_from(P, *_mk_tables(), cfg=_no_compact(P))
        g.delete_edges(np.array([0]))
        kw = {"device": "cpu"} if P is PORT else {}
        with pytest.raises(ValueError, match="pending delta"):
            P.pattern_jit.DevicePatternMatcher(g, **kw)
        g.compact()
        P.pattern_jit.DevicePatternMatcher(g, **kw)
        return _graph_state(P, g)
    ref, port = both(scenario)
    assert port == ref


def test_delta_segment_neighbors_matches_csr():
    rng = np.random.default_rng(11)
    n, e = 30, 120
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n, e).astype(np.int64)
    frontier = rng.integers(0, n, 10)

    def scenario(P):
        seg = P.deltastore.EdgeSegment(src, dst, np.arange(e))
        out = []
        for reverse in (False, True):
            pos, d, eid = seg.neighbors(frontier, reverse=reverse)
            out.append(sorted(zip(frontier[pos].tolist(), d.tolist(),
                                  eid.tolist())))
        s_rep, d2, e2 = P.storage.build_csr(n, src, dst).neighbors(frontier)
        assert out[0] == sorted(zip(s_rep.tolist(), d2.tolist(),
                                    e2.astype(np.int64).tolist()))
        segT = P.deltastore.EdgeSegment(dst, src, np.arange(e))
        posf, df, ef = segT.neighbors(frontier)
        assert out[1] == sorted(zip(frontier[posf].tolist(), df.tolist(),
                                    ef.tolist()))
        return out
    ref, port = both(scenario)
    assert port == ref


# ---------------------------------------------------------------------------
# the epoch-keyed inter-buffer
# ---------------------------------------------------------------------------


def _analytics_db(P):
    S = P.storage
    db = S.Database()
    rng = np.random.default_rng(5)
    persons = S.Table("P", {"pid": np.arange(6, dtype=np.int64)})
    tags = S.Table("T", {"tid": np.arange(4, dtype=np.int64)})
    edges = S.Table("E", {"svid": rng.integers(0, 6, 12).astype(np.int64),
                          "tvid": rng.integers(0, 4, 12).astype(np.int64)})
    db.add_graph(S.Graph("G", {"P": persons, "T": tags}, edges, "P", "T"))
    return db


def _sim_task(P, froms=(), where=()):
    Q = P.schema
    pat = Q.chain_pattern("G", ("p", "P", "E", "t", "T"))
    q = Q.Query(select=("p.pid", "t.tid"), froms=froms, match=pat,
                where=where)
    return Q.GCDIATask(integration=q, analytics=Q.AnalyticsTask(
        "SIMILARITY", [("random", "p.pid", "t.tid", 4)]))


def _ib(eng):
    b = eng.interbuffer
    return b.hits, b.misses, b.bypasses, len(b)


def test_analyze_recomputes_after_graph_write():
    def scenario(P):
        db = _analytics_db(P)
        eng = P.Engine(db)
        out1 = host(eng.analyze(_sim_task(P)))
        eng.analyze(_sim_task(P))
        warm = _ib(eng)
        db.graphs["G"].insert_edges({"svid": np.array([0, 0, 0]),
                                     "tvid": np.array([3, 2, 1])})
        out2 = host(eng.analyze(_sim_task(P)))
        return warm, _ib(eng), out1, out2
    (rw, ra, r1, r2), (tw, ta, t1, t2) = both(scenario)
    assert (tw, ta) == (rw, ra)
    assert tw[0] == 1 and ta[0] == 1 and ta[1] >= 2
    for got, want in ((t1, r1), (t2, r2)):
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    assert t1.shape != t2.shape or not np.allclose(t1, t2)


def test_add_graph_replacement_invalidates_cache():
    def scenario(P):
        db = _analytics_db(P)
        eng = P.Engine(db)
        eng.analyze(_sim_task(P))
        eng.analyze(_sim_task(P))
        db.add_graph(_analytics_db(P).graphs["G"])
        eng.analyze(_sim_task(P))
        return _ib(eng), db.epoch_of("G")
    ref, port = both(scenario)
    assert port == ref
    assert port[0][0] == 1


def test_analyze_recomputes_after_table_touch():
    def scenario(P):
        db = _analytics_db(P)
        db.add_table(P.storage.Table("R", {"k": np.arange(3)}))
        eng = P.Engine(db)
        task = _sim_task(P, froms=("R",),
                         where=(P.schema.Predicate("R.k", ">=", 0),))
        eng.analyze(task)
        eng.analyze(task)
        db.touch_table("R")
        eng.analyze(task)
        return _ib(eng), db.epoch_of("R")
    ref, port = both(scenario)
    assert port == ref
    assert port[0][0] == 1


def _lru(P, ones):
    kw = {"device": "cpu"} if P is PORT else {}
    buf = P.interbuffer.InterBuffer(capacity_bytes=1 << 20, **kw)
    m = ones((4, 4))
    for _ in range(5):
        buf.put("k", m)
    out = [(len(buf), buf.nbytes())]
    buf.put("k2", m)
    out.append((buf.get("k") is not None, buf.get("k2") is not None))
    small = P.interbuffer.InterBuffer(capacity_bytes=2048, **kw)
    one_kb = ones((256,))
    small.put("a", one_kb)
    small.put("b", one_kb)
    small.get("a")
    small.put("c", one_kb)
    out.append((small.get("b") is None, small.get("a") is not None))
    small.put("huge", ones((4096,)))
    out.append((small.nbytes(), small.get("huge") is None,
                small.evictions))
    return out


def test_interbuffer_lru_and_eviction():
    import jax.numpy as jnp
    ref = _lru(REF, lambda s: jnp.ones(s, jnp.float32))
    port = _lru(PORT, lambda s: torch.ones(s, dtype=torch.float32))
    assert port == ref
    assert port[0] == (1, 64) and port[1] == (True, True)
    assert port[2] == (True, True) and port[3][0] <= 2048 and port[3][1]


def test_interbuffer_counts_oversize_puts():
    """A put larger than the capacity is admitted and then dropped by its
    own eviction, with every other entry: ``oversize`` counts it."""
    buf = PORT.interbuffer.InterBuffer(capacity_bytes=2048, device="cpu")
    buf.put("a", torch.ones(256))
    assert buf.oversize == 0 and "oversize" not in buf.metrics()
    assert "oversize" not in buf.counters()
    buf.put("huge", torch.ones(4096))
    assert len(buf) == 0 and buf.evictions == 2
    assert buf.oversize == 1 and buf.metrics()["oversize"] == 1
    assert "oversize=1" in buf.counters()
    buf.put("b", torch.ones(256))
    assert buf.oversize == 1 and len(buf) == 1
