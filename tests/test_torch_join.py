"""Twin of the join probes: the port's ``equi_join_indices``, ``join_tables``
and ``member_mask`` give the JAX package's pairs, masks, dtypes and
``cpu_ops`` / ``record_fetches`` counts on the same tables, whichever path
(the direct-address table over dense integer keys, or the sort join) the
port's ``join.COUNTERS`` say ran; and GCDI queries through the engine keep
the reference's fingerprints."""
import numpy as np
import pytest
from torch_twin import PKGS, PORT, both


def _plain(a):
    return ("plain", np.asarray(a))


def _ragged(lists):
    return ("ragged", [np.asarray(x, dtype=np.int64) for x in lists])


def _dict(words):
    return ("dict", list(words))


def _table(P, name, spec):
    kind, data = spec
    S = P.storage
    col = {"plain": lambda d: d, "dict": S.DictColumn,
           "ragged": S.RaggedColumn}[kind](data)
    return S.Table(name, {"k": col})


def _rng(seed):
    return np.random.default_rng(seed)


def _ragged_lists(rng, n, lo, hi):
    return [rng.integers(lo, hi, int(rng.integers(0, 4))) for _ in range(n)]


# name -> (left keys, right keys (the build), path the port takes)
JOIN_CASES = {
    "dense_unique": lambda r: (_plain(r.integers(50, 1250, 3000)),
                               _plain(r.permutation(1000) + 100), "direct"),
    "dense_duplicates": lambda r: (_plain(r.integers(-10, 510, 1500)),
                                   _plain(r.integers(0, 500, 2000)), "direct"),
    "duplicates_at_most_two": lambda r: (
        _plain(r.integers(0, 420, 500)),
        _plain(r.permutation(np.concatenate([np.arange(400),
                                             np.arange(0, 400, 7)]))),
        "direct"),
    "negative_keys": lambda r: (_plain(r.integers(-900, -100, 700)),
                                _plain(r.integers(-700, -200, 800)), "direct"),
    "probes_outside_range": lambda r: (
        _plain(np.concatenate([r.integers(990, 2010, 500),
                               [2 ** 63 - 1, -2 ** 63, -5, 10 ** 12, 1999]])),
        _plain(r.permutation(np.arange(1000, 2000))), "direct"),
    "int32_probe_int64_build": lambda r: (
        _plain(r.integers(0, 600, 900).astype(np.int32)),
        _plain(r.integers(0, 500, 400).astype(np.int64)), "direct"),
    "int64_probe_int32_build": lambda r: (
        _plain(r.integers(-2 ** 40, 2 ** 40, 50).tolist()
               + r.integers(0, 600, 900).tolist()),
        _plain(r.integers(0, 500, 400).astype(np.int32)), "direct"),
    "uint32_probe": lambda r: (_plain(r.integers(0, 300, 600).astype(np.uint32)),
                               _plain(r.permutation(256)), "direct"),
    "sparse_span": lambda r: (_plain(r.choice(10 ** 9, 400)),
                              _plain(r.choice(10 ** 9, 500, replace=False)),
                              "sorted"),
    "near_int64_limit": lambda r: (_plain(np.array([2 ** 62 + 5, 7, 2 ** 62 + 6])),
                                   _plain(np.array([2 ** 62 + 5, 2 ** 62 + 6,
                                                    2 ** 62 + 5])), "sorted"),
    "uint64_keys": lambda r: (_plain(r.integers(0, 50, 80).astype(np.uint64)),
                              _plain(r.integers(0, 50, 60).astype(np.uint64)),
                              "sorted"),
    "float_keys": lambda r: (_plain(r.integers(0, 50, 80).astype(np.float64)),
                             _plain(r.integers(0, 50, 60)), "sorted"),
    "dict_strings": lambda r: (_dict(r.choice(["a", "b", "c", "d"], 300)),
                               _dict(r.choice(["b", "c", "e"], 200)), "sorted"),
    "ragged_probe": lambda r: (_ragged(_ragged_lists(r, 300, 0, 60)),
                               _plain(r.integers(0, 50, 200)), "direct"),
    "ragged_build": lambda r: (_plain(r.integers(0, 60, 300)),
                               _ragged(_ragged_lists(r, 200, 0, 50)), "direct"),
    "empty_probe": lambda r: (_plain(np.zeros(0, dtype=np.int64)),
                              _plain(r.integers(0, 50, 200)), "direct"),
    "empty_build": lambda r: (_plain(r.integers(0, 50, 200)),
                              _plain(np.zeros(0, dtype=np.int64)), "sorted"),
}


def _counted(P, fn):
    """``fn()`` with the package's ``cpu_ops`` and ``record_fetches`` deltas;
    for the port also the delta of its join-path counters."""
    c = P.traversal.COUNTERS
    c0 = (c.cpu_ops, c.record_fetches)
    j0 = PORT.join.metrics() if P is PORT else None
    out = fn()
    deltas = (c.cpu_ops - c0[0], c.record_fetches - c0[1])
    if P is PORT:
        j1 = PORT.join.metrics()
        return out, deltas, {k: j1[k] - j0[k] for k in j1}
    return out, deltas, None


def _path(want):
    return {"direct": 1 if want == "direct" else 0,
            "sorted": 1 if want == "sorted" else 0}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_equi_join_indices_matches_reference(case):
    lspec, rspec, want = JOIN_CASES[case](_rng(len(case)))

    def scenario(P):
        left, right = _table(P, "L", lspec), _table(P, "R", rspec)
        return _counted(P, lambda: P.join.equi_join_indices(left, "k",
                                                             right, "k"))
    (r_out, r_cnt, _), (p_out, p_cnt, p_path) = both(scenario)
    for r, p in zip(r_out, p_out):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
    assert p_cnt == r_cnt
    assert p_path == _path(want)


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_tables_matches_reference(case):
    lspec, rspec, want = JOIN_CASES[case](_rng(len(case) + 1))

    def scenario(P):
        left = _table(P, "L", lspec)
        left.columns["lid"] = np.arange(left.nrows)
        right = _table(P, "R", rspec)
        right.columns["rid"] = np.arange(right.nrows) * 3
        pred = P.schema.JoinPred("L.k", "R.k")
        t, cnt, path = _counted(P, lambda: P.join.join_tables(left, right,
                                                              pred))
        return (sorted(t.columns), t.nrows,
                np.asarray(t.col("L.lid")), np.asarray(t.col("R.rid")),
                cnt, path)
    ref, port = both(scenario)
    assert port[:2] == ref[:2]
    for i in (2, 3):
        assert port[i].dtype == ref[i].dtype
        np.testing.assert_array_equal(port[i], ref[i])
    assert port[4] == ref[4]
    assert port[5] == _path(want)


# name -> (table keys, probe key set (the build), path the port takes)
MASK_CASES = {
    "dense": lambda r: (_plain(r.integers(0, 400, 1000)),
                        r.integers(100, 300, 150), "direct"),
    "negative_keys": lambda r: (_plain(r.integers(-500, 0, 800)),
                                r.integers(-300, -100, 90), "direct"),
    "keys_outside_range": lambda r: (
        _plain(np.concatenate([r.integers(0, 100, 300),
                               [2 ** 63 - 1, -2 ** 63]])),
        r.integers(40, 60, 30), "direct"),
    "int32_table_int64_keys": lambda r: (
        _plain(r.integers(0, 200, 500).astype(np.int32)),
        r.integers(0, 150, 100).astype(np.int64), "direct"),
    "sparse_span": lambda r: (_plain(r.choice(10 ** 9, 300)),
                              r.choice(10 ** 9, 40, replace=False), "sorted"),
    "dict_strings": lambda r: (_dict(r.choice(["x", "y", "z"], 200)),
                               np.array(["y", "w"]), "sorted"),
    "ragged_any": lambda r: (_ragged(_ragged_lists(r, 250, 0, 80)),
                             r.integers(0, 80, 25), "direct"),
    "empty_keys": lambda r: (_plain(r.integers(0, 50, 100)),
                             np.zeros(0, dtype=np.int64), "sorted"),
    "empty_table": lambda r: (_plain(np.zeros(0, dtype=np.int64)),
                              r.integers(0, 50, 20), "direct"),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_member_mask_matches_reference(case):
    tspec, keys, want = MASK_CASES[case](_rng(len(case) + 2))

    def scenario(P):
        tbl = _table(P, "T", tspec)
        return _counted(P, lambda: P.join.member_mask(tbl, "k", keys))
    (r_hit, r_cnt, _), (p_hit, p_cnt, p_path) = both(scenario)
    assert p_hit.dtype == r_hit.dtype
    np.testing.assert_array_equal(p_hit, r_hit)
    assert p_cnt == r_cnt
    assert p_path == _path(want)


def test_direct_path_is_left_major_in_build_row_order():
    """Duplicate build keys come out in build-row order within each probe,
    probes in their own order: the stable sort's order."""
    S = PORT.storage
    left = S.Table("L", {"k": np.array([3, 1, 3, 9])})
    right = S.Table("R", {"k": np.array([3, 1, 3, 2, 3, 1])})
    li, ri = PORT.join.equi_join_indices(left, "k", right, "k")
    assert li.tolist() == [0, 0, 0, 1, 1, 2, 2, 2]
    assert ri.tolist() == [0, 2, 4, 1, 5, 0, 2, 4]


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1) for P in PKGS}


@pytest.mark.parametrize("qname", ["q_g1", "q_g2", "q_g4"])
def test_gcdi_queries_take_the_direct_path(dbs, qname):
    def scenario(P):
        eng = P.Engine(dbs[P.name], telemetry=True)
        res = eng.query(getattr(P.m2bench, qname)())
        return P.fingerprint(res), eng.last_registry_delta, eng.explain_last()
    (r_fp, _, _), (p_fp, delta, explain) = both(scenario)
    assert p_fp == r_fp
    assert delta.get("join.direct", 0) > 0
    assert delta.get("join.sorted", 0) == 0
    assert f"join (this query): direct=+{delta['join.direct']:g}" in explain


def _string_key_db(P):
    S = P.storage
    rng = _rng(5)
    db = S.Database()
    db.add_table(S.Table("A", {
        "a_id": np.arange(300, dtype=np.int64),
        "code": S.DictColumn(rng.choice(["k1", "k2", "k3", "k4"], 300))}))
    db.add_table(S.Table("B", {
        "b_id": np.arange(40, dtype=np.int64),
        "code": S.DictColumn(rng.choice(["k2", "k4", "k5"], 40))}))
    return db


def test_string_keyed_join_takes_the_sort_path():
    def scenario(P):
        Q = P.schema
        q = Q.Query(select=("A.a_id", "B.b_id"), froms=("A", "B"),
                    joins=(Q.JoinPred("A.code", "B.code"),))
        eng = P.Engine(_string_key_db(P), telemetry=True)
        res = eng.query(q)
        return (P.fingerprint(res), res.nrows, eng.last_registry_delta,
                eng.explain_last())
    ref, port = both(scenario)
    assert port[:2] == ref[:2] and port[1] > 0
    delta, explain = port[2], port[3]
    assert delta.get("join.sorted", 0) >= 1
    assert delta.get("join.direct", 0) == 0
    assert "join (this query): sorted=+" in explain


def test_join_counts_are_a_registry_source():
    snap = PORT.Engine(PORT.storage.Database()).metrics_snapshot()
    assert snap["join.direct"] == PORT.join.COUNTERS.direct
    assert snap["join.sorted"] == PORT.join.COUNTERS.sorted
