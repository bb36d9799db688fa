"""Twin of ``tests/test_shard.py``: the port's sharded morsel-parallel
executor returns exactly the serial rows, in the same order, under the same
random delta/tombstone/compaction streams as the JAX package's (same
fingerprints, shard counts and explain text), its born-sharded GCDA is
bit-identical to the serial product, and its partitions, statistics
rollups, cost gate and shared runtime structures behave alike."""
from __future__ import annotations

import threading

import numpy as np
from hypothesis import given, settings, strategies as st
from torch_twin import PORT, both, host, untimed

MODES = ("gredo", "dual", "single")
TOPICS = ["food", "music", "sport", "code", "art"]


def tiny_db(P, seed):
    S = P.storage
    rng = np.random.default_rng(seed)
    n_p, n_t, n_c, n_o = 160, 24, 120, 1500
    persons = S.Table("Persons", {
        "pid": np.arange(n_p, dtype=np.int64),
        "country": S.DictColumn(rng.choice(["de", "fi", "jp", "us"], n_p)),
    })
    tags = S.Table("Tags", {
        "tid": np.arange(n_t, dtype=np.int64),
        "content": S.DictColumn([TOPICS[i % len(TOPICS)] for i in range(n_t)]),
    })
    n_e = 900
    edges = S.Table("G_edges", {
        "svid": rng.integers(0, n_p, n_e).astype(np.int64),
        "tvid": rng.integers(0, n_t, n_e).astype(np.int64),
        "weight": rng.uniform(0.0, 1.0, n_e),
    })
    g = S.Graph("G", {"Persons": persons, "Tags": tags}, edges,
                "Persons", "Tags")
    customer = S.Table("Customer", {
        "id": np.arange(n_c, dtype=np.int64),
        "person_id": rng.permutation(n_p)[:n_c].astype(np.int64),
        "age": rng.integers(18, 80, n_c).astype(np.int64),
    })
    orders = S.Table("Orders", {
        "order_id": np.arange(n_o, dtype=np.int64),
        "customer_id": rng.integers(0, n_c, n_o).astype(np.int64),
        "quantity": rng.integers(1, 5, n_o).astype(np.int64),
        "days": rng.integers(1, 10, n_o).astype(np.int64),
    })
    db = S.Database()
    db.add_graph(g)
    db.add_table(customer)
    db.add_table(orders)
    return db


def cross_model_query(P):
    Q = P.schema
    return Q.Query(
        select=("Customer.id", "Orders.order_id", "Orders.quantity",
                "t.tid", "p.pid"),
        froms=("Customer", "Orders"),
        match=Q.chain_pattern("G", ("p", "Persons", "G", "t", "Tags")),
        joins=(Q.JoinPred("Customer.person_id", "p.pid"),
               Q.JoinPred("Orders.customer_id", "Customer.id")),
        where=(Q.Predicate("Orders.quantity", ">=", 2),
               Q.Predicate("t.content", "==", "food")))


def apply_mutation(g, op, rng):
    if op == "edges":
        m = int(rng.integers(10, 60))
        g.insert_edges({
            "svid": rng.integers(0, 160, m).astype(np.int64),
            "tvid": rng.integers(0, 24, m).astype(np.int64),
            "weight": rng.uniform(0.0, 1.0, m),
        })
    elif op == "tombstone":
        live = g.live_edge_ids()
        m = min(int(rng.integers(5, 40)), len(live))
        if m:
            g.delete_edges(rng.choice(live, m, replace=False))
    elif op == "compact":
        g.compact()


class _forced_sharding:
    """``cost.SHARD_MIN_ROWS = 0`` in one package for a ``with`` block."""

    def __init__(self, P):
        self.cost = P.cost

    def __enter__(self):
        self.saved = self.cost.SHARD_MIN_ROWS
        self.cost.SHARD_MIN_ROWS = 0

    def __exit__(self, *exc):
        self.cost.SHARD_MIN_ROWS = self.saved


@st.composite
def shard_scenario(draw):
    mode = draw(st.sampled_from(MODES))
    k = draw(st.sampled_from((1, 2, 4, 7)))
    seed = draw(st.integers(min_value=0, max_value=2**16))
    n_ops = draw(st.integers(min_value=1, max_value=3))
    ops = tuple(draw(st.sampled_from(("edges", "tombstone", "compact")))
                for _ in range(n_ops))
    return mode, k, seed, ops


def _serial_vs_sharded(P, mode, k, seed, ops):
    db_a, db_b = tiny_db(P, seed), tiny_db(P, seed)
    q = cross_model_query(P)
    out = []
    with _forced_sharding(P):
        serial = P.Engine(db_a, mode=mode)
        sharded = P.Engine(db_b, mode=mode, n_shards=k)

        def step():
            a, b = P.fingerprint(serial.query(q)), \
                P.fingerprint(sharded.query(q))
            assert a == b
            out.append((a, sharded.last_shard_count,
                        list(sharded.last_stats.plan_notes)))
        step()
        rng_a = np.random.default_rng(seed + 1)
        rng_b = np.random.default_rng(seed + 1)
        for op in ops:
            apply_mutation(db_a.graphs["G"], op, rng_a)
            apply_mutation(db_b.graphs["G"], op, rng_b)
            step()
        if k > 1:
            assert sharded.last_shard_count == k
    return out


@settings(max_examples=10, deadline=None)
@given(shard_scenario())
def test_sharded_matches_serial_under_mutation_stream(scenario):
    ref, port = both(_serial_vs_sharded, *scenario)
    assert port == ref


def test_sharded_gcda_born_sharded_and_equal():
    def scenario(P):
        Q = P.schema
        task = Q.GCDIATask(
            integration=cross_model_query(P),
            analytics=Q.AnalyticsTask("MULTIPLY", [
                ("rel2matrix", ("Orders.quantity", "Orders.order_id",
                                "t.tid"))]))
        with _forced_sharding(P):
            serial = P.Engine(tiny_db(P, 7), mode="gredo")
            sharded = P.Engine(tiny_db(P, 7), mode="gredo", n_shards=4,
                               telemetry=True)
            want = host(serial.analyze(task))
            got = host(sharded.analyze(task))
        assert np.array_equal(want, got)
        spans = [s for s in sharded.telemetry.collector.last().spans
                 if s.name == "Rel2Matrix"]
        args = spans[0].args
        return got, {k: args.get(k) for k in ("born_sharded", "host_gather",
                                              "shards", "rows_per_block")}
    (r_mat, r_args), (t_mat, t_args) = both(scenario)
    assert t_args == r_args
    assert t_args["born_sharded"] is True and t_args["host_gather"] is False
    assert t_args["shards"] == 4
    np.testing.assert_allclose(t_mat, r_mat, rtol=2e-4, atol=2e-4)


def test_explain_shows_shard_provenance_and_metrics():
    def scenario(P):
        with _forced_sharding(P):
            eng = P.Engine(tiny_db(P, 3), mode="gredo", n_shards=4,
                           telemetry=True)
            eng.query(cross_model_query(P))
        snap = eng.telemetry.registry.snapshot()
        return (untimed(eng.explain_last()),
                {k: snap.get(k) for k in ("shard.morsels",
                                          "shard.rows_shard_max",
                                          "shard.rows_shard_mean")},
                "shard.queue_wait_s" in snap)
    ref, port = both(scenario)
    assert port == ref
    txt, snap, has_wait = port
    assert "shards=4" in txt and "Exchange" in txt
    assert "sharded execution: k=4" in txt
    assert snap["shard.morsels"] >= 1 and has_wait
    assert snap["shard.rows_shard_max"] >= snap["shard.rows_shard_mean"]


def test_exchange_partition_reused_across_queries():
    def scenario(P):
        with _forced_sharding(P):
            eng = P.Engine(tiny_db(P, 11), mode="gredo", n_shards=4)
            eng.query(cross_model_query(P))
            m0 = eng._shard_runtime.metrics()
            eng.query(cross_model_query(P))
            m1 = eng._shard_runtime.metrics()
        keys = ("exchanges_reused", "exchanges_built")
        return {k: m0[k] for k in keys}, {k: m1[k] for k in keys}
    ref, port = both(scenario)
    assert port == ref
    m0, m1 = port
    assert m1["exchanges_reused"] > m0["exchanges_reused"]
    assert m1["exchanges_built"] == m0["exchanges_built"]


def test_cost_gate_keeps_small_inputs_serial():
    def scenario(P):
        c = P.cost
        gate = (c.choose_shard_count(100, 4),
                c.choose_shard_count(c.SHARD_MIN_ROWS * 10, 4),
                c.choose_shard_count(c.SHARD_MIN_ROWS * 10, 1))
        eng = P.Engine(tiny_db(P, 5), mode="gredo", n_shards=4)
        eng.query(cross_model_query(P))
        return gate, eng.last_shard_count, "Exchange" in eng.explain_last()
    ref, port = both(scenario)
    assert port == ref == ((1, 4, 1), 1, False)


def _partition_probe(P, seed, k, as_str):
    S = P.storage
    rng = np.random.default_rng(seed)
    n_l, n_r = int(rng.integers(1, 400)), int(rng.integers(1, 400))
    lk = rng.integers(0, 50, n_l).astype(np.int64)
    rk = rng.integers(0, 50, n_r).astype(np.int64)
    if as_str:
        lt = S.Table("L", {"key": S.DictColumn([f"k{v}" for v in lk])})
        rt = S.Table("R", {"key": S.DictColumn([f"k{v}" for v in rk])})
    else:
        lt, rt = S.Table("L", {"key": lk}), S.Table("R", {"key": rk})
    li_ref, ri_ref = P.join.equi_join_indices(lt, "key", rt, "key")
    part = P.shard.build_partition(rt, "key", k)
    lkeys, lrows = P.join._key_arrays(lt, "key")
    sh_ids = P.shard.hash_shard_ids(lkeys, k)
    li, ri = [], []
    for i in range(n_l):
        s = int(sh_ids[i])
        ks = part.keys[s]
        lo = int(np.searchsorted(ks, lkeys[i], "left"))
        hi = int(np.searchsorted(ks, lkeys[i], "right"))
        for p in range(lo, hi):
            li.append(int(lrows[i]))
            ri.append(int(part.rows_cat[part.base[s] + p]))
    assert li == li_ref.tolist() and ri == ri_ref.tolist()
    assert int(part.rows_per_shard().sum()) == n_r
    return (sh_ids.tolist(), part.rows_per_shard().tolist(),
            part.rows_cat.tolist(), li, ri)


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=2**16),
       st.sampled_from((1, 2, 4, 7)), st.booleans())
def test_build_partition_probe_matches_equi_join(seed, k, as_str):
    ref, port = both(_partition_probe, seed, k, as_str)
    assert port == ref


def _stats_view(s):
    return (s.n, s.ndv, s.value_counts,
            None if s.hist is None else s.hist.tolist(), s.vmin, s.vmax)


def _rollup(P, seed, k):
    S = P.storage
    rng = np.random.default_rng(seed)
    n = int(rng.integers(16, 3000))
    tbl = S.Table("S", {
        "num": rng.integers(0, 40, n).astype(np.int64),
        "cat": S.DictColumn(rng.choice(["a", "b", "c", "d"], n)),
    })
    shards = S.TableShards(tbl, k, align=64)
    out = []
    for col in ("num", "cat"):
        whole = S.compute_stats(tbl.columns[col])
        rolled = S.merge_stats([shards.shard_stats(col)[i]
                                for i in range(len(shards.bounds))])
        assert rolled.n == whole.n and rolled.ndv == whole.ndv
        if whole.value_counts is not None:
            assert rolled.value_counts == whole.value_counts
        out.append((_stats_view(whole), _stats_view(rolled)))
    return shards.bounds, out


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=2**16),
       st.sampled_from((1, 2, 4, 7)))
def test_per_shard_stats_rollup_is_exact(seed, k):
    ref, port = both(_rollup, seed, k)
    assert repr(port) == repr(ref)


def test_table_shards_concat_roundtrip():
    def scenario(P):
        S = P.storage
        rng = np.random.default_rng(0)
        n = 999
        tbl = S.Table("T", {"a": rng.integers(0, 9, n).astype(np.int64),
                            "s": S.DictColumn(rng.choice(["x", "y", "z"], n))})
        ts = S.TableShards(tbl, 4, align=128)
        parts = []
        for i in range(len(ts.bounds)):
            sh = ts.shard(i)
            s = sh.columns["s"]
            parts.append((np.asarray(sh.columns["a"]).tolist(),
                          list(s.decode(s.codes))))
        return ts.bounds, parts, list(ts.rows_per_shard())
    ref, port = both(scenario)
    assert port == ref
    bounds, parts, rows = port
    assert bounds[0][0] == 0 and bounds[-1][1] == 999 and sum(rows) == 999
    assert all(bounds[i][1] == bounds[i + 1][0]
               for i in range(len(bounds) - 1))


def test_graph_partitions_account_for_delta_and_tombstones():
    def scenario(P):
        g = tiny_db(P, 2).graphs["G"]
        rng = np.random.default_rng(2)
        g.insert_edges({"svid": rng.integers(0, 160, 50).astype(np.int64),
                        "tvid": rng.integers(0, 24, 50).astype(np.int64),
                        "weight": rng.uniform(0.0, 1.0, 50)})
        g.delete_edges(g.live_edge_ids()[:30])
        parts = P.storage.GraphPartitions(g, 4)
        out = (list(parts.edges_per_partition()),
               list(parts.tombstones_per_partition()), parts.fresh(),
               g.n_live_edges)
        g.insert_edges({"svid": np.array([0], dtype=np.int64),
                        "tvid": np.array([0], dtype=np.int64),
                        "weight": np.array([0.5])})
        return out + (parts.fresh(),)
    ref, port = both(scenario)
    assert port == ref
    edges, tombs, fresh, n_live, fresh_after = port
    assert sum(edges) == n_live and sum(tombs) == 30
    assert fresh and not fresh_after


def test_shard_bounds_cover_and_align():
    def scenario(P):
        return {(n, k): P.storage.shard_bounds(n, k, align=64)
                for n in (0, 1, 100, 4097) for k in (1, 2, 4, 7)}
    ref, port = both(scenario)
    assert port == ref
    for (n, k), b in port.items():
        assert len(b) == k and b[0][0] == 0 and b[-1][1] == n
        for (lo, hi), (lo2, _) in zip(b, b[1:]):
            assert hi == lo2 and (lo % 64 == 0 or lo == n)


def _concurrent(P):
    kw = {"device": "cpu"} if P is PORT else {}
    ib = P.interbuffer.InterBuffer(capacity_bytes=1 << 20, **kw)
    reg = P.telemetry.Registry()
    col = P.telemetry.TraceCollector(max_spans=256)
    errors: list = []
    n_threads, n_iter = 8, 200

    def worker(tid):
        try:
            rng = np.random.default_rng(tid)
            for i in range(n_iter):
                key = f"k{tid % 4}:{i % 8}"
                ib.put(key, rng.standard_normal(32), est_cost=1.0)
                ib.get(key)
                ib.get(f"k{(tid + 1) % 4}:{i % 8}")
                reg.counter("t.ops").inc()
                reg.histogram("t.lat").observe(float(i))
                qt = col.start_query(f"q{tid}")
                qt.instant("tick", i=i)
                col.trim()
        except BaseException as e:      # reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert col.last() is not None
    snap = reg.snapshot()
    return (snap["t.ops"], snap["t.lat.count"], len(ib),
            ib.hits + ib.misses)


def test_concurrent_interbuffer_registry_collector():
    ref, port = both(_concurrent)
    assert port == ref
    assert port[:2] == (8 * 200, 8 * 200) and port[3] == 2 * 8 * 200
