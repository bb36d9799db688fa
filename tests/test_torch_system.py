"""Twin of ``tests/test_system.py``: end to end, the port agrees with the JAX
package — the same results in all three modes (and across the modes), the
same I/O-proxy ordering, the GCDIA pipeline within the GCDA tolerances,
the same inter-buffer reuse, A1's regression learning the signal, shortest
paths, and graph updates evolving alike."""
import numpy as np
import pytest
import torch
from torch_twin import PKGS, PORT, both, host

QUERIES = ["q_g1", "q_g2", "q_g3", "q_g4", "q_g5", "q_edge_scan",
           "q_vertex_scan"]
MODES = ("gredo", "dual", "single")


@pytest.fixture(scope="module")
def dbs():
    return {P.name: P.m2bench.generate(sf=1, seed=7) for P in PKGS}


def _sorted_rows(r):
    key_cols = sorted(r.columns)
    rows = np.stack([np.asarray(r.col(c), dtype=np.int64)
                     if np.asarray(r.col(c)).dtype.kind in "iu"
                     else np.asarray(r.col(c).codes if hasattr(r.col(c),
                                                                "codes")
                                     else r.col(c)).astype(np.float64)
                     for c in key_cols])
    return rows[:, np.lexsort(rows)].tolist()


@pytest.mark.parametrize("qname", QUERIES)
def test_tri_mode_agreement(dbs, qname):
    def scenario(P):
        q = getattr(P.m2bench, qname)()
        out = {}
        for mode in MODES:
            r = P.Engine(dbs[P.name], mode=mode).query(q)
            out[mode] = (P.fingerprint(r), _sorted_rows(r))
        assert out["gredo"][1] == out["dual"][1] == out["single"][1]
        return out
    ref, port = both(scenario)
    assert port == ref


def test_io_proxy_ordering(dbs):
    def scenario(P):
        out = {}
        for qname in ("q_g1", "q_g2", "q_g3"):
            ios = {}
            for mode in MODES:
                eng = P.Engine(dbs[P.name], mode=mode)
                eng.query(getattr(P.m2bench, qname)())
                ios[mode] = (eng.last_stats.record_fetches,
                             eng.last_stats.cpu_ops)
            out[qname] = ios
        return out
    ref, port = both(scenario)
    assert port == ref
    for qname, ios in port.items():
        assert ios["gredo"][0] <= ios["dual"][0] <= ios["single"][0], \
            (qname, ios)


def test_gcdia_pipeline(dbs):
    ref, port = both(lambda P: host(P.Engine(dbs[P.name]).analyze(
        P.m2bench.a2_similarity())))
    assert port.shape == ref.shape and port.shape[0] == port.shape[1]
    assert not np.isnan(port).any()
    np.testing.assert_allclose(np.diag(port), 1.0, atol=1e-3)
    np.testing.assert_allclose(port, ref, rtol=3e-4, atol=3e-5)


def test_interbuffer_reuse(dbs):
    def scenario(P):
        eng = P.Engine(dbs[P.name])
        eng.analyze(P.m2bench.a3_multiply())
        first = eng.interbuffer.hits
        eng.analyze(P.m2bench.a3_multiply())
        return first, eng.interbuffer.hits, eng.interbuffer.misses
    ref, port = both(scenario)
    assert port == ref
    assert port[:2] == (0, 1)


def test_regression_learns_signal(dbs):
    """A1: the paper's running example — tags predict yogurt purchase."""
    def scenario(P):
        db = dbs[P.name]
        r = P.Engine(db).query(P.m2bench.q_g1())
        kw = {"device": "cpu"} if P is PORT else {}
        X, groups = P.analytics.random_access_matrix(
            r, "Customer.id", "t.tid", P.m2bench.N_TAGS, **kw)
        y = P.m2bench.purchase_labels(db)[groups]
        if kw:
            w, loss = P.analytics.regression(X, torch.as_tensor(y), iters=50)
        else:
            import jax.numpy as jnp
            w, loss = P.analytics.regression(X, jnp.asarray(y), iters=50)
        X, w = host(X), host(w)
        acc = float(((X @ w > 0) == (y > 0.5)).mean())
        return X, groups, y, w, float(host(loss)), acc
    (rX, rg, ry, rw, rl, racc), (tX, tg, ty, tw, tl, tacc) = both(scenario)
    np.testing.assert_array_equal(tX, rX)
    np.testing.assert_array_equal(tg, rg)
    np.testing.assert_array_equal(ty, ry)
    np.testing.assert_allclose(tw, rw, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(tl, rl, rtol=3e-4, atol=3e-5)
    assert tacc > max(float((ty > 0.5).mean()),
                      float((ty <= 0.5).mean())) - 0.02


def test_shortest_path(dbs):
    ref, port = both(lambda P: P.Engine(dbs[P.name]).shortest_path(
        "Follows", "Persons", np.arange(4), "Persons", np.arange(4)).tolist())
    assert port == ref == [0, 0, 0, 0]


def test_graph_updates(dbs):
    def scenario(P):
        g = dbs[P.name].graphs["Interested_in"]
        n_edges, epoch0 = g.edges.nrows, g.epoch
        svid = np.asarray(g.edges.col("svid"))[:2]
        g.delete_edges(np.array([0, 1]))
        _, _, eids = g.expand(np.arange(g.n_vertices))
        after_delete = (g.n_live_edges, len(eids), 0 in eids, 1 in eids)
        g.insert_edges({"svid": svid, "tvid": np.array([0, 1]),
                        "weight": np.array([0.5, 0.6])})
        after_insert = (g.n_live_edges, g.epoch - epoch0)
        g.compact()
        return (n_edges, after_delete, after_insert, g.delta.has_pending(),
                g.edges.nrows, g.fwd.n_edges, int(g.fwd.edge_id.max()),
                g.epoch, g.fwd.edge_id.tolist())
    ref, port = both(scenario)
    assert port == ref
    n, deleted, inserted, pending, nrows, n_fwd, max_eid, _, _ = port
    assert deleted == (n - 2, n - 2, False, False)
    assert inserted == (n, 2)
    assert not pending and nrows == n_fwd == n and max_eid < nrows
