"""End-to-end parity of the port's engine (``device="cpu"``: plain PyTorch
versions of the kernels) with the JAX package on the same M2Bench sf=1
database: GCDI fingerprints and explain text in all three modes, device
lowering of G3/G5, GCDA outputs, inter-buffer reuse and sharded runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GredoEngine as JaxEngine
from repro.core import analytics as jax_analytics
from repro.core import cost as jax_cost
from repro.core.observe import result_fingerprint as jax_fingerprint
from repro.data import m2bench as jm
from repro_torch.core import GredoEngine as TorchEngine
from repro_torch.core import analytics, cost
from repro_torch.core.observe import result_fingerprint
from repro_torch.data import m2bench as tm

MODES = ("gredo", "dual", "single")
QUERIES = ("q_g1", "q_g2", "q_g3", "q_g4", "q_g5", "q_edge_scan",
           "q_vertex_scan", "q_opt_skew", "q_point_lookup", "q_range_narrow",
           "q_shard_join")
# GCDA tolerances (the kernel sweeps'): matmul 2e-4; cosine and the
# regression rtol 3e-4 / atol 3e-5
TASKS = {"a2_similarity": (3e-4, 3e-5), "a3_multiply": (2e-4, 2e-4),
         "a_shard_reg": (3e-4, 3e-5)}


@pytest.fixture(scope="module")
def dbs():
    return jm.generate(sf=1, seed=0), tm.generate(sf=1, seed=0)


@pytest.fixture(scope="module")
def engines(dbs):
    jdb, tdb = dbs
    return {mode: (JaxEngine(jdb, mode=mode),
                   TorchEngine(tdb, mode=mode, device="cpu"))
            for mode in MODES}


def _query(m2bench, db, qname):
    if qname == "q_point_lookup":       # a non-empty point query
        return m2bench.q_point_lookup(*m2bench.point_lookup_keys(db))
    return getattr(m2bench, qname)()


@pytest.mark.parametrize("qname", QUERIES)
@pytest.mark.parametrize("mode", MODES)
def test_gcdi_fingerprint_and_explain_match(dbs, engines, mode, qname):
    je, te = engines[mode]
    jq, tq = _query(jm, dbs[0], qname), _query(tm, dbs[1], qname)
    assert je.explain(jq) == te.explain(tq)
    jr, tr = je.query(jq), te.query(tq)
    assert tr.nrows == jr.nrows
    assert result_fingerprint(tr) == jax_fingerprint(jr)
    assert te.last_stats.rewrites == je.last_stats.rewrites
    assert te.last_stats.plan_notes == je.last_stats.plan_notes


@pytest.mark.parametrize("qname", ["q_g3", "q_g5"])
def test_g3_g5_lowered_to_device_pallas_in_both(engines, qname):
    je, te = engines["gredo"]
    je.query(getattr(jm, qname)())
    te.query(getattr(tm, qname)())
    for eng in (je, te):
        assert any("device-pallas" in n for n in eng.last_stats.rewrites)
    assert [o["op"] if isinstance(o, dict) else o
            for o in te.last_stats.operators] == \
        [o["op"] if isinstance(o, dict) else o
         for o in je.last_stats.operators]


@pytest.mark.parametrize("task", sorted(TASKS))
def test_gcda_outputs_match(dbs, task):
    jdb, tdb = dbs
    rtol, atol = TASKS[task]
    want = np.asarray(JaxEngine(jdb).analyze(getattr(jm, task)()))
    got = TorchEngine(tdb, device="cpu").analyze(getattr(tm, task)())
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_a1_regression_matches(engines, dbs):
    """A1 through ``analytics.regression`` (the quickstart flow): weights
    and loss after 100 iterations within rtol 3e-4 / atol 3e-5."""
    jdb, tdb = dbs
    je, te = engines["gredo"]
    jX, jg = jax_analytics.random_access_matrix(
        je.query(jm.q_g1()), "Customer.id", "t.tid", jm.N_TAGS)
    tX, tg = analytics.random_access_matrix(
        te.query(tm.q_g1()), "Customer.id", "t.tid", tm.N_TAGS, device="cpu")
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tg, jg)
    y = jm.purchase_labels(jdb)[jg]
    np.testing.assert_array_equal(tm.purchase_labels(tdb)[tg], y)
    jw, jloss = jax_analytics.regression(jX, jnp.asarray(y), iters=100)
    tw, tloss = analytics.regression(tX, torch.as_tensor(y), iters=100)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=3e-4,
                               atol=3e-5)


def test_interbuffer_reuse_on_repeated_a3(dbs):
    eng = TorchEngine(dbs[1], device="cpu")
    eng.analyze(tm.a3_multiply())
    assert eng.interbuffer.hits == 0
    out = eng.analyze(tm.a3_multiply())
    assert eng.interbuffer.hits == 1
    assert out.device.type == "cpu"


@pytest.fixture
def force_sharding():
    saved = (cost.SHARD_MIN_ROWS, jax_cost.SHARD_MIN_ROWS)
    cost.SHARD_MIN_ROWS = jax_cost.SHARD_MIN_ROWS = 0
    yield
    cost.SHARD_MIN_ROWS, jax_cost.SHARD_MIN_ROWS = saved


def test_sharded_query_matches_serial_and_reference(dbs, force_sharding):
    jdb, tdb = dbs
    sharded = TorchEngine(tdb, n_shards=2, device="cpu")
    got = sharded.query(tm.q_shard_join())
    assert sharded.last_shard_count == 2
    serial = TorchEngine(tdb, device="cpu").query(tm.q_shard_join())
    ref = JaxEngine(jdb, n_shards=2).query(jm.q_shard_join())
    assert result_fingerprint(got) == result_fingerprint(serial) == \
        jax_fingerprint(ref)


def test_sharded_regression_matches_serial_and_reference(dbs,
                                                        force_sharding):
    jdb, tdb = dbs
    sharded = TorchEngine(tdb, n_shards=2, device="cpu")
    got = sharded.analyze(tm.a_shard_reg())
    assert sharded.last_shard_count == 2
    serial = TorchEngine(tdb, device="cpu").analyze(tm.a_shard_reg())
    assert torch.equal(got, serial)
    ref = np.asarray(JaxEngine(jdb, n_shards=2).analyze(jm.a_shard_reg()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-4, atol=3e-5)


def test_a1_as_an_analyze_task_fails_alike(dbs):
    """A known fault of the reference, kept by the port: ``a1_regression``
    declares one input, so ``analyze`` refuses it (A1 runs through
    ``analytics.regression`` instead, as in the quickstart)."""
    jdb, tdb = dbs
    with pytest.raises(ValueError, match="REGRESSION needs") as jerr:
        JaxEngine(jdb).analyze(jm.a1_regression())
    with pytest.raises(ValueError, match="REGRESSION needs") as terr:
        TorchEngine(tdb, device="cpu").analyze(tm.a1_regression())
    assert str(jerr.value) == str(terr.value)


def test_reference_workload_replays_through_the_port(tmp_path):
    """A query/mutation/analyze stream recorded by the JAX package replays
    through the port's ``observe.replay`` with every captured fingerprint
    matched (strict) and the same write state at the end."""
    from repro_torch.core import observe
    path = str(tmp_path / "workload.jsonl")
    jdb = jm.generate(sf=1, seed=0)
    eng = JaxEngine(jdb)
    g = jdb.graphs["Interested_in"]
    with eng.record(path):
        eng.query(jm.q_g1())
        g.insert_edges({"svid": np.array([0, 1, 2], dtype=np.int64),
                        "tvid": np.array([1, 2, 3], dtype=np.int64),
                        "weight": np.array([0.5, 0.25, 0.75])})
        eng.query(jm.q_g1())
        g.delete_edges(np.asarray(g.live_edge_ids()[:2]))
        eng.analyze(jm.a3_multiply(), iters=3)
        jdb.touch_table("Orders")
        eng.query(jm.q_edge_scan())
    tdb = tm.generate(sf=1, seed=0)
    rep = observe.replay(tdb, path, strict=True, device="cpu")
    assert rep.ok
    assert (rep.queries, rep.analytics, rep.mutations) == (3, 1, 3)
    for name, jg in jdb.graphs.items():
        assert tdb.graphs[name].epoch == jg.epoch
    for name in jdb.tables:
        assert tdb.epoch_of(name) == jdb.epoch_of(name)
