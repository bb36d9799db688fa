"""The port's Wide & Deep (``models.recsys``) and ``distributed.elastic``
held against the reference on the same inputs, with the reference's
weights carried over by ``params_from_arrays``: ``random_batch`` and the
wide ids of ``_hash_cross`` exact (bit for bit, also at ids near 2**31 and
negative ones); ``forward``, ``user_tower``, ``serve_step``, the loss and
its ``torch.autograd`` gradients against ``jax.grad`` in fp32 at rtol 1e-4
/ atol 1e-5; ``retrieval_step``'s top-k with ties in ``lax.top_k``'s order
(the lower index first). Kept differences, pinned: an id past the
vocabulary raises in the port where the reference returns a NaN row; the
mesh forms raise, naming ROADMAP item 11."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import elastic as relastic
from repro.models import recsys as rrecsys
from repro_torch import configs
from repro_torch.distributed import elastic
from repro_torch.models import recsys
from repro_torch.train.loop import value_and_grad
from torch_twin import assert_trees_close, host, port_params

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def both():
    rcfg = ref_configs.get("wide_deep").smoke_config()
    cfg = configs.get("wide_deep").smoke_config()
    rp = rrecsys.init_params(jax.random.PRNGKey(0), rcfg)
    # a nonzero wide table, so the wide logit's gather is tested too
    rp["wide"] = jax.random.normal(jax.random.PRNGKey(1), rp["wide"].shape)
    return rcfg, cfg, rp, port_params(rp)


def _batches(rcfg, cfg, n, seed):
    rb = rrecsys.random_batch(rcfg, n, seed=seed)
    pb = recsys.random_batch(cfg, n, seed=seed, device="cpu")
    return rb, pb


def test_random_batch_matches_reference(both):
    rcfg, cfg, _, _ = both
    rb, pb = _batches(rcfg, cfg, 50, 3)
    for k in rb:
        assert host(pb[k]).dtype == np.asarray(rb[k]).dtype, k
        np.testing.assert_array_equal(host(pb[k]), np.asarray(rb[k]))


def test_random_batch_needs_a_card_unless_told(monkeypatch, both):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.random_batch(both[1], 4)


@pytest.mark.parametrize("wide_hash", [512, 1_000_000, 2 ** 31 - 1])
def test_hash_cross_bit_for_bit(wide_hash):
    rng = np.random.default_rng(wide_hash)
    ids = np.concatenate([
        rng.integers(0, 1_000_000, (64, 6)),
        rng.integers(2 ** 31 - 5000, 2 ** 31, (8, 6)),   # a*k wraps 2**32
        rng.integers(-2 ** 31, 0, (8, 6)),               # uint32 of int32
    ]).astype(np.int32)
    want = np.asarray(rrecsys._hash_cross(jnp.asarray(ids), wide_hash))
    got = recsys._hash_cross(torch.as_tensor(ids), wide_hash)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_tower_serve_loss_and_grads_match_reference(both):
    rcfg, cfg, rp, pp = both
    rb, pb = _batches(rcfg, cfg, 48, 5)
    pairs = [
        (recsys.forward(pp, pb["dense"], pb["sparse"], cfg),
         rrecsys.forward(rp, rb["dense"], rb["sparse"], rcfg)),
        (recsys.user_tower(pp, pb["dense"], pb["sparse"], cfg),
         rrecsys.user_tower(rp, rb["dense"], rb["sparse"], rcfg)),
        (recsys.serve_step(pp, pb["dense"], pb["sparse"], cfg),
         rrecsys.serve_step(rp, rb["dense"], rb["sparse"], rcfg)),
    ]
    for p, r in pairs:
        np.testing.assert_allclose(host(p), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    rloss, rgrads = jax.value_and_grad(rrecsys.loss_fn)(rp, rb, rcfg)
    ploss, pgrads = value_and_grad(recsys.loss_fn, pp, pb, cfg)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert_trees_close(pgrads, rgrads, RTOL, ATOL)
    # the tables' gradient is dense, as the reference's
    assert pgrads["tables"].layout == torch.strided
    assert pgrads["tables"].shape == (cfg.n_sparse, cfg.vocab_per_field,
                                      cfg.embed_dim)


def test_retrieval_step_matches_reference_with_ties(both):
    """40 distinct candidates, each three times in shuffled places:
    equal scores come out lower index first, as in ``lax.top_k``."""
    rcfg, cfg, rp, pp = both
    rb, pb = _batches(rcfg, cfg, 3, 7)
    rng = np.random.default_rng(11)
    base = rng.standard_normal((40, cfg.tower_dim)).astype(np.float32)
    cands = base[rng.permutation(np.repeat(np.arange(40), 3))]
    rv, ri = rrecsys.retrieval_step(rp, rb["dense"], rb["sparse"],
                                    jnp.asarray(cands), rcfg, top_k=20)
    pv, pi = recsys.retrieval_step(pp, pb["dense"], pb["sparse"],
                                   torch.as_tensor(cands), cfg, top_k=20)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=RTOL,
                               atol=ATOL)
    for row, idx in zip(pv.numpy(), pi.numpy()):     # ties really met
        for a, b, x, y in zip(row, row[1:], idx, idx[1:]):
            assert a > b or (a == b and x < y)
        assert len(set(row.tolist())) < len(row)


def test_out_of_range_id_raises(both):
    """Kept difference: an id past the vocabulary raises in the port (on
    the card it would fire a device-side assert); the reference's
    ``jnp.take`` returns a NaN row. A negative id counts from the end in
    both."""
    rcfg, cfg, rp, pp = both
    rb, pb = _batches(rcfg, cfg, 4, 1)
    bad = np.asarray(rb["sparse"]).copy()
    bad[2, 3] = cfg.vocab_per_field
    out = np.asarray(rrecsys.forward(rp, rb["dense"], jnp.asarray(bad), rcfg))
    assert np.isnan(out[2]) and np.isfinite(np.delete(out, 2)).all()
    with pytest.raises(IndexError):
        recsys.forward(pp, pb["dense"], torch.as_tensor(bad), cfg)
    neg = np.asarray(rb["sparse"]).copy()
    neg[0, 0] = -1
    np.testing.assert_allclose(
        host(recsys.forward(pp, pb["dense"], torch.as_tensor(neg), cfg)),
        np.asarray(rrecsys.forward(rp, rb["dense"], jnp.asarray(neg), rcfg)),
        rtol=RTOL, atol=ATOL)


def test_mesh_forms_wait_for_the_mesh(both):
    """The mesh forms that waited for the mesh layer now run: on a 1x1
    gloo mesh of this process, the hierarchical retrieval gives the
    reference's single-device top-k, ``reshard_state`` places a leaf as a
    DTensor and gathers it back, and ``build_cell`` builds the Wide & Deep
    serving cell (tests/test_torch_mesh.py and test_torch_dryrun.py hold
    them on 8 ranks and on the production mesh)."""
    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import Cell
    from torch_spawn import world_of_one

    rcfg, cfg, rp, pp = both
    rb, pb = _batches(rcfg, cfg, 3, seed=11)
    cands = np.random.default_rng(12).standard_normal(
        (64, rcfg.tower_dim)).astype(np.float32)
    rv, ri = rrecsys.retrieval_step(rp, rb["dense"], rb["sparse"],
                                    jnp.asarray(cands), rcfg, top_k=8)
    with world_of_one():
        mesh = make_local_mesh(1, 1, device="cpu")
        v, i = recsys.retrieval_step_distributed(
            pp, pb["dense"], pb["sparse"],
            torch.from_numpy(cands).to(torch.bfloat16), cfg, mesh, top_k=8)
        for b in range(3):
            overlap = len(set(np.asarray(ri[b]).tolist())
                          & set(i[b].tolist())) / 8
            assert overlap >= 0.85, overlap
        state = {"w": torch.arange(6.0).reshape(2, 3)}
        out = elastic.reshard_state(
            state, {"w": (mesh, placements(P("data", "model"), mesh))})
        assert torch.equal(out["w"].to_local(), state["w"])
        np.testing.assert_array_equal(elastic.host_gather(out)["w"],
                                      state["w"].numpy())
        cell = recsys.build_cell("wide_deep", "serve_p99",
                                 configs.get("wide_deep").SHAPES["serve_p99"],
                                 mesh, Cell)
        assert cell.kind == "recsys_serve" and cell.meta["batch"] == 512


def test_elastic_matches_reference():
    for gb, old, new in [(64, 4, 3), (10, 2, 4), (7, 1, 8), (512, 8, 8)]:
        assert elastic.rebalanced_batch_size(gb, old, new) \
            == relastic.rebalanced_batch_size(gb, old, new)
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": [torch.ones(2, dtype=torch.int32), None]}
    host_state = elastic.host_gather(state)
    assert isinstance(host_state["a"], np.ndarray)
    host_state["a"][0, 0] = 9.0                      # a copy, not a view
    assert float(state["a"][0, 0]) == 0.0
    out = elastic.reshard_state(state, {"a": "cpu", "b": ["cpu", None]})
    assert torch.equal(out["a"], state["a"]) and out["b"][1] is None
    assert out["b"][0].dtype == torch.int32
