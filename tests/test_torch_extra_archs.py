"""Twins of ``tests/test_extra_archs.py`` on the port (GAT: SDDMM/edge-
softmax regime; DCN-v2: low-rank cross network — smoke + learning tests),
and both held against the reference: GAT (v1 and v2, on a full graph and
on a sampled batch with masked edges and -1 labels) and DCN-v2 (forward,
loss, ``torch.autograd`` gradients against ``jax.grad``) in fp32 at rtol
1e-4 / atol 1e-5, with the reference's weights carried over by
``params_from_arrays``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as rgraphs
from repro.models import dcn_v2 as rdcn
from repro.models.gnn import gat as rgat
from repro_torch.data.graphs import NeighborSampler, random_feature_graph
from repro_torch.models import dcn_v2
from repro_torch.models.dcn_v2 import DCNv2Config
from repro_torch.models.gnn import gat
from repro_torch.models.gnn.gat import GATConfig
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import tree_map
from torch_twin import assert_trees_close, host, port_params

RTOL, ATOL = 1e-4, 1e-5


def _gen():
    return torch.Generator().manual_seed(0)


def test_gat_smoke_and_learns():
    cfg = GATConfig(n_layers=2, d_hidden=16, n_heads=4, d_in=24, n_classes=4)
    g, labels = random_feature_graph(60, 240, 24, 4, seed=3, device="cpu")
    p = gat.init_params(_gen(), cfg)
    logits = gat.forward(p, g, cfg)
    assert logits.shape == (60, 4)
    assert bool(torch.isfinite(logits).all())
    loss0 = float(gat.loss_fn(p, g, labels, cfg))
    for _ in range(8):
        _, gr = value_and_grad(gat.loss_fn, p, g, labels, cfg)
        p = tree_map(lambda a, b: a - 0.3 * b, p, gr)
    assert float(gat.loss_fn(p, g, labels, cfg)) < loss0


def test_gat_v1_variant():
    cfg = GATConfig(n_layers=1, d_hidden=8, n_heads=2, d_in=8, n_classes=3,
                    v2=False)
    g, labels = random_feature_graph(20, 60, 8, 3, seed=4, device="cpu")
    p = gat.init_params(_gen(), cfg)
    assert bool(torch.isfinite(gat.forward(p, g, cfg)).all())


def test_dcn_v2_smoke_and_learns():
    cfg = DCNv2Config(vocab_per_field=500, embed_dim=4, n_sparse=6,
                      n_dense=3, cross_rank=8, mlp=(16, 8))
    p = dcn_v2.init_params(_gen(), cfg)
    batch = dcn_v2.random_batch(cfg, 128, seed=5, device="cpu")
    sig = (batch["sparse"][:, 0] % 2).float()
    batch = dict(batch, labels=sig)
    loss0 = float(dcn_v2.loss_fn(p, batch, cfg))
    for _ in range(60):
        _, gr = value_and_grad(dcn_v2.loss_fn, p, batch, cfg)
        p = tree_map(lambda a, b: a - 0.5 * b, p, gr)
    assert float(dcn_v2.loss_fn(p, batch, cfg)) < loss0 - 0.02


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _gat_cfgs(**kw):
    rcfg = rgat.GATConfig(**kw)
    return rcfg, GATConfig(**dataclasses.asdict(rcfg))


def _check_gat(rcfg, cfg, rg, pg, rlab, plab):
    rp = rgat.init_params(jax.random.PRNGKey(0), rcfg)
    pp = port_params(rp)
    np.testing.assert_allclose(
        host(gat.forward(pp, pg, cfg)),
        np.asarray(jax.jit(lambda p: rgat.forward(p, rg, rcfg))(rp)),
        rtol=RTOL, atol=ATOL)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rgat.loss_fn(p, rg, rlab, rcfg)))(rp)
    ploss, pgrads = value_and_grad(gat.loss_fn, pp, pg, plab, cfg)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert_trees_close(pgrads, rgrads, RTOL, ATOL)


@pytest.mark.parametrize("v2", [True, False])
def test_gat_matches_reference(v2):
    rcfg, cfg = _gat_cfgs(n_layers=2, d_hidden=16, n_heads=4, d_in=12,
                          n_classes=3, v2=v2)
    rg, rlab = rgraphs.random_feature_graph(40, 150, 12, 3, seed=6)
    pg, plab = random_feature_graph(40, 150, 12, 3, seed=6, device="cpu")
    _check_gat(rcfg, cfg, rg, pg, rlab, plab)


@pytest.mark.parametrize("v2", [True, False])
def test_gat_on_a_sampled_batch_matches_reference(v2):
    """Masked edges score -1e30 (a node whose incoming edges are all
    masked ties them in the edge softmax's max), and every node but the
    seeds has label -1."""
    rcfg, cfg = _gat_cfgs(n_layers=2, d_hidden=8, n_heads=2, d_in=5,
                          n_classes=3, v2=v2)
    rng = np.random.default_rng(8)
    n, e = 200, 300
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    lab = rng.integers(0, 3, n)
    seeds = rng.integers(0, n, 5)
    pg, plab = NeighborSampler(n, src, dst, x, lab, (3, 2), 1).sample(
        seeds, device="cpu")
    rg, rlab = rgraphs.NeighborSampler(n, src, dst, x, lab, (3, 2),
                                       1).sample(seeds)
    assert (host(pg.edge_mask) == 0).any() and (host(plab) == -1).any()
    _check_gat(rcfg, cfg, rg, pg, rlab, plab)


def test_dcn_v2_matches_reference():
    rcfg = rdcn.DCNv2Config(vocab_per_field=300, embed_dim=4, n_sparse=5,
                            n_dense=3, cross_rank=6, mlp=(16, 8))
    cfg = DCNv2Config(**dataclasses.asdict(rcfg))
    rb = rdcn.random_batch(rcfg, 64, seed=2)
    pb = dcn_v2.random_batch(cfg, 64, seed=2, device="cpu")
    for k in rb:
        np.testing.assert_array_equal(host(pb[k]), np.asarray(rb[k]))
    rp = rdcn.init_params(jax.random.PRNGKey(0), rcfg)
    pp = port_params(rp)
    np.testing.assert_allclose(
        host(dcn_v2.forward(pp, pb["dense"], pb["sparse"], cfg)),
        np.asarray(rdcn.forward(rp, rb["dense"], rb["sparse"], rcfg)),
        rtol=RTOL, atol=ATOL)
    rloss, rgrads = jax.value_and_grad(rdcn.loss_fn)(rp, rb, rcfg)
    ploss, pgrads = value_and_grad(dcn_v2.loss_fn, pp, pb, cfg)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=RTOL,
                               atol=ATOL)
    assert_trees_close(pgrads, rgrads, RTOL, ATOL)


def test_dcn_v2_out_of_range_id_raises():
    """Kept difference: an id past the vocabulary raises in the port;
    the reference's ``jnp.take`` returns a NaN row."""
    rcfg = rdcn.DCNv2Config(vocab_per_field=50, embed_dim=2, n_sparse=3,
                            n_dense=2, cross_rank=2, mlp=(4,))
    cfg = DCNv2Config(**dataclasses.asdict(rcfg))
    rb = rdcn.random_batch(rcfg, 4, seed=0)
    sparse = np.asarray(rb["sparse"]).copy()
    sparse[1, 2] = 50
    rp = rdcn.init_params(jax.random.PRNGKey(0), rcfg)
    out = np.asarray(rdcn.forward(rp, rb["dense"], jnp.asarray(sparse), rcfg))
    assert np.isnan(out[1]) and np.isfinite(np.delete(out, 1)).all()
    with pytest.raises(IndexError):
        dcn_v2.forward(port_params(rp), torch.as_tensor(np.asarray(rb["dense"])),
                       torch.as_tensor(sparse), cfg)
