"""Twins of ``tests/test_gnn.py`` on the port (the same hypothesis settings
and seeds: equivariance, SO(3) machinery, the feature-GNN train step with
the same learning rates, the sampler), and the port's GNN stack held
against the reference on the same inputs: ``so3``'s numpy tables
identical and its runtime at rtol 1e-5 / atol 1e-6; the graph generators
and ``NeighborSampler`` exact; the scatter reductions (empty segments and
ties, gradients included) and GatedGCN, PNA, MACE and EquiformerV2
(forward, loss, ``torch.autograd`` gradients against ``jax.grad``) in
fp32 at rtol 1e-4 / atol 1e-5, with the reference's weights carried over
by ``params_from_arrays``. GAT's parity is in
``test_torch_extra_archs.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import graphs as rgraphs
from repro.models.gnn import common as rcommon
from repro.models.gnn import equiformer_v2 as reqv2
from repro.models.gnn import gatedgcn as rgatedgcn
from repro.models.gnn import mace as rmace
from repro.models.gnn import pna as rpna
from repro.models.gnn import so3 as rso3
from repro_torch import configs
from repro_torch.data import graphs
from repro_torch.models.gnn import common
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn import gatedgcn, mace, pna, so3
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import tree_map
from torch_twin import assert_trees_close, host, port_params

RTOL, ATOL = 1e-4, 1e-5          # fp32 model parity
SO3_RTOL, SO3_ATOL = 1e-5, 1e-6  # so3 runtime parity
# PNA in float64: its std aggregator sqrt(max(E[m^2] - mean^2, 0) + 1e-10)
# is ill-conditioned in fp32 wherever a node's messages are all equal (one
# message; duplicate edges; a sampler drawing one neighbor f times): the
# difference cancels to a rounding residue of either sign, and a 1e-8
# residue moves std from 1e-5 to 1e-4. Both packages follow the formula,
# and their fp32 outputs and gradients differ there by up to ~1e-4 of
# scale (each as far from float64; on the smoke graph the reference's
# gradients 3.7e-4 off, the port's 1.2e-4), so PNA is held in float64.
# Its degree scalers stay fp32 in both (``degrees`` sums fp32 ones), and
# the two packages' fp32 logs differ by an ulp: hence 1e-5, not 1e-12
RTOL64, ATOL64 = 1e-5, 1e-8


def _random_graph3d(seed, n=16, e=48, n_species=8):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * 2
    src = rng.integers(0, n, e)
    dst = (src + rng.integers(1, n, e)) % n          # no self loops
    species = rng.integers(0, n_species, n)
    return pos, src, dst, species


def _rotation(seed):
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    return so3._rot_z(a) @ so3._rot_y(b) @ so3._rot_z(c)


def _graph(src, dst, pos, species):
    return GraphBatch(src=torch.as_tensor(src), dst=torch.as_tensor(dst),
                      pos=torch.as_tensor(pos, dtype=torch.float32),
                      species=torch.as_tensor(species))


def _gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# Twins of tests/test_gnn.py
# ---------------------------------------------------------------------------


@given(st.integers(0, 1000), st.integers(0, 1000))
@settings(max_examples=8, deadline=None)
def test_mace_rotation_invariance(gseed, rseed):
    pos, src, dst, species = _random_graph3d(gseed)
    R = _rotation(rseed)
    cfg = mace.MACEConfig(channels=8, n_species=8)
    p = mace.init_params(_gen(), cfg)
    e1 = mace.forward(p, _graph(src, dst, pos, species), cfg)
    e2 = mace.forward(p, _graph(src, dst, pos @ R.T, species), cfg)
    np.testing.assert_allclose(e1.detach(), e2.detach(), rtol=2e-3, atol=1e-4)


@given(st.integers(0, 1000), st.integers(0, 1000))
@settings(max_examples=5, deadline=None)
def test_eqv2_rotation_invariance(gseed, rseed):
    pos, src, dst, species = _random_graph3d(gseed)
    R = _rotation(rseed)
    cfg = eqv2.EquiformerV2Config(n_layers=2, channels=8, l_max=4, m_max=2,
                                  n_heads=4, n_species=8)
    p = eqv2.init_params(_gen(), cfg)
    e1 = eqv2.forward(p, _graph(src, dst, pos, species), cfg)
    e2 = eqv2.forward(p, _graph(src, dst, pos @ R.T, species), cfg)
    np.testing.assert_allclose(e1.detach(), e2.detach(), rtol=2e-3, atol=1e-4)


def test_mace_translation_invariance():
    pos, src, dst, species = _random_graph3d(3)
    cfg = mace.MACEConfig(channels=8, n_species=8)
    p = mace.init_params(_gen(), cfg)
    e1 = mace.forward(p, _graph(src, dst, pos, species), cfg)
    e2 = mace.forward(p, _graph(src, dst, pos + np.array([1.5, -2.0, 0.3]),
                                species), cfg)
    np.testing.assert_allclose(e1.detach(), e2.detach(), rtol=1e-4)


@given(st.integers(1, 6), st.integers(0, 500))
@settings(max_examples=15, deadline=None)
def test_wigner_rotates_sh(l, seed):
    """D(R) Y(x) == Y(R x) for the batched torch Wigner path."""
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    R = so3._rot_z(a) @ so3._rot_y(b) @ so3._rot_z(c)
    x = rng.standard_normal((6, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32)
    Y = so3.real_sph_harm(f32(x), l).numpy()
    Yr = so3.real_sph_harm(f32(x @ R.T), l).numpy()
    D = so3.wigner_from_rotation(f32([a]), f32([b]), f32([c]), l).numpy()[0]
    np.testing.assert_allclose(Yr, Y @ D.T, atol=5e-5)


@given(st.sampled_from([(1, 1, 0), (1, 1, 2), (2, 1, 1), (2, 2, 2)]),
       st.integers(0, 500))
@settings(max_examples=15, deadline=None)
def test_cg_equivariance(path, seed):
    l1, l2, l3 = path
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    R = so3._rot_z(a) @ so3._rot_y(b) @ so3._rot_z(c)
    C = so3.real_cg(l1, l2, l3)
    D1, D2, D3 = (so3.wigner_np(l, R) for l in (l1, l2, l3))
    va = rng.standard_normal(2 * l1 + 1)
    vb = rng.standard_normal(2 * l2 + 1)
    lhs = np.einsum("i,j,ijk->k", D1 @ va, D2 @ vb, C)
    rhs = D3 @ np.einsum("i,j,ijk->k", va, vb, C)
    np.testing.assert_allclose(lhs, rhs, atol=1e-8)


# pna's degree-scaler towers make the smoke loss surface sharper than
# gatedgcn's: a 0.5 full-batch step overshoots, so each arch gets an LR in
# its stable region (one SGD step must still strictly reduce the loss)
@pytest.mark.parametrize("mod,cfgmod,lr",
                         [(gatedgcn, "gatedgcn", 0.5), (pna, "pna", 0.1)])
def test_feature_gnn_train_step(mod, cfgmod, lr):
    cfg = configs.get(cfgmod).smoke_config()
    g, labels = graphs.random_feature_graph(60, 240, cfg.d_in, cfg.n_classes,
                                            seed=1, device="cpu")
    p = mod.init_params(_gen(), cfg)
    loss0, grads = value_and_grad(mod.loss_fn, p, g, labels, cfg)
    p2 = tree_map(lambda a, gr: a - lr * gr, p, grads)
    loss1 = float(mod.loss_fn(p2, g, labels, cfg))
    assert np.isfinite(float(loss0)) and loss1 < float(loss0)


def test_neighbor_sampler_static_shapes():
    rng = np.random.default_rng(0)
    n, e = 500, 4000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    lab = rng.integers(0, 4, n)
    s = graphs.NeighborSampler(n, src, dst, x, lab, fanouts=(4, 3), seed=0)
    shapes = set()
    for batch in range(3):
        seeds = rng.integers(0, n, 8)
        sub, slab = s.sample(seeds, device="cpu")
        shapes.add((sub.n_nodes, sub.n_edges, tuple(slab.shape)))
    assert len(shapes) == 1, "sampler must produce static shapes"
    nn = 8 * (1 + 4 + 12)
    assert shapes.pop() == (nn, 8 * 4 + 8 * 4 * 3, (nn,))


def test_sampled_edges_are_real():
    rng = np.random.default_rng(1)
    n, e = 200, 1000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    edge_set = set(zip(src.tolist(), dst.tolist()))
    x = np.zeros((n, 4), np.float32)
    lab = np.zeros(n, np.int64)
    s = graphs.NeighborSampler(n, src, dst, x, lab, fanouts=(5,), seed=0)
    seeds = rng.integers(0, n, 16)
    l1 = s._sample_layer(seeds, 5)
    for i, seed in enumerate(seeds):
        for nbr in l1[i]:
            if nbr >= 0:
                assert (int(nbr), int(seed)) in edge_set


# ---------------------------------------------------------------------------
# so3 against the reference
# ---------------------------------------------------------------------------


def test_so3_numpy_tables_identical():
    for l in range(7):
        for a, b in zip(so3.y_generator_eig(l), rso3.y_generator_eig(l)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(so3._y_gen_stack(6), rso3._y_gen_stack(6)):
        np.testing.assert_array_equal(a, b)
    for path in mace._paths(3):
        np.testing.assert_array_equal(so3.real_cg(*path), rso3.real_cg(*path))
    R = _rotation(7)
    for l in range(5):
        np.testing.assert_array_equal(so3.wigner_np(l, R), rso3.wigner_np(l, R))
    x = np.random.default_rng(2).standard_normal((9, 3))
    np.testing.assert_array_equal(so3._np_sh(x, 6), rso3._np_sh(x, 6))


def test_so3_tables_are_cached_per_device():
    """The torch copy of a table is made once per l_max and device."""
    assert so3._y_gen_tensors(3, torch.device("cpu")) \
        is so3._y_gen_tensors(3, torch.device("cpu"))
    assert so3.real_cg_tensor(1, 1, 2, torch.device("cpu")) \
        is so3.real_cg_tensor(1, 1, 2, torch.device("cpu"))


@pytest.mark.parametrize("l_max", [2, 6])
def test_so3_runtime_matches_reference(l_max):
    rng = np.random.default_rng(l_max)
    xyz = rng.standard_normal((12, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (3, 12)).astype(np.float32)

    def close(port, ref):
        np.testing.assert_allclose(host(port), np.asarray(ref),
                                   rtol=SO3_RTOL, atol=SO3_ATOL)
    close(so3.real_sph_harm(torch.as_tensor(xyz), l_max),
          rso3.real_sph_harm(jnp.asarray(xyz), l_max))
    close(so3.dz_blocks(torch.as_tensor(ang[0]), l_max),
          rso3.dz_blocks(jnp.asarray(ang[0]), l_max))
    close(so3.dy_batch(torch.as_tensor(ang[1]), l_max),
          rso3.dy_batch(jnp.asarray(ang[1]), l_max))
    close(so3.wigner_from_rotation(*map(torch.as_tensor, ang), l_max),
          rso3.wigner_from_rotation(*map(jnp.asarray, ang), l_max))
    r_hat = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    for p, r in zip(so3.align_to_z_angles(torch.as_tensor(r_hat)),
                    rso3.align_to_z_angles(jnp.asarray(r_hat))):
        close(p, r)
    feats = rng.standard_normal((12, so3.sh_dim(l_max), 3)).astype(np.float32)
    prot, pD = so3.rotate_to_edge_frame(torch.as_tensor(feats),
                                        torch.as_tensor(r_hat), l_max)
    rrot, rD = rso3.rotate_to_edge_frame(jnp.asarray(feats),
                                         jnp.asarray(r_hat), l_max)
    close(prot, rrot)
    close(pD, rD)
    close(so3.rotate_from_edge_frame(prot, pD),
          rso3.rotate_from_edge_frame(rrot, rD))


# ---------------------------------------------------------------------------
# the data pipeline against the reference
# ---------------------------------------------------------------------------


def _same_batch(port_g, ref_g):
    for f in ("src", "dst", "x", "edge_attr", "pos", "species", "node_mask",
              "edge_mask", "graph_id"):
        a, b = getattr(port_g, f), getattr(ref_g, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert host(a).dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(host(a), np.asarray(b), err_msg=f)
    assert port_g.n_graphs == ref_g.n_graphs


@pytest.mark.parametrize("gen,args", [
    ("random_feature_graph", (50, 200, 6, 3, 4)),
    ("random_molecule_batch", (3, 7, 12, 5, 2)),
    ("random_geometric_graph", (40, 90, 6, 1)),
])
def test_graph_generators_match_reference(gen, args):
    pg, plab = getattr(graphs, gen)(*args, device="cpu")
    rg, rlab = getattr(rgraphs, gen)(*args)
    _same_batch(pg, rg)
    assert host(plab).dtype == np.asarray(rlab).dtype
    np.testing.assert_array_equal(host(plab), np.asarray(rlab))


def test_graph_generators_need_a_card_unless_told(monkeypatch):
    """No device named and no card: the call raises; it never falls back
    to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graphs.random_feature_graph(10, 20, 3, 2)
    s = graphs.NeighborSampler(10, np.arange(10), np.arange(10)[::-1],
                               np.zeros((10, 2), np.float32), np.zeros(10),
                               fanouts=(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        s.sample(np.arange(3))


def _sampler_case(fanouts=(4, 3), seed=0, e=1500):
    rng = np.random.default_rng(5)
    n = 300
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    lab = rng.integers(0, 3, n)
    return (graphs.NeighborSampler(n, src, dst, x, lab, fanouts, seed),
            rgraphs.NeighborSampler(n, src, dst, x, lab, fanouts, seed))


def test_neighbor_sampler_matches_reference_bit_for_bit():
    """Three batches in a row: the same numpy draws in the same order,
    so every subgraph and its labels (-1 off the seeds) are equal."""
    ps, rs = _sampler_case()
    rng = np.random.default_rng(9)
    for _ in range(3):
        seeds = rng.integers(0, 300, 10)
        pg, plab = ps.sample(seeds, device="cpu")
        rg, rlab = rs.sample(seeds)
        _same_batch(pg, rg)
        np.testing.assert_array_equal(host(plab), np.asarray(rlab))
        assert (host(plab)[10:] == -1).all()


def test_graph_batch_to_device():
    g, _ = graphs.random_molecule_batch(2, 5, 6, device="cpu")
    h = g.to("cpu")
    assert h.n_graphs == 2 and h.x is None
    for f in ("src", "dst", "pos", "species", "graph_id"):
        assert torch.equal(getattr(h, f), getattr(g, f))


# ---------------------------------------------------------------------------
# scatter reductions: empty segments and ties, gradients included
# ---------------------------------------------------------------------------


def test_scatter_max_min_empty_segments_and_ties():
    """Segments 3 and 4 are empty (-inf / +inf, as ``segment_max`` /
    ``segment_min``); segment 0 has a three-way tie in column 0 and
    segment 1 a two-way tie, whose gradient both packages split evenly."""
    m = np.array([[1.0, 2.0], [1.0, -3.0], [1.0, 0.5], [4.0, 4.0],
                  [4.0, -1.0], [-2.0, 7.0], [0.25, 0.25]], np.float32)
    dst = np.array([0, 0, 0, 1, 1, 2, 2], np.int32)
    w = np.random.default_rng(0).standard_normal((5, 2)).astype(np.float32)
    for pfn, rfn in ((common.scatter_max, rcommon.scatter_max),
                     (common.scatter_min, rcommon.scatter_min)):
        pm = torch.as_tensor(m).requires_grad_(True)
        pout = pfn(pm, torch.as_tensor(dst), 5)
        rout = rfn(jnp.asarray(m), jnp.asarray(dst), 5)
        np.testing.assert_array_equal(host(pout), np.asarray(rout))

        def rloss(mm, rfn=rfn):
            o = rfn(mm, jnp.asarray(dst), 5)
            return jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0) * w)
        pl = torch.sum(torch.where(torch.isfinite(pout), pout, 0.0)
                       * torch.as_tensor(w))
        (pg,) = torch.autograd.grad(pl, pm)
        np.testing.assert_allclose(pg.numpy(),
                                   np.asarray(jax.grad(rloss)(jnp.asarray(m))),
                                   rtol=RTOL, atol=ATOL)
    assert pout[3:].isinf().all()


def test_scatter_sum_mean_softmax_pool_match_reference():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((20, 3)).astype(np.float32)
    dst = rng.integers(0, 8, 20).astype(np.int32)      # some nodes empty
    mask = (rng.random(20) > 0.3).astype(np.float32)
    gid = np.repeat(np.arange(2), 4).astype(np.int32)
    pm, pd = torch.as_tensor(m), torch.as_tensor(dst)
    jm, jd = jnp.asarray(m), jnp.asarray(dst)
    pairs = [
        (common.scatter_sum(pm, pd, 8), rcommon.scatter_sum(jm, jd, 8)),
        (common.scatter_mean(pm, pd, 8), rcommon.scatter_mean(jm, jd, 8)),
        (common.scatter_softmax(pm, pd, 8), rcommon.scatter_softmax(jm, jd, 8)),
        (common.degrees(pd, 8, torch.as_tensor(mask)),
         rcommon.degrees(jd, 8, jnp.asarray(mask))),
    ]
    for mode in ("sum", "mean"):
        pairs.append((common.graph_pool(pm[:8], torch.as_tensor(gid), 2,
                                        torch.as_tensor(mask[:8]), mode),
                      rcommon.graph_pool(jm[:8], jnp.asarray(gid), 2,
                                         jnp.asarray(mask[:8]), mode)))
    for p, r in pairs:
        np.testing.assert_allclose(host(p), np.asarray(r), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# models against the reference: forward, loss and gradients
# ---------------------------------------------------------------------------


def _ref_value_and_grad(rmod, rp, rg, labels, rcfg):
    return jax.jit(jax.value_and_grad(
        lambda pp: rmod.loss_fn(pp, rg, labels, rcfg)))(rp)


def _port_cfg(mod, rcfg):
    cls = type(rcfg).__name__
    return getattr(mod, cls)(**dataclasses.asdict(rcfg))


def _check_model(mod, rmod, rcfg, rg, pg, rlab, plab, f64=False):
    """Forward, loss and gradients in fp32 (RTOL, ATOL), or, with ``f64``,
    all three in float64 on both sides (RTOL64, ATOL64)."""
    cfg = _port_cfg(mod, rcfg)
    rp = rmod.init_params(jax.random.PRNGKey(0), rcfg)
    pp = port_params(rp)
    rtol, atol = (RTOL64, ATOL64) if f64 else (RTOL, ATOL)
    with jax.enable_x64(f64):
        if f64:
            rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), rp)
            rg = dataclasses.replace(rg, x=jnp.asarray(rg.x, jnp.float64))
            pp = tree_map(lambda t: t.double(), pp)
            pg = dataclasses.replace(pg, x=pg.x.double())
        rout = np.asarray(jax.jit(lambda p: rmod.forward(p, rg, rcfg))(rp))
        rloss, rgrads = _ref_value_and_grad(rmod, rp, rg, rlab, rcfg)
        rloss, rgrads = float(rloss), jax.tree.map(np.asarray, rgrads)
    np.testing.assert_allclose(host(mod.forward(pp, pg, cfg)), rout,
                               rtol=rtol, atol=atol)
    ploss, pgrads = value_and_grad(mod.loss_fn, pp, pg, plab, cfg)
    np.testing.assert_allclose(float(ploss), rloss, rtol=rtol, atol=atol)
    assert_trees_close(pgrads, rgrads, rtol, atol)


def _feature_pair(cfg, seed=2):
    rg, rlab = rgraphs.random_feature_graph(30, 120, cfg.d_in, cfg.n_classes,
                                            seed=seed)
    pg, plab = graphs.random_feature_graph(30, 120, cfg.d_in, cfg.n_classes,
                                           seed=seed, device="cpu")
    return rg, pg, rlab, plab


@pytest.mark.parametrize("mod,rmod,name", [(gatedgcn, rgatedgcn, "gatedgcn"),
                                           (pna, rpna, "pna")])
def test_feature_gnn_matches_reference(mod, rmod, name):
    from repro import configs as rconfigs
    rcfg = rconfigs.get(name).smoke_config()
    _check_model(mod, rmod, rcfg, *_feature_pair(rcfg), f64=name == "pna")


@pytest.mark.parametrize("mod,rmod,name", [(gatedgcn, rgatedgcn, "gatedgcn"),
                                           (pna, rpna, "pna")])
def test_feature_gnn_on_a_sampled_batch_matches_reference(mod, rmod, name):
    """A ``NeighborSampler`` batch: every node but the seeds has label -1
    (gathered at class 0 and masked in the port, wrapped and masked in
    the reference), padded nodes and edges are masked, and PNA's masked
    messages are exact zeros, so its max/min meet real ties."""
    from repro import configs as rconfigs
    rcfg = dataclasses.replace(rconfigs.get(name).smoke_config(), d_in=6,
                               n_classes=3)
    ps, rs = _sampler_case(fanouts=(4, 3), e=500)  # many nodes of degree 0
    seeds = np.random.default_rng(4).integers(0, 300, 6)
    pg, plab = ps.sample(seeds, device="cpu")
    rg, rlab = rs.sample(seeds)
    assert (host(plab) == -1).any() and (host(pg.edge_mask) == 0).any()
    _check_model(mod, rmod, rcfg, rg, pg, rlab, plab, f64=name == "pna")


def _molecule_pair(n_species):
    rg, ren = rgraphs.random_molecule_batch(3, 8, 16, n_species=n_species,
                                            seed=1)
    pg, pen = graphs.random_molecule_batch(3, 8, 16, n_species=n_species,
                                           seed=1, device="cpu")
    return rg, pg, ren, pen


def test_mace_matches_reference():
    rcfg = rmace.MACEConfig(name="mace-parity", n_layers=2, channels=8,
                            l_max=2, correlation=3, n_rbf=4, n_species=5)
    _check_model(mace, rmace, rcfg, *_molecule_pair(5))


def test_equiformer_v2_matches_reference():
    rcfg = reqv2.EquiformerV2Config(name="eqv2-parity", n_layers=2,
                                    channels=8, l_max=3, m_max=2, n_heads=4,
                                    n_species=5)
    _check_model(eqv2, reqv2, rcfg, *_molecule_pair(5))


def test_equiformer_v2_channel_sharding_waits_for_the_mesh():
    """Channel sharding, which waited for the mesh layer, is a layout pin:
    on plain tensors the forward with ``channel_shard_axis`` set equals the
    one without (and the reference's forward without a mesh), and on a 1x1
    gloo mesh a DTensor comes out with its channels over 'model' and its
    values unchanged."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_local_mesh
    from torch_spawn import world_of_one

    cfg = eqv2.EquiformerV2Config(n_layers=1, channels=8, l_max=2,
                                  n_heads=4, n_species=4,
                                  channel_shard_axis="model")
    p = eqv2.init_params(_gen(), cfg)
    g, _ = graphs.random_molecule_batch(1, 4, 6, n_species=4, device="cpu")
    plain = dataclasses.replace(cfg, channel_shard_axis="")
    assert torch.equal(eqv2.forward(p, g, cfg), eqv2.forward(p, g, plain))
    h = torch.randn(4, 9, 8, generator=_gen())
    with world_of_one():
        mesh = make_local_mesh(1, 1, device="cpu")
        hd = distribute_tensor(h, mesh, placements(P(), mesh))
        pinned = eqv2._cshard(cfg, hd)
        assert tuple(str(x) for x in pinned.placements) == ("R", "S(2)")
        assert torch.equal(pinned.full_tensor(), h)