"""The port's LM transformer held against the JAX package's.

The reference's parameters (``init_params`` from a JAX key, as numpy
arrays) are carried into the port through ``params_from_arrays``, and the
same numpy tokens go through both ``forward``s. Tolerances: fp32 rtol 3e-4
/ atol 3e-5 elementwise (the kernel sweep's). bf16 at 2e-2 of the output's
scale, max |port - reference| <= 2e-2 * max |reference|: XLA on the CPU
rounds every elementwise op of a bf16 chain (sigmoid as neg, exp, add, div)
where PyTorch rounds once per op, so a few elements in a hundred differ by
a few bf16 ulps after two layers and an elementwise 2e-2 fails on values
near 0. MoE: logits 1e-4 and aux loss 1e-5 in fp32 (the routing must
agree exactly for that, ties included). Also twins of
``tests/test_transformer.py`` on the port alone, the cache-update clamp at
the ``max_len`` boundary, and the parts that are not ported yet raising."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtf
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import (TransformerConfig, cast_params,
                                            forward, init_cache, init_params,
                                            params_from_arrays, serve_step)
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.train import optimizer

MOE_ARCHS = ["olmoe_1b_7b", "granite_moe_1b_a400m"]
ARCHS = MOE_ARCHS + ["qwen2_1_5b", "stablelm_3b", "starcoder2_3b"]
BF16_SCALE_TOL = 2e-2


def ref_config(cfg: TransformerConfig, dtype: str) -> jtf.TransformerConfig:
    """The reference's config with the port config's fields."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)
              if f.name != "dtype"}
    return jtf.TransformerConfig(**fields, dtype=getattr(jnp, dtype))


def both_params(jcfg):
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_arrays(jax.tree.map(np.asarray, jp))


def assert_close(got: torch.Tensor, want, dtype: str):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    else:
        assert got.shape == want.shape
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= BF16_SCALE_TOL * scale, (err, scale)


@pytest.mark.parametrize("arch,impl,dtype", [
    (arch, impl, dtype) for arch in ARCHS
    for impl in ("chunked", "dense", "flash")
    for dtype in ("float32", "bfloat16")
    # bf16 MoE: test_moe_bf16_matches_reference_where_routing_agrees
    if not (arch in MOE_ARCHS and dtype == "bfloat16")])
def test_forward_matches_reference(arch, impl, dtype):
    """Full forward, then a cached prefill and one decode step: logits and
    the written cache agree with the reference on the same weights."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=getattr(torch, dtype), attn_impl=impl,
                              q_chunk=8, kv_chunk=8)
    jcfg = ref_config(cfg, dtype)
    jp, tp = both_params(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)

    want, want_aux = jtf.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = forward(tp, torch.as_tensor(toks), cfg)
    assert got.dtype == cfg.dtype and aux.dtype == torch.float32
    assert (float(aux) > 0.0) == cfg.is_moe
    assert_close(got, want, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    jc = jtf.init_cache(jcfg, 2, 24)
    jl, jc = jtf.forward(jp, jnp.asarray(toks), jcfg, cache=jc,
                         cache_lengths=jnp.zeros(2, jnp.int32))
    jn, jc = jtf.serve_step(jp, jc, jnp.asarray(nxt),
                            jnp.full(2, 20, jnp.int32), jcfg)
    tc = init_cache(cfg, 2, 24)
    tl, tc = forward(tp, torch.as_tensor(toks), cfg, cache=tc,
                     cache_lengths=torch.zeros(2, dtype=torch.int32))
    assert_close(tl, jl, dtype)
    tn, tc = serve_step(tp, tc, torch.as_tensor(nxt),
                        torch.full((2,), 20, dtype=torch.int32), cfg)
    assert_close(tn, jn, dtype)
    for name in ("k", "v"):
        assert_close(tc[name], jc[name], dtype)


CFG = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=211, qkv_bias=True,
                        dtype=torch.float32, q_chunk=16, kv_chunk=16)


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), CFG)


def _tokens(seed, shape, vocab=CFG.vocab):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, vocab,
                                                                 shape))


def test_chunked_equals_dense(params):
    toks = _tokens(1, (2, 40))
    l1, _ = forward(params, toks, CFG)  # chunked
    l2, _ = forward(params, toks, dataclasses.replace(CFG, attn_impl="dense"))
    torch.testing.assert_close(l1, l2, rtol=1e-4, atol=1e-4)


def test_ragged_lengths_mask(params):
    """Positions beyond `lengths` must not influence earlier logits."""
    cfg = dataclasses.replace(CFG, attn_impl="dense")
    toks = _tokens(2, (1, 16))
    toks2 = toks.clone()
    toks2[:, 12:] = 7  # change the padding region
    lens = torch.tensor([12], dtype=torch.int32)
    l1, _ = forward(params, toks, cfg, lengths=lens)
    l2, _ = forward(params, toks2, cfg, lengths=lens)
    torch.testing.assert_close(l1[:, :12], l2[:, :12], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_decode_equals_full(params, impl):
    cfg = dataclasses.replace(CFG, attn_impl=impl)
    toks = _tokens(3, (2, 24))
    nxt = _tokens(4, (2, 1))
    full, _ = forward(params, torch.cat([toks, nxt], 1), cfg)
    cache = init_cache(cfg, 2, 32)
    logits_p, cache = forward(params, toks, cfg, cache=cache,
                              cache_lengths=torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(logits_p, full[:, :24], rtol=2e-4, atol=2e-4)
    nl, cache = serve_step(params, cache, nxt,
                           torch.full((2,), 24, dtype=torch.int32), cfg)
    torch.testing.assert_close(nl, full[:, 24], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_cache_write_clamps_like_dynamic_update_slice(impl):
    """cache_lengths + S > max_len: the reference's dynamic_update_slice
    clamps the start into [0, M - S]; the port writes the same cache and
    gives the same logits (row 0 overflows, row 1 does not)."""
    cfg = dataclasses.replace(CFG, attn_impl=impl)
    jcfg = ref_config(cfg, "float32")
    jp, tp = both_params(jcfg)
    M, S = 16, 6
    rng = np.random.default_rng(5)
    cache0 = {n: rng.standard_normal((2, 2, 2, M, 16)).astype(np.float32)
              for n in ("k", "v")}
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    starts = np.array([13, 4], np.int32)
    jl, jc = jtf.forward(jp, jnp.asarray(toks), jcfg,
                         cache={n: jnp.asarray(a) for n, a in cache0.items()},
                         cache_lengths=jnp.asarray(starts))
    tl, tc = forward(tp, torch.as_tensor(toks), cfg,
                     cache={n: torch.tensor(a) for n, a in cache0.items()},
                     cache_lengths=torch.as_tensor(starts))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=3e-4, atol=3e-5)
        # row 0 was written at the clamped start M - S, row 1 at 4
        assert not np.allclose(tc[name][:, 0, :, M - S:].numpy(),
                               cache0[name][:, 0, :, M - S:])
        np.testing.assert_array_equal(tc[name][:, 0, :, :M - S].numpy(),
                                      cache0[name][:, 0, :, :M - S])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-4,
                               atol=3e-5)


def test_cast_once_is_bit_identical(params):
    """Casting the weights once ahead of serving gives exactly the logits
    of casting them at every use."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16, attn_impl="flash")
    toks = _tokens(6, (2, 12))
    cast = cast_params(params, cfg)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["ln1"].dtype == torch.float32
    a, _ = forward(params, toks, cfg)
    b, _ = forward(cast, toks, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cast_once_is_bit_identical_moe(arch):
    """The same for the MoE configs, logits and aux loss: the router stays
    fp32, so the routing is the fp32 master's."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=torch.bfloat16, attn_impl="flash")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = _tokens(6, (2, 12), cfg.vocab)
    cast = cast_params(params, cfg)
    assert cast["layers"]["router"].dtype == torch.float32
    assert cast["layers"]["w_in"].dtype == torch.bfloat16
    a, aux_a = forward(params, toks, cfg)
    b, aux_b = forward(cast, toks, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Same published and smoke configs (all fields but dtype), same
    parameter counts as the reference's."""
    for name in ("config", "smoke_config"):
        cfg = getattr(configs.get(arch), name)()
        jcfg = getattr(jax_configs.get(arch), name)()
        assert ref_config(cfg, "bfloat16") == jcfg
        assert cfg.dtype == torch.bfloat16
        assert cfg.param_count() == jcfg.param_count()
    assert configs.get(arch.replace("_", "-")).FAMILY == "lm"


def test_gredo_config_and_cells_match_reference():
    """The paper's own workload config is registered (``FAMILY`` "db", the
    reference's SHAPES), skipped by ``all_cells`` as in the reference, and
    the cells of the archs both registries list are the same."""
    gredo, jgredo = configs.get("gredo"), jax_configs.get("gredo")
    assert gredo.FAMILY == jgredo.FAMILY == "db"
    assert gredo.SHAPES == jgredo.SHAPES
    assert gredo.smoke_config()["sf"] == jgredo.smoke_config()["sf"] == 1
    shared = set(configs.ARCHS) & set(jax_configs.ARCHS)
    assert "gredo" in shared
    for skipped in (False, True):
        cells = list(configs.all_cells(include_skipped=skipped))
        assert all(arch != "gredo" for arch, _, _ in cells)
        assert cells == [c for c in jax_configs.all_cells(
            include_skipped=skipped) if c[0] in shared]


def test_unported_parts_raise(params):
    """The mesh forms that raised before the mesh layer was ported now run:
    on a 1x1 gloo mesh of this process, the sequence-sharded decode
    attention and the shard_map MoE give the plain forward's values, and
    the compressed all-reduce gives the quantized gradient and its
    residual (tests/test_torch_mesh.py holds them on 8 ranks)."""
    from repro_torch.launch.mesh import make_local_mesh
    from torch_spawn import world_of_one

    moe = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, n_experts=4,
                            dtype=torch.float32)
    mp = init_params(torch.Generator().manual_seed(0), moe)
    toks = _tokens(0, (2, 6), vocab=64)
    with world_of_one():
        mesh = make_local_mesh(1, 1, device="cpu")
        seq = dataclasses.replace(CFG, mesh=mesh, mesh_dp=("data",),
                                  kv_seq_shard="model")
        outs = []
        for cfg in (CFG, seq):
            cache = init_cache(cfg, 2, 12)
            logits, _ = forward(params, _tokens(0, (2, 4)), cfg, cache=cache,
                                cache_lengths=torch.zeros(2, dtype=torch.int32))
            outs.append(logits)
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                   rtol=3e-4, atol=3e-4)
        ep = dataclasses.replace(moe, mesh=mesh, mesh_dp=("data",),
                                 moe_ep_axis="model", moe_impl="shard_map")
        (l0, a0), (l1, a1) = forward(mp, toks, moe), forward(mp, toks, ep)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(float(a1), float(a0), rtol=1e-6)
        g, e = {"w": torch.linspace(-2, 3, 7)}, {"w": torch.full((7,), 0.01)}
        s, r = optimizer.compressed_psum(g, "data", e, mesh)
        approx = optimizer.decompress_int8(*optimizer.compress_int8(
            g["w"] + e["w"]))
        assert torch.equal(s["w"], approx)
        assert torch.equal(r["w"], g["w"] + e["w"] - approx)


# ---------------------------------------------------------------------------
# MoE (twins of tests/test_transformer.py's MoE tests, and parity)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, capacity_factor, groups):
    """fp32 logits within 1e-4 and the aux loss within 1e-5 of the
    reference's on its weights, with tokens dropped at capacity (1.0) and
    none dropped (4.0), in one and two dispatch groups."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=torch.float32,
                              capacity_factor=capacity_factor,
                              moe_groups=groups)
    jcfg = ref_config(cfg, "float32")
    jp, tp = both_params(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 24))
    want, want_aux = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = forward(tp, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)
    r = tf._moe_route(torch.zeros(groups, 4 * 24 // groups, cfg.d_model),
                      tp["layers"]["router"][0], cfg)
    assert r.capacity == int(np.ceil(4 * 24 // groups * cfg.top_k
                                     / cfg.n_experts * capacity_factor))
    # all-zero x: every logit ties, so every token picks experts 0..k-1,
    # which overflow at 1.0 and fit at 4.0
    assert (r.idx == torch.arange(cfg.top_k)).all()
    assert bool(r.keep.all()) == (capacity_factor == 4.0)


def ref_routes(jp, toks, jcfg) -> list:
    """The reference's top-k experts (G, T, k) of each MoE layer in one
    forward, recorded from inside it (a debug callback beside its
    ``_moe_block``), and its logits."""
    routes = []
    block = jtf._moe_block

    def recording(x, router_w, *rest):
        logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32), router_w)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)),
                           jax.lax.top_k(logits, jcfg.top_k)[1])
        return block(x, router_w, *rest)
    jtf._moe_block = recording
    try:
        logits, _ = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    finally:
        jtf._moe_block = block
    return routes, logits


def port_routes(tp, toks, cfg, monkeypatch) -> list:
    """The port's top-k experts (G, T, k) of each MoE layer, and its
    logits."""
    routes = []
    route = tf._moe_route

    def recording(x, router_w, c):
        r = route(x, router_w, c)
        routes.append(r.idx.numpy())
        return r
    monkeypatch.setattr(tf, "_moe_route", recording)
    logits, _ = forward(tp, torch.as_tensor(toks), cfg)
    return routes, logits


def kept(idx: np.ndarray, capacity: int) -> np.ndarray:
    """Which of the (G, T, k) assignments fit their expert's capacity:
    the reference's rule (stable sort by expert, rank < C), in numpy."""
    G, T, k = idx.shape
    flat = idx.reshape(G, T * k)
    order = np.argsort(flat, -1, kind="stable")
    by_e = np.take_along_axis(flat, order, -1)
    first = np.stack([np.searchsorted(e, e) for e in by_e])
    out = np.empty_like(flat, dtype=bool)
    np.put_along_axis(out, order, np.arange(T * k) - first < capacity, -1)
    return out.reshape(G, T, k)


def routing_agrees(a: list, b: list, cfg, B: int, S: int) -> np.ndarray:
    """(B, S): tokens whose experts and capacity drops agree between the
    two runs in every MoE layer."""
    ok = np.ones(B * S, bool)
    for ia, ib in zip(a, b):
        G, T, _ = ia.shape
        C = max(int(np.ceil(T * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)), 1)
        sa, sb = np.argsort(ia, -1), np.argsort(ib, -1)
        same = (np.take_along_axis(ia, sa, -1)
                == np.take_along_axis(ib, sb, -1)).all(-1)
        same &= (np.take_along_axis(kept(ia, C), sa, -1)
                 == np.take_along_axis(kept(ib, C), sb, -1)).all(-1)
        ok &= same.reshape(-1)
    return ok.reshape(B, S)


@pytest.mark.parametrize("impl", ["chunked", "dense", "flash"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_matches_reference_where_routing_agrees(arch, impl,
                                                         monkeypatch):
    """bf16: XLA and PyTorch round the residual stream differently, and a
    router logit within that rounding of the k-th best can pick another
    expert, which moves the token's logits by far more than rounding (and,
    at capacity, the tokens behind it in that expert's queue). So: the
    experts chosen differ for at most 5% of the tokens, and the logits of
    every token whose experts and drops agree in every layer lie within
    2e-2 of the logits' scale."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=torch.bfloat16, attn_impl=impl,
                              q_chunk=8, kv_chunk=8)
    jcfg = ref_config(cfg, "bfloat16")
    jp, tp = both_params(jcfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20))
    ref, want = ref_routes(jp, toks, jcfg)
    mine, got = port_routes(tp, toks, cfg, monkeypatch)
    assert len(ref) == len(mine) == cfg.n_layers
    flipped = sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                  for a, b in zip(ref, mine))
    assert flipped <= 0.05 * toks.size, flipped
    agree = routing_agrees(ref, mine, cfg, *toks.shape)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want)[agree].max()
    assert err <= BF16_SCALE_TOL * np.abs(want).max(), (err, agree.sum())


def test_moe_router_ties_take_the_lower_expert_first():
    """Equal router logits: the lower expert index wins, as ``lax.top_k``
    picks it, and the forward equals the reference's. Experts 0/1 and
    2/3 get identical router columns, so every token ties twice."""
    cfg = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, n_experts=4, top_k=2,
                            capacity_factor=1.0, dtype=torch.float32)
    jcfg = ref_config(cfg, "float32")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    router = np.asarray(jp["layers"]["router"]).copy()
    router[..., 1], router[..., 3] = router[..., 0], router[..., 2]
    jp["layers"]["router"] = jnp.asarray(router)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (1, 16, 32)), dtype=torch.float32)
    r = tf._moe_route(x, tp["layers"]["router"][0], cfg)
    lax_idx = jax.lax.top_k(jnp.asarray(r.logits.numpy()), 2)[1]
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(lax_idx))
    assert all(t in ([0, 1], [2, 3]) for t in r.idx[0].tolist())
    toks = np.random.default_rng(3).integers(0, 64, (2, 16))
    want, want_aux = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = forward(tp, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_group_invariance():
    """Dispatch grouping must not change results when capacity is ample."""
    cfg1 = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                             d_ff=32, vocab=64, n_experts=4, top_k=2,
                             capacity_factor=4.0, dtype=torch.float32,
                             moe_groups=1)
    cfg2 = dataclasses.replace(cfg1, moe_groups=4)
    p = init_params(torch.Generator().manual_seed(0), cfg1)
    toks = _tokens(1, (4, 8), 64)
    l1, _ = forward(p, toks, cfg1)
    l2, _ = forward(p, toks, cfg2)
    torch.testing.assert_close(l1, l2, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_are_bounded():
    cfg = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, n_experts=4, top_k=2,
                            capacity_factor=1.0, dtype=torch.float32)
    p = init_params(torch.Generator().manual_seed(0), cfg)
    toks = _tokens(1, (4, 16), 64)
    logits, aux = forward(p, toks, cfg)
    assert bool(torch.isfinite(logits).all())
    assert float(aux) >= 1.0  # switch aux loss lower bound is 1 at balance


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts(arch):
    """Published configs land in the advertised parameter bands (the
    reference test's bands), and the port's init_params draws the
    reference's shapes (checked on the smoke config)."""
    cfg = configs.get(arch).config()
    total = cfg.param_count() / 1e9
    active = cfg.active_param_count() / 1e9
    bands = {"olmoe_1b_7b": (6.0, 8.0, 0.9, 1.6),
             "granite_moe_1b_a400m": (1.0, 1.7, 0.3, 0.6),
             "starcoder2_3b": (2.6, 3.6, 2.6, 3.6),
             "qwen2_1_5b": (1.2, 1.9, 1.2, 1.9),
             "stablelm_3b": (2.5, 3.6, 2.5, 3.6)}
    lo, hi, alo, ahi = bands[arch]
    assert lo <= total <= hi, (arch, total)
    assert alo <= active <= ahi, (arch, active)
    smoke = configs.get(arch).smoke_config()
    mine = init_params(torch.Generator().manual_seed(0), smoke)
    ref = jax.eval_shape(lambda: jtf.init_params(
        jax.random.PRNGKey(0), ref_config(smoke, "float32")))
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        optimizer.tree_map(lambda t: tuple(t.shape), mine)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_batcher_tokens_equal_reference_batcher(arch):
    """Continuous batching of an MoE smoke model, fp32, on the reference's
    weights: the same greedy tokens as the reference's batcher, token for
    token (capacity couples the slots of a decode step, inactive ones
    included, in both packages alike)."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=torch.float32, attn_impl="dense")
    jcfg = ref_config(cfg, "float32")
    jp, tp = both_params(jcfg)
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, cfg.vocab, rng.integers(4, 20))
             .astype(np.int32), int(rng.integers(3, 10))) for i in range(7)]
    want = JaxBatcher(jp, jcfg, n_slots=3, max_len=64).serve(
        [JaxRequest(rid=i, prompt=p, max_new=m) for i, p, m in reqs])
    got = ContinuousBatcher(tp, cfg, n_slots=3, max_len=64).serve(
        [Request(rid=i, prompt=p, max_new=m) for i, p, m in reqs])
    assert [(c.rid, c.tokens, c.prefill_len, c.steps) for c in got] == \
        [(c.rid, c.tokens, c.prefill_len, c.steps) for c in want]
