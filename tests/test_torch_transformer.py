"""The port's LM transformer held against the JAX package's.

The reference's parameters (``init_params`` from a JAX key, as numpy
arrays) are carried into the port through ``params_from_arrays``, and the
same numpy tokens go through both ``forward``s. Tolerances: fp32 rtol 3e-4
/ atol 3e-5 elementwise (the kernel sweep's). bf16 at 2e-2 of the output's
scale, max |port - reference| <= 2e-2 * max |reference|: XLA on the CPU
rounds every elementwise op of a bf16 chain (sigmoid as neg, exp, add, div)
where PyTorch rounds once per op, so a few elements in a hundred differ by
a few bf16 ulps after two layers and an elementwise 2e-2 fails on values
near 0. Also twins of ``tests/test_transformer.py`` on the port alone,
the cache-update clamp at the ``max_len`` boundary, and the parts that are
not ported yet raising."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import (TransformerConfig, cast_params,
                                            forward, init_cache, init_params,
                                            params_from_arrays, serve_step)

ARCHS = ["qwen2_1_5b", "stablelm_3b", "starcoder2_3b"]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "dense", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
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

    want, _ = jtf.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = forward(tp, torch.as_tensor(toks), cfg)
    assert got.dtype == cfg.dtype and float(aux) == 0.0
    assert_close(got, want, dtype)

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


def test_unported_parts_raise():
    moe = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, n_experts=4)
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        init_params(torch.Generator().manual_seed(0), moe)
    p = init_params(torch.Generator().manual_seed(0), CFG)
    with pytest.raises(NotImplementedError, match="item 11"):
        forward(p, _tokens(0, (1, 4)),
                dataclasses.replace(CFG, kv_seq_shard="model"))
    with pytest.raises(NotImplementedError, match="item 10"):
        tf.loss_fn(p, {}, CFG)
    with pytest.raises(KeyError, match="olmoe"):
        configs.get("olmoe_1b_7b")
