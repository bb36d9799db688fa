"""Twins of ``tests/test_window_and_gcda_cells.py``'s window tests: the
port's opt-in sliding-window attention, on the port alone and against the
JAX package on the same weights (fp32 rtol/atol 1e-4, the reference
test's), and flash ignoring the window in both packages (the flash kernel
takes no window; ROADMAP queue 3). The GCDA mesh cells wait for the
port's mesh layer (ROADMAP queue 1, item 11)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.models.transformer import (TransformerConfig, forward,
                                            init_params, params_from_arrays)

WINDOWED = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             d_ff=96, vocab=128, dtype=torch.float32,
                             attn_window=8, q_chunk=16, kv_chunk=16)


def ref_config(cfg: TransformerConfig) -> jtf.TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)
              if f.name != "dtype"}
    return jtf.TransformerConfig(**fields, dtype=jnp.float32)


def both_params(cfg: TransformerConfig):
    jp = jtf.init_params(jax.random.PRNGKey(0), ref_config(cfg))
    return jp, params_from_arrays(jax.tree.map(np.asarray, jp))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_window_attention_chunked_equals_dense():
    p = init_params(torch.Generator().manual_seed(0), WINDOWED)
    toks = torch.as_tensor(tokens(1, (2, 40), 128))
    l1, _ = forward(p, toks, WINDOWED)
    l2, _ = forward(p, toks, dataclasses.replace(WINDOWED, attn_impl="dense"))
    torch.testing.assert_close(l1, l2, rtol=1e-4, atol=1e-4)


def test_window_actually_masks():
    """Tokens beyond the window must not affect the last position."""
    cfg = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, dtype=torch.float32,
                            attn_impl="dense", attn_window=4)
    p = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.as_tensor(tokens(1, (1, 16), 64))
    toks2 = toks.clone()
    toks2[:, :8] = 11  # mutate tokens far outside the window
    l1, _ = forward(p, toks, cfg)
    l2, _ = forward(p, toks2, cfg)
    torch.testing.assert_close(l1[:, -1], l2[:, -1], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(l1[:, 8], l2[:, 8], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["chunked", "dense"])
def test_window_attention_matches_reference(impl):
    cfg = dataclasses.replace(WINDOWED, attn_impl=impl)
    jp, tp = both_params(cfg)
    toks = tokens(2, (2, 40), cfg.vocab)
    want, _ = jtf.forward(jp, jnp.asarray(toks, jnp.int32), ref_config(cfg))
    got, _ = forward(tp, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_flash_ignores_the_window_in_both_packages():
    """With ``attn_impl="flash"`` neither package passes the window to
    its kernel: the logits equal those without a window, bit for bit, and
    differ from the windowed dense ones; the two packages agree."""
    cfg = dataclasses.replace(WINDOWED, attn_impl="flash")
    jp, tp = both_params(cfg)
    toks = tokens(3, (2, 40), cfg.vocab)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    got, _ = forward(tp, tt, cfg)
    unwindowed, _ = forward(tp, tt, dataclasses.replace(cfg, attn_window=0))
    windowed, _ = forward(tp, tt, dataclasses.replace(cfg, attn_impl="dense"))
    assert torch.equal(got, unwindowed)
    assert not torch.allclose(got, windowed, rtol=1e-4, atol=1e-4)
    want, _ = jtf.forward(jp, jt, ref_config(cfg))
    want_unwindowed, _ = jtf.forward(
        jp, jt, ref_config(dataclasses.replace(cfg, attn_window=0)))
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(want_unwindowed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
