"""The port's training path held against the JAX package's: int8 gradient
compression, AdamW (closed form and the reference's ``adamw_update``),
``loss_fn`` and its ``torch.autograd`` gradients against ``jax.grad``
(fp32 within 1e-4, dense and MoE smoke configs), the token stream, and the
``Trainer`` (twins of ``tests/test_distributed.py``'s single-device tests
and ``tests/test_transformer.py::test_loss_decreases``, and the loss curve
and final weights against the reference's Trainer). The mesh tests wait
for the port's mesh layer (ROADMAP queue 1, item 11)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm import TokenStream as JaxTokenStream
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.data.lm import TokenStream
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            loss_fn, params_from_arrays)
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, compress_int8,
                                         decompress_int8, tree_leaves,
                                         tree_map)


def ref_config(cfg: TransformerConfig) -> jtf.TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TransformerConfig)
              if f.name != "dtype"}
    return jtf.TransformerConfig(**fields, dtype=jnp.float32)


def to_numpy(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def test_int8_compression_roundtrip():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal(1000) * 3, dtype=torch.float32)
    q, scale = compress_int8(g)
    back = decompress_int8(q, scale)
    assert q.dtype == torch.int8
    # error bounded by half a quantization step
    assert float((back - g).abs().max()) <= float(scale) * 0.5 + 1e-6
    jq, jscale = jopt.compress_int8(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_error_feedback_reduces_bias():
    """With error feedback, the accumulated compressed sum tracks the true
    sum over steps (EF-SGD property)."""
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.standard_normal(512) * 0.01, dtype=torch.float32)
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(20):
        gc = g + err
        q, s = compress_int8(gc)
        approx = decompress_int8(q, s)
        err = gc - approx
        total = total + approx
    true_total = g * 20
    rel = float((total - true_total).abs().max()
                / (true_total.abs().max() + 1e-9))
    assert rel < 0.05


def test_adamw_matches_reference_step():
    rng = np.random.default_rng(2)
    params = {"w": torch.as_tensor(rng.standard_normal((8, 8)),
                                   dtype=torch.float32)}
    grads = {"w": torch.as_tensor(rng.standard_normal((8, 8)),
                                  dtype=torch.float32)}
    state = adamw_init(params)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.999, weight_decay=0.0,
                      grad_clip=1e9)
    new_p, new_s = adamw_update(grads, state, params, cfg)
    g = grads["w"].numpy()
    m = 0.1 * g
    v = 0.001 * g * g
    mh = m / (1 - 0.9)
    vh = v / (1 - 0.999)
    expect = params["w"].numpy() - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-3,
                               atol=2e-6)  # f32 rsqrt vs np.sqrt
    assert int(new_s["step"]) == 1


def test_adamw_matches_jax_adamw_update():
    """Three steps on a nested tree (dicts and a list), with the gradient
    clip active and weight decay: the same parameters, moments and step
    as the reference's ``adamw_update``; inputs are left untouched."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}

    def draw(scale):
        tree = jax.tree.map(lambda s: (rng.standard_normal(s) * scale)
                            .astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))
        tree["e"] = [rng.standard_normal(3).astype(np.float32)]
        return tree
    p_np = draw(1.0)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    tp = params_from_arrays(p_np)
    tp["e"] = [torch.as_tensor(p_np["e"][0])]
    jp = jax.tree.map(jnp.asarray, p_np)
    ts, js = adamw_init(tp), jopt.adamw_init(jp)
    for _ in range(3):
        g_np = draw(2.0)
        tg = params_from_arrays(g_np)
        tg["e"] = [torch.as_tensor(g_np["e"][0])]
        old, before = tp, [t.clone() for t in tree_leaves(tp)]
        tp, ts = adamw_update(tg, ts, tp, cfg)
        jp, js = jopt.adamw_update(jax.tree.map(jnp.asarray, g_np), js, jp,
                                   jcfg)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(old),
                                                     before))
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(tree_leaves(to_numpy(got)), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("arch", [None, "olmoe_1b_7b",
                                  "granite_moe_1b_a400m"])
def test_loss_fn_and_grads_match_reference(arch):
    """fp32: ``loss_fn``'s loss and nll, and every parameter's gradient
    from ``torch.autograd``, within 1e-4 of the reference's
    ``jax.value_and_grad`` on its weights. ``ce_chunk`` 16 over 40
    positions leaves a partial last chunk; labels -1 are masked."""
    base = (TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=96, vocab=211,
                              qkv_bias=True) if arch is None
            else configs.get(arch).smoke_config())
    cfg = dataclasses.replace(base, dtype=torch.float32, ce_chunk=16,
                              q_chunk=16, kv_chunk=16)
    jcfg = ref_config(cfg)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    (want, want_nll), want_g = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)}, jcfg),
        has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, nll = loss_fn(tp, {"tokens": torch.as_tensor(toks),
                             "labels": torch.as_tensor(labels)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    loss, nll = loss.detach(), nll.detach()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    np.testing.assert_allclose(float(nll), float(want_nll), rtol=1e-4)
    assert float(loss) > float(nll) if cfg.is_moe else \
        float(loss) == float(nll)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_token_stream_matches_reference():
    for kw in ({"vocab": 64, "batch": 8, "seq": 16},
               {"vocab": 49155, "batch": 4, "seq": 33, "seed": 3,
                "n_hosts": 2, "host_id": 1}):
        mine, ref = TokenStream(**kw), JaxTokenStream(**kw)
        for step in (0, 1, 17):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _torch_data(stream):
    def data_at(step):
        b = stream.batch_at(step)
        return {k: torch.as_tensor(v) for k, v in b.items()}
    return data_at


def test_microbatch_equals_full_batch(tmp_path):
    """Gradient accumulation is loss-equivalent to the full batch."""
    cfg = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64, dtype=torch.float32)
    data_at = _torch_data(TokenStream(vocab=64, batch=8, seq=16))
    results = {}
    for mb in (1, 4):
        p = init_params(torch.Generator().manual_seed(0), cfg)
        t = Trainer(lambda pp, b: loss_fn(pp, b, cfg), p, data_at,
                    TrainerConfig(total_steps=5, ckpt_every=0,
                                  ckpt_dir=str(tmp_path / f"mb{mb}"),
                                  microbatch=mb, log_every=1))
        r = t.run(resume=False)
        results[mb] = [m["loss"] for m in r["metrics"]]
    # same data, averaged grads: curves should be very close
    np.testing.assert_allclose(results[1], results[4], rtol=2e-2)


def test_loss_decreases(tmp_path):
    cfg = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=96, vocab=64, qkv_bias=True,
                            dtype=torch.float32, q_chunk=16, kv_chunk=16)
    p = init_params(torch.Generator().manual_seed(0), cfg)
    data_at = _torch_data(TokenStream(vocab=64, batch=8, seq=32))
    t = Trainer(lambda pp, b: loss_fn(pp, b, cfg), p, data_at,
                TrainerConfig(total_steps=25, ckpt_every=0,
                              ckpt_dir=str(tmp_path), log_every=1))
    r = t.run(resume=False)
    losses = [m["loss"] for m in r["metrics"]]
    assert losses[-1] < losses[0] - 0.1, losses


@pytest.mark.parametrize("arch,microbatch", [(None, 1), ("olmoe_1b_7b", 2)])
def test_trainer_matches_reference_trainer(tmp_path, arch, microbatch):
    """Four steps of the port's Trainer and the reference's from the same
    fp32 weights and token stream: the logged losses within 1e-4 and the
    final weights within 1e-4 of the reference's (a router logit near a
    tie could flip an expert after enough steps; these four do not)."""
    base = (TransformerConfig(n_layers=2, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=32, vocab=64)
            if arch is None else configs.get(arch).smoke_config())
    cfg = dataclasses.replace(base, dtype=torch.float32)
    jcfg = ref_config(cfg)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp))
    stream = TokenStream(vocab=cfg.vocab, batch=4, seq=16)
    tcfg = dict(total_steps=4, ckpt_every=0, log_every=1,
                microbatch=microbatch)
    mine = Trainer(lambda pp, b: loss_fn(pp, b, cfg), tp, _torch_data(stream),
                   TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tcfg))
    ref = jloop.Trainer(
        lambda pp, b: jtf.loss_fn(pp, b, jcfg), jp,
        lambda s: jax.tree.map(jnp.asarray, stream.batch_at(s)),
        jloop.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tcfg))
    got, want = mine.run(resume=False), ref.run(resume=False)
    for key in ("loss", "aux"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                   [m[key] for m in want["metrics"]],
                                   rtol=1e-4)
    for a, b in zip(tree_leaves(to_numpy(mine.params)),
                    jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
