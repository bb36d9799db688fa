"""The port's mesh forms on 8 CPU ranks of a gloo process group, held
against the JAX package: twins of ``tests/test_multidevice.py`` (every
case), of ``test_distributed.py::test_regression_distributed_matches_local``
and of the collective part of ``test_hlo_analysis.py``, and parity of
``regression_distributed`` (padded rows), ``compressed_psum``, the
hierarchical retrieval, ``reshard_state``, the layout pins and the
('pod', 'data') split.

One launch of 8 spawned ranks (``torch_spawn.run_ranks``, a 300 s limit)
runs every check (``torch_mesh_ranks.mesh_checks``); the tests read its
results. The two cases the JAX package fails here
(``test_seq_sharded_decode_matches_dense``, ``test_shard_map_moe_matches_
local``: its vmapped cache update and shard_map meet this JAX's sharding
checks) are held against the single-device ``forward`` of both packages,
at the reference test's tolerances (3e-4, 5e-4)."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import analytics as ranalytics
from repro.models import recsys as rrecsys
from repro.models import transformer as rtfm
from repro.train.optimizer import compress_int8, decompress_int8
from repro_torch.core import analytics
from repro_torch.models import params_from_arrays
from repro_torch.models import transformer as tfm

from torch_mesh_ranks import (EQUIVARIANT_MODELS, SHARDED_MODELS,
                              mesh_checks, sharded_steps)
from torch_spawn import run_ranks

DECODE_CFG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                  vocab=128)
MOE_CFG = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=16,
               vocab=64, n_experts=8, top_k=2, capacity_factor=4.0,
               moe_groups=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    inp = {
        "X": rng.standard_normal((64, 32)).astype(np.float32),
        "Y": rng.standard_normal((32, 48)).astype(np.float32),
        "r256": (rng.standard_normal((256, 16)).astype(np.float32),
                 rng.integers(0, 2, 256).astype(np.float32)),
        "r512": (rng.standard_normal((512, 24)).astype(np.float32),
                 rng.integers(0, 2, 512).astype(np.float32)),
        "r250": (rng.standard_normal((250, 16)).astype(np.float32),
                 rng.integers(0, 2, 250).astype(np.float32)),
        "toks": rng.integers(0, 128, (4, 24)).astype(np.int32),
        "nxt": rng.integers(0, 128, (4, 1)).astype(np.int32),
        "moe_toks": rng.integers(0, 64, (4, 8)).astype(np.int32),
        "decode_cfg": DECODE_CFG, "moe_cfg": MOE_CFG,
        "g": [{"a": (rng.standard_normal((6, 5)) * 3).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float32)}
              for _ in range(8)],
        "e": [{"a": (rng.standard_normal((6, 5)) * 0.01).astype(np.float32),
               "b": (rng.standard_normal(7) * 0.01).astype(np.float32)}
              for _ in range(8)],
        "state_a": rng.standard_normal((8, 12)).astype(np.float32),
        "state_b": np.arange(5, dtype=np.int32),
        "pod_t": np.arange(16 * 6, dtype=np.float32).reshape(16, 6),
        "pin_x": rng.standard_normal((2, 8, 3, 4)).astype(np.float32),
        "pin_h": rng.standard_normal((4, 9, 8)).astype(np.float32),
    }
    inp["decode_params"] = _np_tree(rtfm.init_params(
        jax.random.PRNGKey(0), rtfm.TransformerConfig(
            **DECODE_CFG, dtype=jnp.float32, attn_impl="dense")))
    inp["moe_params"] = _np_tree(rtfm.init_params(
        jax.random.PRNGKey(0), rtfm.TransformerConfig(
            **MOE_CFG, dtype=jnp.float32)))
    rcfg = rconfigs.get("wide_deep").smoke_config()
    inp["rs_params"] = _np_tree(rrecsys.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    batch = rrecsys.random_batch(rcfg, 2, seed=5)
    inp["dense"] = np.asarray(batch["dense"])
    inp["sparse"] = np.asarray(batch["sparse"])
    inp["cands"] = np.random.default_rng(6).standard_normal(
        (512, rcfg.tower_dim)).astype(np.float32)
    n, e = 12, 32                 # a small graph, its edges over 4 ranks
    inp["graph"] = {
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": (rng.random(e) < 0.9).astype(np.float32),
        "x": rng.standard_normal((n, 24)).astype(np.float32),
        "labels": rng.integers(0, 4, n).astype(np.int32),
        "pos": rng.standard_normal((n, 3)).astype(np.float32),
        "species": rng.integers(0, 8, n).astype(np.int32),
        "graph_id": np.repeat(np.arange(2), n // 2).astype(np.int32),
        "energy": rng.standard_normal(2).astype(np.float32)}
    batch = rrecsys.random_batch(rcfg, 8, seed=7)
    inp.update(rs_dense=np.asarray(batch["dense"]),
               rs_sparse=np.asarray(batch["sparse"]),
               rs_labels=np.asarray(batch["labels"]))
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(mesh_checks, 8, tmp_path_factory.mktemp("ranks"),
                     inputs, timeout=300)


# ---------------------------------------------------------------------------
# GCDA (test_multidevice: gcda mesh ops, distributed regression)
# ---------------------------------------------------------------------------


def test_gcda_multiply_on_mesh(ranks, inputs):
    X, Y = inputs["X"], inputs["Y"]
    for r in ranks:
        np.testing.assert_allclose(r["gcda"]["Z"], X @ Y, rtol=1e-4,
                                   atol=1e-4)
        assert r["gcda"]["S"].shape == (64, 64)
        # rank (i, j) holds tile (i, j): X's row block i @ Y's column block j
        i, j = r["gcda"]["coord"]
        np.testing.assert_allclose(
            r["gcda"]["Z_local"], X[32 * i:32 * i + 32] @ Y[:, 12 * j:12 * j + 12],
            rtol=1e-4, atol=1e-4)
        assert r["gcda"]["Z_placements"] == ["S(0)", "S(1)"]
    ref = np.asarray(ranalytics.similarity(jnp.asarray(X), jnp.asarray(X),
                                           use_kernel=False))
    np.testing.assert_allclose(ranks[0]["gcda"]["S"], ref, rtol=3e-4,
                               atol=3e-5)


@pytest.mark.parametrize("name,iters", [("r256", 30), ("r512", 40)])
def test_distributed_regression_matches_local(ranks, inputs, name, iters):
    X, y = inputs[name]
    w_l, loss_l = ranalytics.regression(jnp.asarray(X), jnp.asarray(y),
                                        iters=iters, use_kernel=False)
    w_p, loss_p = analytics.regression(torch.from_numpy(X),
                                       torch.from_numpy(y), iters=iters)
    for r in ranks:
        w_d, loss_d = r["regression"][name]
        np.testing.assert_allclose(w_d, np.asarray(w_l), rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(w_d, w_p.numpy(), rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(loss_d, float(loss_l), rtol=5e-3)


def test_regression_distributed_pads_like_the_reference(ranks, inputs,
                                                         tmp_path):
    """n = 250 on 8 data ranks: 6 zero pad rows, each adding log 2 to the
    loss sum and nothing to the gradient, in both packages. The reference
    runs on 8 XLA host devices in a subprocess."""
    X, y = inputs["r250"]
    np.savez(tmp_path / "in.npz", X=X, y=y)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.core import analytics
        from repro.launch.mesh import make_local_mesh
        d = np.load({str(tmp_path / 'in.npz')!r})
        w, loss = analytics.regression_distributed(
            jnp.asarray(d["X"]), jnp.asarray(d["y"]), make_local_mesh(8, 1),
            iters=30)
        np.savez({str(tmp_path / 'out.npz')!r}, w=np.asarray(w),
                 loss=np.asarray(loss))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    w_d, loss_d = ranks[0]["regression"]["r250"]
    np.testing.assert_allclose(w_d, ref["w"], rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(loss_d, float(ref["loss"]), rtol=3e-4)
    # the pad term is there: without it the loss would be log 2 * 6 / 250
    # lower than the reference's
    _, loss_local = ranalytics.regression(jnp.asarray(X), jnp.asarray(y),
                                          iters=30, use_kernel=False)
    assert abs(loss_d - float(loss_local)) > 0.5 * 6 * np.log(2) / 250


# ---------------------------------------------------------------------------
# LM (test_multidevice: seq-sharded decode, shard_map MoE)
# ---------------------------------------------------------------------------


def _single_device_decode(inputs):
    rcfg = rtfm.TransformerConfig(**DECODE_CFG, dtype=jnp.float32,
                                  attn_impl="dense")
    p = jax.tree.map(jnp.asarray, inputs["decode_params"])
    toks, nxt = jnp.asarray(inputs["toks"]), jnp.asarray(inputs["nxt"])
    cache = rtfm.init_cache(rcfg, 4, 32)
    _, cache = rtfm.forward(p, toks, rcfg, cache=cache,
                            cache_lengths=jnp.zeros(4, jnp.int32))
    ref, _ = rtfm.serve_step(p, cache, nxt, jnp.full(4, 24, jnp.int32), rcfg)
    cfg = tfm.TransformerConfig(**DECODE_CFG, dtype=torch.float32,
                                attn_impl="dense")
    pp = params_from_arrays(inputs["decode_params"])
    cache = tfm.init_cache(cfg, 4, 32)
    _, cache = tfm.forward(pp, torch.from_numpy(inputs["toks"]).long(), cfg,
                           cache=cache,
                           cache_lengths=torch.zeros(4, dtype=torch.int32))
    port, _ = tfm.serve_step(pp, cache, torch.from_numpy(inputs["nxt"]).long(),
                             torch.full((4,), 24, dtype=torch.int32), cfg)
    return np.asarray(ref), port.numpy()


def test_seq_sharded_decode_matches_dense(ranks, inputs):
    """With the cache a full tensor on every rank, and with it a DTensor
    (batch over 'data', positions over 'model', as the reference's test
    places it): the same next-token logits, and the same cache."""
    ref, port = _single_device_decode(inputs)
    for r in ranks:
        logits, cache, placements = r["lm"]["decode_sharded_cache"]
        assert placements == ["S(1)", "S(3)"]
        for got in (r["lm"]["decode"], logits):
            np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(got, port, rtol=3e-4, atol=3e-4)
        np.testing.assert_array_equal(cache, r["lm"]["decode_cache"])


def test_shard_map_moe_matches_local(ranks, inputs):
    """Logits as the reference test holds them. The balance loss is the
    mean over the data ranks of each rank's own statistic (the reference's
    ``pmean``), not the statistic of the whole batch, so it is only held
    equal across ranks."""
    rcfg = rtfm.TransformerConfig(**MOE_CFG, dtype=jnp.float32)
    ref, _ = rtfm.forward(jax.tree.map(jnp.asarray,
                                             inputs["moe_params"]),
                                jnp.asarray(inputs["moe_toks"]), rcfg)
    cfg = tfm.TransformerConfig(**MOE_CFG, dtype=torch.float32)
    port, _ = tfm.forward(params_from_arrays(inputs["moe_params"]),
                                 torch.from_numpy(inputs["moe_toks"]).long(),
                                 cfg)
    for r in ranks:
        logits, aux = r["lm"]["moe"]
        np.testing.assert_allclose(logits, np.asarray(ref), rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(logits, port.numpy(), rtol=5e-4,
                                   atol=5e-4)
        assert aux == ranks[0]["lm"]["moe"][1] and np.isfinite(aux)


# ---------------------------------------------------------------------------
# RecSys, optimizer, elastic
# ---------------------------------------------------------------------------


def test_distributed_retrieval_matches_bruteforce(ranks, inputs):
    rcfg = rconfigs.get("wide_deep").smoke_config()
    p = jax.tree.map(jnp.asarray, inputs["rs_params"])
    v0, i0 = rrecsys.retrieval_step(p, jnp.asarray(inputs["dense"]),
                                    jnp.asarray(inputs["sparse"]),
                                    jnp.asarray(inputs["cands"]), rcfg,
                                    top_k=16)
    for r in ranks:
        got = r["retrieval"]
        assert np.array_equal(got["i"], ranks[0]["retrieval"]["i"])
        for b in range(2):
            overlap = len(set(np.asarray(i0[b]).tolist())
                          & set(got["i"][b].tolist())) / 16
            assert overlap >= 0.85, overlap
        assert np.all(np.diff(got["v"], axis=1) <= 0)     # merged, sorted


def test_compressed_psum_sums_the_quantized_gradients(ranks, inputs):
    """Each rank quantizes g + e (the reference's compress/decompress) and
    keeps the residual; the 4 ranks of a 'model' group sum the values."""
    approx, resid = {}, {}
    for rank in range(8):
        for leaf in ("a", "b"):
            gc = jnp.asarray(inputs["g"][rank][leaf]) + jnp.asarray(
                inputs["e"][rank][leaf])
            q, s = compress_int8(gc)
            approx[rank, leaf] = np.asarray(decompress_int8(q, s))
            resid[rank, leaf] = np.asarray(gc) - approx[rank, leaf]
    for rank, r in enumerate(ranks):
        got = r["compressed_psum"]
        group = [rr for rr in range(8)
                 if ranks[rr]["compressed_psum"]["data_rank"]
                 == got["data_rank"]]
        assert len(group) == 4
        for k, leaf in enumerate(("a", "b")):
            want = sum(approx[rr, leaf] for rr in group)
            np.testing.assert_allclose(got["sum"][k], want, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got["res"][k], resid[rank, leaf],
                                       rtol=1e-6, atol=1e-7)


def test_reshard_state_round_trip(ranks, inputs):
    a = inputs["state_a"]
    for r in ranks:
        got = r["reshard"]
        i, j = got["coord"]
        assert got["a_placements"] == ["S(0)", "S(1)"]
        np.testing.assert_array_equal(got["a_local"],
                                      a[4 * i:4 * i + 4, 3 * j:3 * j + 3])
        back_a, back_b, none = got["back"]
        np.testing.assert_array_equal(back_a, a)
        np.testing.assert_array_equal(back_b, inputs["state_b"])
        assert back_b.dtype == np.int32 and none is None


# ---------------------------------------------------------------------------
# Placements and layout pins
# ---------------------------------------------------------------------------


def test_pod_data_split_is_major_to_minor(ranks, inputs):
    """A dim over ('pod', 'data') is split pod-major, as JAX splits it:
    rank (p, d, m) holds row block p * 2 + d and column block m."""
    t = inputs["pod_t"]
    for r in ranks:
        got = r["pod"]
        p, d, m = got["coord"]
        want = t[4 * (p * 2 + d):4 * (p * 2 + d) + 4, 3 * m:3 * m + 3]
        np.testing.assert_array_equal(got["local"], want)
        np.testing.assert_array_equal(got["block"], want)
        assert got["placements"] == ["S(0)", "S(0)", "S(1)"]


def test_layout_pins_change_no_value(ranks, inputs):
    for r in ranks:
        got = r["pins"]
        assert got["pre"][0] == ["S(0)", "S(1)"]       # G over data, E over EP
        assert got["post"][0] == ["S(0)", "R"]
        np.testing.assert_array_equal(got["pre"][1], inputs["pin_x"])
        np.testing.assert_array_equal(got["post"][1], inputs["pin_x"])
        assert got["plain"]
        assert got["cshard"][0] == ["R", "S(2)"]
        np.testing.assert_array_equal(got["cshard"][1], inputs["pin_h"])


def test_collectives_in_sharded_program(ranks):
    """Twin of the collective parser's case on real gloo collectives: an
    all-reduce of 64 fp32 in a 4-trip loop (doubled for the ring) plus an
    all-gather of 128 fp32 give 2048 + 512 bytes."""
    for r in ranks:
        cb = r["hlo"]["coll"]
        assert cb["all-reduce"] == {"count": 4, "bytes": 2048}
        assert cb["all-gather"] == {"count": 1, "bytes": 512}
        assert cb["total_bytes"] == 2560
        np.testing.assert_array_equal(r["hlo"]["x"], np.full(64, 4.0 ** 4))


@pytest.fixture(scope="module")
def steps(inputs, tmp_path_factory):
    """Each rank's results of three launches (the equivariant GNNs, the
    slowest, one each)."""
    out = [{} for _ in range(8)]
    for models in (SHARDED_MODELS, *((m,) for m in EQUIVARIANT_MODELS)):
        for mine, got in zip(out, run_ranks(
                sharded_steps, 8, tmp_path_factory.mktemp("steps"), inputs,
                models, timeout=300)):
            mine.update(got)
    return out


@pytest.mark.parametrize("model", SHARDED_MODELS + EQUIVARIANT_MODELS)
def test_dry_run_layouts_compute_the_plain_step(steps, model):
    """The layouts the dry-run traces, run for real on a (2, 2, 2) pod
    mesh of gloo ranks (parameters and batch as DTensors by the sharding
    rules: the batch over ('pod', 'data'), heads, hidden dims, experts,
    vocab and table rows over 'model'): the loss and every gradient equal
    those of the plain tensors; the GNNs' edges over ('pod', 'data'), their
    parameters' last dims over 'model', as the GNN cells lay them out.
    Covers the residual-stream pins, the masked lookups and gathers from
    sharded dims, the MoE block, attention, the GNN scatters and MACE's
    and EquiformerV2's products on each rank's shards, and the edge-split
    segment maxima (PNA and EquiformerV2 in float64: ill-conditioned in
    fp32 in both packages)."""
    for r in steps:
        (loss, grads), (dloss, dgrads) = r[model]
        np.testing.assert_allclose(dloss, loss, rtol=1e-5)
        assert len(dgrads) == len(grads)
        # each leaf at the gradient's scale: EquiformerV2's attention MLP
        # has a last bias whose gradient is zero in exact arithmetic
        scale = max(np.abs(g).max() for g in grads)
        for g, dg in zip(grads, dgrads):
            np.testing.assert_allclose(dg, g, rtol=1e-4, atol=1e-5 * scale)
