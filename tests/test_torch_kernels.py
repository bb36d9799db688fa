"""The port's four kernels, held against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` and
``tests/test_traversal_kernels.py`` run it on the CPU) and through the
port's plain PyTorch version — the function the port's kernel is held to on
the card. Tolerances are the reference sweep's: fp32 matmul 2e-4, bf16
2e-2; cosine and logreg rtol 3e-4 / atol 3e-5; traversal exact. Also the
dispatch rules: a CPU tensor takes the plain version and never launches,
``use_kernel=True`` on a CPU tensor raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cosine_sim.cosine_sim import cosine_sim as jax_cosine
from repro.kernels.logreg.logreg import logreg_grad as jax_logreg
from repro.kernels.matmul.matmul import matmul as jax_matmul
from repro.kernels.traversal import ops as jax_tops
from repro.kernels.traversal import traversal as jax_hop
from repro_torch.kernels import launch_counts
from repro_torch.kernels.cosine_sim.ops import cosine_sim
from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
from repro_torch.kernels.logreg.ops import logreg_grad
from repro_torch.kernels.logreg.ref import logreg_grad_ref
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.traversal import ops as tops
from repro_torch.kernels.traversal import ref as tref

RNG = np.random.default_rng(42)
T = torch.as_tensor


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (128, 128, 128),
                                   (100, 60, 130), (257, 129, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, dtype):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    y = RNG.standard_normal((k, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_matmul(jnp.asarray(x, jd), jnp.asarray(y, jd), bm=32, bn=32,
                      bk=32, interpret=True)
    got = matmul_ref(T(x).to(td), T(y).to(td))
    assert got.dtype == td
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_matmul_gram_reads_transposed_view():
    """``MatMul[gram]`` passes ``x.T``; the plain version takes the view."""
    x = RNG.standard_normal((70, 33)).astype(np.float32)
    want = jax_matmul(jnp.asarray(x), jnp.asarray(x).T, bm=32, bn=32, bk=32,
                      interpret=True)
    xt = T(x)
    np.testing.assert_allclose(matmul(xt, xt.T).numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,d", [(64, 64, 32), (100, 50, 96), (33, 65, 17)])
def test_cosine_matches_pallas(m, n, d):
    x = RNG.standard_normal((m, d)).astype(np.float32)
    y = RNG.standard_normal((n, d)).astype(np.float32)
    want = jax_cosine(jnp.asarray(x), jnp.asarray(y), bm=32, bn=32, bk=32,
                      interpret=True)
    np.testing.assert_allclose(cosine_sim_ref(T(x), T(y)).numpy(),
                               np.asarray(want), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("n,d,bn", [(100, 16, 32), (512, 64, 128), (65, 7, 16)])
def test_logreg_matches_pallas(n, d, bn):
    x = RNG.standard_normal((n, d)).astype(np.float32)
    y = RNG.integers(0, 2, n).astype(np.float32)
    w = (RNG.standard_normal(d) * 0.3).astype(np.float32)
    g1, l1 = jax_logreg(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), bn=bn,
                        interpret=True)
    g2, l2 = logreg_grad_ref(T(x), T(y), T(w))
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(float(l2), float(l1), rtol=3e-4, atol=3e-5)


def _random_hop_inputs(seed, n=12, chunk=8):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    m = int(row_ptr[-1])
    col_idx = rng.integers(0, n, m).astype(np.int32)
    edge_id = rng.permutation(m).astype(np.int32)
    member = rng.random(n) < 0.7
    edge_pred = rng.random(max(m, 1)) < 0.6
    nch = max(-(-max(m, 1) // chunk), 1)
    chunk_alive = np.ones(nch, bool)
    for c in range(nch):
        if not edge_pred[c * chunk:(c + 1) * chunk].any():
            chunk_alive[c] = False
    return row_ptr, col_idx, edge_id, member, edge_pred, chunk_alive


def _assert_same(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,capacity,n,c0", [(0, 128, 12, 6),
                                                (1, 128, 12, 6),
                                                (2, 256, 12, 6),
                                                (3, 512, 60, 40)])
def test_fused_hop_matches_pallas(seed, capacity, n, c0):
    tables = _random_hop_inputs(seed, n=n)
    rng = np.random.default_rng(seed + 100)
    frontier = np.zeros(capacity, np.int32)
    frontier[:c0] = rng.integers(0, n, c0)
    fmask = np.zeros(capacity, bool)
    fmask[:c0] = True
    args = tables[:3] + (frontier, fmask) + tables[3:]
    kw = dict(capacity=capacity, chunk=8)
    want = jax_hop.fused_hop(*args, interpret=True, **kw)
    got = tref.fused_hop_ref(*(T(a) for a in args), **kw)
    _assert_same(want, got)


@pytest.mark.parametrize("seed,B,capacity", [(7, 5, 128), (8, 3, 256)])
def test_batched_hop_matches_pallas(seed, B, capacity):
    tables = _random_hop_inputs(seed)
    rng = np.random.default_rng(seed)
    n = len(tables[0]) - 1
    frontiers = np.zeros((B, capacity), np.int32)
    fmasks = np.zeros((B, capacity), bool)
    for q in range(B):
        c0 = rng.integers(1, 8)
        frontiers[q, :c0] = rng.integers(0, n, c0)
        fmasks[q, :c0] = True
    args = tables[:3] + (frontiers, fmasks) + tables[3:]
    kw = dict(capacity=capacity, chunk=8)
    want = jax_hop.batched_hop(*args, interpret=True, **kw)
    got = tref.batched_hop_ref(*(T(a) for a in args), **kw)
    _assert_same(want, got)


def _chain_graph(seed=5, n=40, m=160):
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n, m))
    row_ptr = np.zeros(n + 1, np.int64)
    np.add.at(row_ptr, src + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    col_idx = rng.integers(0, n, m).astype(np.int32)
    edge_id = rng.permutation(m).astype(np.int32)
    return row_ptr, col_idx, edge_id, rng


def test_traverse_chain_matches_pallas_chain():
    row_ptr, col_idx, edge_id, rng = _chain_graph()
    n, m = len(row_ptr) - 1, len(col_idx)
    members = [rng.random(n) < 0.8, None]
    edge_preds = [None, rng.random(m) < 0.5]
    alive = np.ones(-(-m // 8), bool)
    alive[::3] = False
    chunk_alives = [None, alive]
    start = np.arange(0, n, 4)
    kw = dict(capacity=256, chunk=8)
    jv, je, jok = jax_tops.traverse_chain(
        row_ptr, col_idx, edge_id, n, m, start, members, edge_preds,
        chunk_alives, use_kernel=True, **kw)
    tv, te, tok = tops.traverse_chain(
        T(row_ptr), T(col_idx), T(edge_id), n, m, start, members, edge_preds,
        chunk_alives, **kw)
    assert jok and tok and len(tv) == 3 and len(te) == 2
    for a, b in zip(jv + je, tv + te):
        assert b.dtype == np.int32 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # overflow is reported, not truncated
    _, _, ok = tops.traverse_chain(T(row_ptr), T(col_idx), T(edge_id), n, m,
                                   np.arange(n), [None, None], [None, None],
                                   [None, None], capacity=128, chunk=8)
    assert not ok


def test_batched_traverse_matches_pallas_batch():
    row_ptr, col_idx, edge_id, rng = _chain_graph(seed=9)
    n, m = len(row_ptr) - 1, len(col_idx)
    members, edge_preds, chunk_alives = [None], [rng.random(m) < 0.6], [None]
    starts = np.arange(0, 16)
    kw = dict(capacity=128, chunk=8)
    jv, je, jc, jok = jax_tops.batched_traverse(
        row_ptr, col_idx, edge_id, n, m, starts, members, edge_preds,
        chunk_alives, use_kernel=True, **kw)
    tv, te, tc, tok = tops.batched_traverse(
        T(row_ptr), T(col_idx), T(edge_id), n, m, starts, members,
        edge_preds, chunk_alives, **kw)
    assert jok and tok
    np.testing.assert_array_equal(np.asarray(jc), tc)
    for a, b in zip(jv + je, tv + te):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_traverse_chain_on_edgeless_graph():
    row_ptr = np.zeros(6, np.int64)
    empty = np.zeros(0, np.int32)
    jv, je, jok = jax_tops.traverse_chain(
        row_ptr, empty, empty, 5, 0, np.arange(5), [None], [None], [None],
        capacity=128, chunk=8, use_kernel=True)
    tv, te, tok = tops.traverse_chain(
        T(row_ptr), T(empty), T(empty), 5, 0, np.arange(5), [None], [None],
        [None], capacity=128, chunk=8)
    assert jok and tok
    assert [len(c) for c in tv] == [len(c) for c in jv] == [0, 0]
    assert [len(c) for c in te] == [0]


def _dispatch_cases():
    x = T(RNG.standard_normal((8, 4)).astype(np.float32))
    y = T(RNG.integers(0, 2, 8).astype(np.float32))
    w = T(np.zeros(4, np.float32))
    rp, ci, ei, mem, ep, ca = (T(a) for a in _random_hop_inputs(0))
    fr = torch.zeros(128, dtype=torch.int32)
    fm = torch.zeros(128, dtype=torch.bool)
    fm[:3] = True
    hop = (rp, ci, ei, fr, fm, mem, ep, ca)
    return [
        ("matmul", lambda **k: matmul(x, x.T, **k), lambda: matmul_ref(x, x.T)),
        ("cosine_sim", lambda **k: cosine_sim(x, x, **k),
         lambda: cosine_sim_ref(x, x)),
        ("logreg_grad", lambda **k: logreg_grad(x, y, w, **k),
         lambda: logreg_grad_ref(x, y, w)),
        ("batched_hop",
         lambda **k: tops.fused_hop(*hop, capacity=128, chunk=8, **k),
         lambda: tref.fused_hop_ref(*hop, capacity=128, chunk=8)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_cpu_tensor_takes_plain_version_and_never_launches(case):
    name, call, plain = _dispatch_cases()[case]
    before = launch_counts()
    for use_kernel in (None, False):
        got = call(use_kernel=use_kernel)
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert launch_counts() == before


@pytest.mark.parametrize("case", range(4))
def test_use_kernel_true_on_cpu_tensor_raises(case):
    name, call, _ = _dispatch_cases()[case]
    with pytest.raises(ValueError, match="CUDA"):
        call(use_kernel=True)
