"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the card at the reference sweep shapes, the wrappers' input
checks, the engine on the card against the same engine on the CPU, the
smoke-size LMs and serving scheduler, and each recsys and GNN family's
smoke config (with a sampled batch of -1 labels), on the card against the
CPU.
Skipped where there is no card; run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports neither JAX nor the JAX package (the card's machine runs the port
alone). Tolerances: fp32 matmul 2e-4, bf16 2e-2; cosine, logreg, flash
attention and embedding bag rtol 3e-4 / atol 3e-5 (different summation
order), bf16 flash attention 2e-2; traversal exact."""
import dataclasses
import math
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, wrapper_module
from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.logreg.ref import logreg_grad_ref
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.traversal import ref as tref
from torch_matgen_cases import (G1_SF40, KINDS, LAYOUTS, MODES, WIDTHS,
                                case_table)

pytestmark = pytest.mark.gpu
RNG = np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def kernel(name):
    """The kernel's wrapper (it launches; it never dispatches)."""
    return getattr(wrapper_module(name), name)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (128, 128, 128),
                                   (100, 60, 130), (257, 129, 65),
                                   (1000, 200, 1000), (129, 17, 257)])
def test_matmul_kernel_matches_plain(cuda, m, k, n, dtype, transposed):
    x = torch.as_tensor(RNG.standard_normal((m, k)), device=cuda).to(dtype)
    if transposed:
        y = torch.as_tensor(RNG.standard_normal((n, k)),
                            device=cuda).to(dtype).T
    else:
        y = torch.as_tensor(RNG.standard_normal((k, n)), device=cuda).to(dtype)
    before = launch_counts()["matmul"]
    got = kernel("matmul")(x, y)
    assert launch_counts()["matmul"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), matmul_ref(x, y).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,n,d", [(64, 64, 32), (100, 50, 96), (33, 65, 17)])
def test_cosine_kernel_matches_plain(cuda, m, n, d):
    x = torch.as_tensor(RNG.standard_normal((m, d)), device=cuda).float()
    y = torch.as_tensor(RNG.standard_normal((n, d)), device=cuda).float()
    torch.testing.assert_close(kernel("cosine_sim")(x, y),
                               cosine_sim_ref(x, y), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("n,d", [(100, 16), (512, 64), (65, 7),
                                 # one row; A1's shape; the shard
                                 # regression's d = 4; odd d (row starts
                                 # not 16-byte aligned); a d that shrinks
                                 # the row tile; a row wider than the
                                 # shared-memory budget (read in place)
                                 (1, 16), (15910, 200), (60000, 4),
                                 (1001, 33), (256, 4096), (3, 60000)])
def test_logreg_kernel_matches_plain(cuda, n, d):
    x = torch.as_tensor(RNG.standard_normal((n, d)), device=cuda).float()
    y = torch.as_tensor(RNG.integers(0, 2, n), device=cuda).float()
    w = torch.as_tensor(RNG.standard_normal(d) * 0.3, device=cuda).float()
    g1, l1 = kernel("logreg_grad")(x, y, w)
    g2, l2 = logreg_grad_ref(x, y, w)
    torch.testing.assert_close(g1, g2, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(l1, l2, rtol=3e-4, atol=3e-5)
    for _ in range(2):      # one launch per call, the same bits every call
        before = launch_counts()["logreg_grad"]
        g3, l3 = kernel("logreg_grad")(x, y, w)
        assert launch_counts()["logreg_grad"] == before + 1
        assert torch.equal(g3, g1) and torch.equal(l3, l1)


def test_logreg_kernel_reads_an_unaligned_view(cuda):
    """A contiguous view starting one float into its storage: the tile
    copies cannot take the 16-byte path."""
    n, d = 777, 12
    base = torch.as_tensor(RNG.standard_normal(n * d + 1),
                           device=cuda).float()
    x = base[1:].view(n, d)
    y = torch.as_tensor(RNG.integers(0, 2, n), device=cuda).float()
    w = torch.as_tensor(RNG.standard_normal(d) * 0.3, device=cuda).float()
    g1, l1 = kernel("logreg_grad")(x, y, w)
    g2, l2 = logreg_grad_ref(x, y, w)
    torch.testing.assert_close(g1, g2, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(l1, l2, rtol=3e-4, atol=3e-5)


def _hop_tables(seed, n, dev, chunk=8):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    m = int(row_ptr[-1])
    edge_pred = rng.random(max(m, 1)) < 0.6
    alive = np.array([edge_pred[c * chunk:(c + 1) * chunk].any()
                      for c in range(max(-(-max(m, 1) // chunk), 1))])
    arrays = (row_ptr, rng.integers(0, n, m).astype(np.int32),
              rng.permutation(m).astype(np.int32), rng.random(n) < 0.7,
              edge_pred, alive)
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def _assert_hops_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,capacity,n,c0", [(0, 128, 12, 6),
                                                (1, 128, 12, 6),
                                                (2, 256, 12, 6),
                                                (3, 2048, 400, 300)])
def test_fused_hop_kernel_matches_plain(cuda, seed, capacity, n, c0):
    from repro_torch.kernels.traversal.traversal import fused_hop
    rp, ci, ei, mem, ep, ca = _hop_tables(seed, n, cuda)
    rng = np.random.default_rng(seed + 100)
    fr = torch.zeros(capacity, dtype=torch.int32, device=cuda)
    fr[:c0] = torch.as_tensor(rng.integers(0, n, c0), device=cuda)
    fm = torch.zeros(capacity, dtype=torch.bool, device=cuda)
    fm[:c0] = True
    args = (rp, ci, ei, fr, fm, mem, ep, ca)
    kw = dict(capacity=capacity, chunk=8)
    _assert_hops_equal(fused_hop(*args, **kw), tref.fused_hop_ref(*args, **kw))


# random short frontiers: name -> (seed, capacity, vertices, B)
RANDOM_HOPS = {"random_b5": (7, 128, 12, 5), "random_b4": (8, 1024, 300, 4)}


def _csr_from_degrees(deg, seed, dev, chunk=8):
    """A random CSR with the given out-degrees, and its predicate tables."""
    rng = np.random.default_rng(seed)
    n = len(deg)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    m = int(row_ptr[-1])
    edge_pred = rng.random(max(m, 1)) < 0.6
    alive = np.array([edge_pred[c * chunk:(c + 1) * chunk].any()
                      for c in range(max(-(-max(m, 1) // chunk), 1))])
    arrays = (row_ptr, rng.integers(0, n, max(m, 1)).astype(np.int32),
              rng.permutation(max(m, 1)).astype(np.int32),
              rng.random(n) < 0.7, edge_pred, alive)
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def _hop_case(name, dev):
    """(tables, frontiers, fmasks, capacity) of one edge case of the hop."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name in RANDOM_HOPS:              # short frontiers of random lengths
        seed, capacity, n, B = RANDOM_HOPS[name]
        tables = _hop_tables(seed, n, dev)
        rng = np.random.default_rng(seed)
        fr = np.zeros((B, capacity), np.int64)
        fm = np.zeros((B, capacity), bool)
        for q in range(B):
            c0 = int(rng.integers(1, min(capacity // 8, 8 * n) + 1))
            fr[q, :c0] = rng.integers(0, n, c0)
            fm[q, :c0] = True
    elif name in ("empty", "total_is_capacity", "overflow"):
        # degree 32 everywhere: 0, 16 and 20 live entries give totals 0,
        # capacity and past it
        tables = _csr_from_degrees(np.full(40, 32), 1, dev)
        B, capacity = 2, 512
        live = {"empty": 0, "total_is_capacity": 16, "overflow": 20}[name]
        fr = rng.integers(0, 40, (B, capacity))
        fm = np.zeros((B, capacity), bool)
        fm[:, :live] = True
    elif name == "big_vertex":           # one row spans > 8 slot tiles
        deg = rng.integers(0, 9, 50)
        deg[7] = 5000
        tables = _csr_from_degrees(deg, 2, dev)
        B, capacity = 1, 8192
        fr = rng.integers(0, 50, (B, capacity))
        fr[0, :3] = [3, 7, 9]
        fm = np.zeros((B, capacity), bool)
        fm[0, :3] = True
    elif name == "ragged_b3":            # totals far apart
        tables = _csr_from_degrees(rng.integers(0, 40, 500), 3, dev)
        B, capacity = 3, 4096
        fr = rng.integers(0, 500, (B, capacity))
        fm = np.zeros((B, capacity), bool)
        fm[1, :5] = True
        fm[2, :150] = True
    elif name == "holes":                # mask not a prefix, 4 scan tiles
        tables = _csr_from_degrees(rng.integers(0, 6, 300), 4, dev)
        B, capacity = 2, 8192
        fr = rng.integers(0, 300, (B, capacity))
        fm = rng.random((B, capacity)) < 0.3
    elif name == "sparse_holes":         # a slot tile spans > 2048 entries
        deg = np.zeros(20, np.int64)
        deg[[2, 5]] = 100
        tables = _csr_from_degrees(deg, 5, dev)
        B, capacity = 1, 16384
        fr = np.full((B, capacity), 2)
        fm = np.zeros((B, capacity), bool)
        fm[0, [0, 10000]] = True
        fr[0, 10000] = 5
    else:                                # the main path's G5 shape
        tables = _csr_from_degrees(rng.integers(500, 1500, 2000), 6, dev)
        B, capacity = 1, 524288
        fr = rng.integers(0, 2000, (B, capacity))
        fm = np.zeros((B, capacity), bool)
        fm[0, :200] = True
    return (tables, torch.as_tensor(fr, dtype=torch.int32, device=dev),
            torch.as_tensor(fm, device=dev), capacity)


def _hop_matches_plain(name, dev):
    (rp, ci, ei, mem, ep, ca), fr, fm, capacity = _hop_case(name, dev)
    args = (rp, ci, ei, fr, fm, mem, ep, ca)
    kw = dict(capacity=capacity, chunk=8)
    _assert_hops_equal(kernel("batched_hop")(*args, **kw),
                       tref.batched_hop_ref(*args, **kw))


@pytest.mark.parametrize("name", [*RANDOM_HOPS, "empty", "total_is_capacity",
                                  "overflow", "big_vertex", "ragged_b3",
                                  "holes", "sparse_holes", "g5_shape"])
def test_batched_hop_kernel_matches_plain(cuda, name):
    _hop_matches_plain(name, cuda)


def test_batched_hop_kernel_alternating_shapes(cuda):
    """Shapes alternately on one stream: the cached workspace is reused (and
    grown) and every call finds the look-back words the last one left."""
    for name in ("holes", "ragged_b3", "holes", "big_vertex", "ragged_b3"):
        _hop_matches_plain(name, cuda)


def test_batched_hop_kernel_replays_in_a_cuda_graph(cuda):
    """A hop captured in a CUDA graph, replayed on new frontiers, gives the
    plain version's outputs every time: the kernels keep the state that
    resets the look-back on the card, none on the host."""
    (rp, ci, ei, mem, ep, ca), fr, fm, capacity = _hop_case("holes", cuda)
    args = (rp, ci, ei, fr, fm, mem, ep, ca)
    kw = dict(capacity=capacity, chunk=8)
    hop = kernel("batched_hop")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hop(*args, **kw)               # the workspace, outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = hop(*args, **kw)
    rng = np.random.default_rng(9)
    for _ in range(3):
        fr.copy_(torch.as_tensor(rng.integers(0, 300, fr.shape),
                                 dtype=torch.int32))
        fm.copy_(torch.as_tensor(rng.random(fm.shape) < 0.3))
        graph.replay()
        torch.cuda.synchronize()
        _assert_hops_equal(got, tref.batched_hop_ref(*args, **kw))


@pytest.mark.parametrize("b,h,hk,sq,skv,causal,dh,dtype", [
    (2, 4, 4, 64, 64, True, 64, torch.float32),       # the reference sweep
    (2, 8, 2, 100, 100, True, 64, torch.float32),
    (3, 8, 2, 1, 256, True, 64, torch.float32),
    (2, 4, 2, 48, 96, False, 64, torch.float32),
    (2, 4, 2, 32, 32, True, 16, torch.float32),       # the dh-16 case
    (2, 12, 2, 130, 130, True, 128, torch.bfloat16),  # Qwen2 GQA prefill
    (3, 12, 2, 1, 300, True, 128, torch.bfloat16),    # Qwen2 GQA decode
    (2, 8, 8, 70, 70, True, 80, torch.bfloat16),      # StableLM head dim
    (2, 16, 16, 130, 130, True, 128, torch.bfloat16),  # OLMoE MHA prefill
    (3, 16, 16, 1, 300, True, 128, torch.bfloat16),    # OLMoE MHA decode
])
def test_flash_kernel_matches_plain(cuda, b, h, hk, sq, skv, causal, dh,
                                    dtype):
    q = torch.as_tensor(RNG.standard_normal((b, h, sq, dh)),
                        device=cuda).to(dtype)
    k = torch.as_tensor(RNG.standard_normal((b, hk, skv, dh)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(RNG.standard_normal((b, hk, skv, dh)),
                        device=cuda).to(dtype)
    lens = torch.as_tensor(RNG.integers(max(sq, 1), skv + 1, b),
                           device=cuda).int()
    before = launch_counts()["flash_attention"]
    got = kernel("flash_attention")(q, k, v, lens, causal=causal)
    assert launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (3e-4, 3e-5)
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, lens, causal=causal).float(),
        rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("b,h,hk,sq,skv,dh,dtype,lens", [
    # decode split over many blocks; row 1 leaves all but its first split
    # wholly past its length
    (2, 12, 2, 1, 4096, 128, torch.bfloat16, [4000, 37]),
    # prefill whose packed rows (12 / 2 * 77) are not a multiple of 64,
    # ragged lengths, one below sq (its first rows see no key)
    (3, 12, 2, 77, 200, 128, torch.bfloat16, [60, 150, 200]),
    (1, 32, 32, 1, 500, 80, torch.bfloat16, [433]),    # StableLM decode
    (2, 4, 2, 33, 40, 8, torch.bfloat16, [33, 40]),    # dh 8: zero-padded
    (2, 4, 2, 32, 32, 16, torch.bfloat16, [32, 32]),   # dh 16
    (2, 8, 2, 1, 1024, 64, torch.float32, [1000, 5]),  # fp32, split decode
])
def test_flash_kernel_tensor_core_and_split_cases(cuda, b, h, hk, sq, skv,
                                                   dh, dtype, lens):
    from repro_torch.kernels.flash_attention.flash_attention import \
        num_splits
    q = torch.as_tensor(RNG.standard_normal((b, h, sq, dh)),
                        device=cuda).to(dtype)
    k = torch.as_tensor(RNG.standard_normal((b, hk, skv, dh)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(RNG.standard_normal((b, hk, skv, dh)),
                        device=cuda).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if sq == 1:
        assert num_splits(b, h, hk, sq, skv) > 1
    before = launch_counts()["flash_attention"]
    got = kernel("flash_attention")(q, k, v, lens)
    assert launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (3e-4, 3e-5)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v, lens).float(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views_and_whole_cache(cuda, dtype):
    """The transformer's inputs: q a transposed (b, s, h, dh) view, k/v the
    whole cache (skv = max_len) with lengths past the written part, one
    length below sq (its first rows see no key and give 0); fp32 runs the
    FFMA kernel, bf16 the tensor-core one."""
    b, s, h, hk, dh, M = 2, 5, 6, 2, 128, 40
    q = torch.randn((b, s, h, dh), device=cuda).to(dtype).transpose(1, 2)
    cache = torch.randn((3, b, hk, M, dh), device=cuda).to(dtype)
    lens = torch.tensor([17, 3], dtype=torch.int32, device=cuda)
    got = kernel("flash_attention")(q, cache[1], cache[2], lens)
    assert got.stride() == q.stride()
    want = flash_attention_ref(q, cache[1], cache[2], lens)
    tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (3e-4, 3e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])
    assert not got[1, :, :2].any()


def _bag_inputs(cuda, nbags, bag, V, D, weighted, dtype=torch.float32,
               wdtype=torch.float32, offset=0, exact=None):
    """Table (a contiguous view ``offset`` elements into a flat tensor),
    indices with bag 0 padded past its first slot, weights or None. Bags of
    more than 1000 slots take small integers as table values and quarters
    as weights, so that every order of summation is exact in fp32: the
    plain version and the kernel (its j split) sum in different orders, and
    a sum of 4096 normal values that cancels differs between two orders by
    more than rtol 3e-4 / atol 3e-5 of its small result."""
    exact = bag > 1000 if exact is None else exact
    flat = (RNG.integers(-8, 8, offset + V * D) if exact
            else RNG.standard_normal(offset + V * D))
    flat = torch.as_tensor(flat, device=cuda).to(dtype)
    table = flat[offset:offset + V * D].view(V, D)
    idx = RNG.integers(0, V, (nbags, bag)).astype(np.int32)
    idx[0, 1:] = -1
    idx = torch.as_tensor(idx, device=cuda)
    w = None
    if weighted:
        w = (RNG.integers(0, 5, (nbags, bag)) / 4 if exact
             else RNG.random((nbags, bag)))
        w = torch.as_tensor(w, device=cuda).to(wdtype)
    return table, idx, w


BF16, F16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("nbags,bag,V,D,weighted,kw", [
    (8, 4, 64, 16, True, {}), (16, 8, 500, 32, True, {}),
    (16, 8, 500, 32, False, {}), (300, 16, 1000, 200, True, {}),
    # the scalar path: widths whose rows are not whole 16-byte chunks
    (40, 7, 300, 1, True, {}), (40, 7, 300, 3, False, {}),
    (40, 7, 300, 33, True, {}),
    # 16-byte loads, one to four bags a warp, and column chunks past 128
    (100, 9, 1000, 64, True, {}), (100, 9, 1000, 128, False, {}),
    # a table 4 bytes off 16-byte alignment takes the scalar path
    (100, 9, 1000, 64, True, dict(offset=1)),
    # one slot a bag; j split over warps; many one-slot bags
    (50, 1, 1000, 64, True, {}), (8, 4096, 10_000, 64, True, {}),
    (8, 4096, 10_000, 128, False, {}), (262_144, 1, 1000, 64, True, {}),
    # bf16 and fp16 tables, weighted (fp32 and table-typed) and unweighted
    (100, 9, 1000, 64, True, dict(dtype=BF16)),
    (100, 9, 1000, 64, True, dict(dtype=BF16, wdtype=BF16)),
    (100, 9, 1000, 128, False, dict(dtype=BF16)),
    (100, 9, 1000, 64, True, dict(dtype=F16)),
    (100, 9, 1000, 64, True, dict(dtype=F16, wdtype=F16)),
    (100, 9, 1000, 128, False, dict(dtype=F16)),
    (100, 9, 1000, 20, True, dict(dtype=BF16, offset=3)),
])
def test_embedding_bag_kernel_matches_plain(cuda, nbags, bag, V, D,
                                            weighted, kw):
    table, idx, w = _bag_inputs(cuda, nbags, bag, V, D, weighted, **kw)
    before = launch_counts()["embedding_bag"]
    got = kernel("embedding_bag")(table, idx, w)
    assert launch_counts()["embedding_bag"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, embedding_bag_ref(table, idx, w),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("D,weighted,dtype", [(64, True, torch.float32),
                                               (128, False, BF16)])
def test_embedding_bag_kernel_long_normal_bags_within_summation_bound(
        cuda, D, weighted, dtype):
    """8 bags x 4096 of normal values (the j split) against a float64 sum,
    within Higham and Mary's probabilistic bound for fp32 summation of
    n = 4096 exact terms in any order, lam = 8 (it holds with probability
    1 - 1e-10 under independent rounding errors): gamma * sum_j |w * row|
    per element, gamma = exp(lam sqrt(n) u + n u^2 / (1 - u)) - 1. A
    dropped slot, a wrong row or 16-bit sums exceed it."""
    table, idx, w = _bag_inputs(cuda, 8, 4096, 10_000, D, weighted,
                                dtype=dtype, exact=False)
    got = kernel("embedding_bag")(table, idx, w)
    valid = idx >= 0
    w64 = valid.double() if w is None else w.double() * valid
    terms = table[idx.clamp_min(0).long()].double() * w64[..., None]
    n, u, lam = idx.shape[1], 2.0 ** -24, 8.0
    gamma = math.expm1(lam * math.sqrt(n) * u + n * u * u / (1 - u))
    bound = gamma * terms.abs().sum(1)
    assert ((got.double() - terms.sum(1)).abs() <= bound).all()


@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_kernel_padding_over_non_finite_row(cuda, weighted):
    """A padded slot reads row 0 with weight 0, as the reference does: a
    NaN in row 0 makes every bag with a padded slot NaN, and a bag that is
    all padding sums to 0 over a finite row 0."""
    table, idx, w = _bag_inputs(cuda, 6, 5, 40, 64, weighted)
    idx[1] = -1                                  # all padding
    got = kernel("embedding_bag")(table, idx, w)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    table[0, 5] = float("nan")
    got = kernel("embedding_bag")(table, idx, w)
    want = embedding_bag_ref(table, idx, w)
    assert torch.isnan(want[:2, 5]).all() and torch.isnan(got[:2, 5]).all()
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-5,
                               equal_nan=True)


@pytest.mark.parametrize("nbags,bag,D", [(4096, 16, 64), (8, 4096, 64)])
def test_embedding_bag_kernel_gives_the_same_bits(cuda, nbags, bag, D):
    """No atomics: two calls give the same bits (the j split included), on
    normal values whose sums round differently in another order."""
    table, idx, w = _bag_inputs(cuda, nbags, bag, 10_000, D, True,
                                exact=False)
    bag_k = kernel("embedding_bag")
    assert torch.equal(bag_k(table, idx, w), bag_k(table, idx, w))


def test_embedding_bag_kernel_replays_in_a_cuda_graph(cuda):
    """A bag captured in a CUDA graph, replayed on new indices, gives the
    plain version's output every time (the launch keeps no host state)."""
    table, idx, w = _bag_inputs(cuda, 512, 16, 5000, 64, True, dtype=BF16)
    bag_k = kernel("embedding_bag")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bag_k(table, idx, w)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = bag_k(table, idx, w)
    torch.cuda.current_stream().wait_stream(side)
    rng = np.random.default_rng(9)
    for _ in range(3):
        new = rng.integers(-1, 5000, idx.shape).astype(np.int32)
        idx.copy_(torch.as_tensor(new))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, embedding_bag_ref(table, idx, w),
                                   rtol=3e-4, atol=3e-5)


def test_kernels_launch_on_the_current_stream(cuda):
    """The wrappers launch on PyTorch's current stream, and the hop keeps a
    workspace per stream: a side stream gives the plain version's outputs."""
    from repro_torch.kernels import _lib
    x = torch.ones(4, device=cuda)
    side = torch.cuda.Stream()
    assert _lib.stream_of(x) == torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(side):
        assert _lib.stream_of(x) == side.cuda_stream
        (rp, ci, ei, mem, ep, ca), fr, fm, capacity = _hop_case("holes",
                                                                cuda)
        args = (rp, ci, ei, fr, fm, mem, ep, ca)
        got = kernel("batched_hop")(*args, capacity=capacity, chunk=8)
    side.synchronize()
    _assert_hops_equal(got, tref.batched_hop_ref(*args, capacity=capacity,
                                                 chunk=8))


def test_wrappers_reject_inputs_they_do_not_take(cuda):
    x = torch.ones((4, 4), device=cuda)
    with pytest.raises(TypeError):
        kernel("matmul")(x.double(), x.double())
    with pytest.raises(ValueError):
        kernel("matmul")(x[:, ::2], x[::2])
    with pytest.raises(ValueError):
        kernel("cosine_sim")(x, torch.ones((4, 3), device=cuda))
    with pytest.raises(ValueError):
        kernel("logreg_grad")(x, torch.ones(3, device=cuda),
                              torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        kernel("matmul")(x.cpu(), x.cpu())
    q = torch.ones((1, 4, 3, 64), device=cuda)
    kv = torch.ones((1, 2, 5, 64), device=cuda)
    flash = kernel("flash_attention")
    with pytest.raises(TypeError):
        flash(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):            # h not a multiple of hk
        flash(torch.ones((1, 3, 3, 64), device=cuda), kv, kv)
    with pytest.raises(ValueError):            # head dim above 128
        big = torch.ones((1, 2, 3, 256), device=cuda)
        flash(big, big, big)
    with pytest.raises(ValueError):            # last dim not contiguous
        flash(q, kv.transpose(2, 3), kv)
    with pytest.raises(ValueError):            # lengths of another batch
        flash(q, kv, kv, torch.ones(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        flash(q, kv.cpu(), kv)
    bag = kernel("embedding_bag")
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bag(x, idx.long())
    with pytest.raises(TypeError):
        bag(x.double(), idx)
    with pytest.raises(TypeError):             # fp16 weights, bf16 table
        bag(x.bfloat16(), idx, torch.ones((2, 3), device=cuda).half())
    assert bag(x.bfloat16(), idx).dtype == torch.float32
    with pytest.raises(ValueError):
        bag(x, idx, torch.ones((2, 2), device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        bag(x, idx.cpu())
    (rp, ci, ei, mem, ep, ca), fr, fm, capacity = _hop_case("holes", cuda)
    hop = kernel("batched_hop")
    kw = dict(capacity=capacity, chunk=8)
    with pytest.raises(TypeError):
        hop(rp, ci, ei, fr.long(), fm, mem, ep, ca, **kw)
    with pytest.raises(ValueError):            # a strided frontier
        hop(rp, ci, ei, fr[:, ::2], fm[:, ::2], mem, ep, ca, **kw)
    with pytest.raises(ValueError):            # masks of another shape
        hop(rp, ci, ei, fr, fm[:1], mem, ep, ca, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        hop(rp.cpu(), ci, ei, fr, fm, mem, ep, ca, **kw)
    gen = kernel("matgen")
    ids = np.arange(4)
    with pytest.raises(ValueError, match="CUDA"):
        gen(ids, ids, 4, device="cpu")
    with pytest.raises(TypeError):              # float group ids
        gen(ids.astype(np.float64), ids, 4, device=cuda)
    with pytest.raises(ValueError):             # pairs of unequal length
        gen(ids, ids[:3], 4, device=cuda)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS + (G1_SF40,))
def test_matgen_kernel_matches_numpy(cuda, kind, layout, mode, d):
    """The card's random-access matrix equals the numpy path's (which
    ``test_torch_kernels.py`` holds to the JAX package on these cases) bit
    for bit, with the same group ids; a call with pairs launches."""
    from repro_torch.core import analytics
    t = case_table(kind, layout)
    want, want_groups = analytics.random_access_matrix(t, "g", "v", d, mode,
                                                       device="cpu")
    pairs = len(analytics.random_access_pairs(t, "g", "v")[0])
    before = launch_counts()["matgen"]
    got, groups = analytics.random_access_matrix(t, "g", "v", d, mode,
                                                 device=cuda)
    assert launch_counts()["matgen"] == before + (pairs > 0)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert groups.dtype == want_groups.dtype
    np.testing.assert_array_equal(groups, want_groups)


def test_engine_on_card_matches_cpu_and_launches_every_kernel(cuda):
    from repro_torch.core import GredoEngine, analytics
    from repro_torch.core.observe import result_fingerprint
    from repro_torch.data import m2bench
    db = m2bench.generate(sf=1, seed=0)
    gpu, cpu = GredoEngine(db), GredoEngine(db, device="cpu")
    assert gpu.device.type == "cuda"
    before = launch_counts()
    for q in (m2bench.q_g1, m2bench.q_g2, m2bench.q_g3, m2bench.q_g4,
              m2bench.q_g5, m2bench.q_opt_skew):
        assert result_fingerprint(gpu.query(q())) == \
            result_fingerprint(cpu.query(q()))
    for task, (rtol, atol) in ((m2bench.a2_similarity, (3e-4, 3e-5)),
                               (m2bench.a3_multiply, (2e-4, 2e-4)),
                               (m2bench.a_shard_reg, (3e-4, 3e-5))):
        got = gpu.analyze(task())
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), cpu.analyze(task()),
                                   rtol=rtol, atol=atol)
    X, _ = analytics.random_access_matrix(
        gpu.query(m2bench.q_g1()), "Customer.id", "t.tid", m2bench.N_TAGS,
        device=cuda)
    y = (X[:, 0] > 0).float()
    w, loss = analytics.regression(X, y, iters=20)
    w_p, loss_p = analytics.regression(X.cpu(), y.cpu(), iters=20)
    torch.testing.assert_close(w.cpu(), w_p, rtol=3e-4, atol=3e-5)
    after = launch_counts()
    gcdia = ("matmul", "cosine_sim", "logreg_grad", "batched_hop", "matgen")
    assert all(after[k] > before[k] for k in gcdia), (before, after)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "stablelm_3b",
                                  "starcoder2_3b", "olmoe_1b_7b",
                                  "granite_moe_1b_a400m"])
def test_smoke_lm_on_card_matches_cpu(cuda, arch):
    """The smoke-size model, same fp32 weights: the card (flash kernel)
    against the CPU (plain versions), a full forward and a cached prefill +
    decode step, and the scheduler's greedy tokens."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = dataclasses.replace(configs.get(arch).smoke_config(),
                              dtype=torch.float32, attn_impl="flash")
    cpu = tf.init_params(torch.Generator().manual_seed(0), cfg)
    gpu = {k: v for k, v in cpu.items() if k != "layers"}
    gpu = {k: v.to(cuda) for k, v in gpu.items()}
    gpu["layers"] = {k: v.to(cuda) for k, v in cpu["layers"].items()}
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (3, 40)))
    before = launch_counts()["flash_attention"]
    got, aux = tf.forward(gpu, toks.to(cuda), cfg)
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    want, want_aux = tf.forward(cpu, toks, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)
    lens = torch.zeros(3, dtype=torch.int32)
    c_cpu, c_gpu = tf.init_cache(cfg, 3, 64), tf.init_cache(cfg, 3, 64, cuda)
    want, c_cpu = tf.forward(cpu, toks, cfg, cache=c_cpu, cache_lengths=lens)
    got, c_gpu = tf.forward(gpu, toks.to(cuda), cfg, cache=c_gpu,
                            cache_lengths=lens.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-5)
    nxt = toks[:, :1]
    want, _ = tf.serve_step(cpu, c_cpu, nxt, lens + 40, cfg)
    got, _ = tf.serve_step(gpu, c_gpu, nxt.to(cuda), (lens + 40).to(cuda),
                           cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-5)

    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, cfg.vocab, rng.integers(4, 30)),
             int(rng.integers(3, 12))) for i in range(6)]
    outs = [ContinuousBatcher(p, cfg, n_slots=2, max_len=64).serve(
        [Request(rid=i, prompt=pr, max_new=m) for i, pr, m in reqs])
        for p in (cpu, gpu)]
    assert [c.tokens for c in outs[0]] == [c.tokens for c in outs[1]]


def test_moe_routing_ties_on_card(cuda):
    """Equal router logits on the card: the lower expert first (the
    stable sort), the same routing and capacity cut as on the CPU."""
    from repro_torch.models import transformer as tf
    cfg = tf.TransformerConfig(n_layers=1, d_model=32, n_heads=2,
                               n_kv_heads=2, d_ff=32, vocab=64, n_experts=8,
                               top_k=2, capacity_factor=1.0,
                               dtype=torch.float32)
    router = torch.as_tensor(RNG.standard_normal((32, 8)),
                             dtype=torch.float32)
    router[:, 1::2] = router[:, 0::2]
    x = torch.as_tensor(RNG.standard_normal((2, 96, 32)), dtype=torch.float32)
    x[:, :16] = 0.0                     # 16 tokens tie across all experts
    want = tf._moe_route(x, router, cfg)
    got = tf._moe_route(x.to(cuda), router.to(cuda), cfg)
    for name in ("idx", "order", "sorted_e", "keep"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    assert bool((~want.keep).any())


def test_trainer_step_on_card_matches_cpu(cuda, tmp_path):
    """One Trainer step of the Granite-MoE smoke config in fp32 (TF32 off)
    from the same weights and batch on the card and on the CPU: the loss
    within 1e-5 (relative), each gradient within 1e-4 of its tensor's
    largest, and the updated weights within 1e-4 (a third of one step at
    lr 3e-4) wherever the clipped gradient is at least 100 x AdamW's eps;
    nearer eps a first step multiplies the gradients' last-bit difference
    by lr / eps (``chip_smoke.py``'s limits)."""
    from repro_torch import configs
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import (AdamWConfig, global_norm,
                                             tree_leaves, tree_map)
    cfg = dataclasses.replace(configs.get("granite_moe_1b_a400m")
                              .smoke_config(), dtype=torch.float32)
    stream = TokenStream(vocab=cfg.vocab, batch=4, seq=32)
    p0 = tf.init_params(torch.Generator().manual_seed(0), cfg)
    runs, grads = {}, {}
    for dev in (torch.device("cpu"), cuda):
        params = tree_map(lambda t, dev=dev: t.to(dev), p0)
        data = lambda s, dev=dev: {k: torch.as_tensor(v, device=dev)  # noqa
                                   for k, v in stream.batch_at(s).items()}
        tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tf.loss_fn(tracked, data(0), cfg)
        grads[dev.type] = torch.autograd.grad(loss, tree_leaves(tracked))
        t = Trainer(lambda p, b: tf.loss_fn(p, b, cfg), params, data,
                    TrainerConfig(total_steps=1, ckpt_every=0, log_every=1,
                                  ckpt_dir=str(tmp_path / dev.type)))
        t.run(resume=False)
        assert all(p.device.type == dev.type for p in tree_leaves(t.params))
        runs[dev.type] = t
    a, b = runs["cuda"], runs["cpu"]
    assert abs(a.metrics[0]["loss"] - b.metrics[0]["loss"]) <= \
        1e-5 * abs(b.metrics[0]["loss"])
    opt = AdamWConfig()
    clip = min(1.0, opt.grad_clip / (float(global_norm(grads["cpu"])) + 1e-9))
    for p, q, gc, g in zip(tree_leaves(a.params), tree_leaves(b.params),
                           grads["cuda"], grads["cpu"]):
        assert float((gc.cpu() - g).abs().max()) <= 1e-4 * float(
            g.abs().max())
        held = g.abs() * clip >= 100 * opt.eps
        torch.testing.assert_close(p.cpu()[held], q[held], rtol=0, atol=1e-4)


def _to(x, dev):
    """Tensors, dicts, lists and graph batches moved to ``dev``."""
    from repro_torch.models.gnn.common import GraphBatch
    if isinstance(x, GraphBatch) or torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _grad_gaps(a, b):
    """Each gradient's max |card - cpu| over its largest |cpu|; a linear
    layer's bias (``b`` beside ``w``) over the largest of its own and its
    weight's (an attention MLP's last bias has a zero gradient in exact
    arithmetic under the edge softmax: rounding alone)."""
    if torch.is_tensor(b):
        yield float((a.cpu() - b).abs().max()), float(b.abs().max())
    elif isinstance(b, dict):
        for k in sorted(b):
            for gap, scale in _grad_gaps(a[k], b[k]):
                if k == "b" and "w" in b:
                    scale = max(scale, float(b["w"].abs().max()))
                yield gap, scale
    elif b is not None:
        for u, v in zip(a, b):
            yield from _grad_gaps(u, v)


def _family_case(name):
    """(module, cfg, params on the CPU, extra loss args on the CPU) of one
    family's smoke config; PNA and EquiformerV2 in float64 (ill-conditioned
    in fp32 in both packages: PNA's std aggregator where a node's messages
    are all equal, EquiformerV2's norm of its near-zero l >= 1 blocks)."""
    from repro_torch import configs
    from repro_torch.data import graphs
    from repro_torch.models import dcn_v2, recsys
    from repro_torch.models.gnn import equiformer_v2, gat, gatedgcn, mace, pna
    from repro_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(0)
    if name in ("wide_deep", "dcn_v2"):
        mod = recsys if name == "wide_deep" else dcn_v2
        cfg = (configs.get("wide_deep").smoke_config() if mod is recsys
               else dcn_v2.DCNv2Config(vocab_per_field=500, embed_dim=4,
                                       n_sparse=6, n_dense=3, cross_rank=8,
                                       mlp=(16, 8)))
        return mod, cfg, mod.init_params(gen, cfg), (
            mod.random_batch(cfg, 64, seed=1, device="cpu"),)
    if name in ("mace", "equiformer_v2"):
        mod = mace if name == "mace" else equiformer_v2
        cfg = configs.get(name).smoke_config()
        g, e = graphs.random_molecule_batch(4, 8, 20, n_species=cfg.n_species,
                                            device="cpu")
        p = mod.init_params(gen, cfg)
        if name == "equiformer_v2":
            import dataclasses as dc
            p = tree_map(lambda t: t.double(), p)
            g = dc.replace(g, pos=g.pos.double())
        return mod, cfg, p, (g, e)
    mod = {"gatedgcn": gatedgcn, "pna": pna, "gat": gat}[name]
    cfg = (gat.GATConfig(n_layers=2, d_hidden=16, n_heads=4, d_in=24,
                         n_classes=4) if name == "gat"
           else configs.get(name).smoke_config())
    g, labels = graphs.random_feature_graph(60, 240, cfg.d_in, cfg.n_classes,
                                            seed=1, device="cpu")
    p = mod.init_params(gen, cfg)
    if name == "pna":
        import dataclasses as dc
        p = tree_map(lambda t: t.double(), p)
        g = dc.replace(g, x=g.x.double())
    return mod, cfg, p, (g, labels)


@pytest.mark.parametrize("name", ["wide_deep", "dcn_v2", "gatedgcn", "pna",
                                  "gat", "mace", "equiformer_v2"])
def test_smoke_family_on_card_matches_cpu(cuda, name):
    """Each recsys and GNN family's smoke config, the same weights and
    inputs on the card and on the CPU (fp32, TF32 off; PNA and
    EquiformerV2 float64):
    the loss within 1e-5 (relative) and each gradient within 1e-4 of its
    tensor's largest (``_grad_gaps``; scatter-adds on the card sum in no
    fixed order)."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import tree_leaves
    mod, cfg, p, args = _family_case(name)
    lc, gc = value_and_grad(mod.loss_fn, _to(p, cuda), *_to(args, cuda), cfg)
    lh, gh = value_and_grad(mod.loss_fn, p, *args, cfg)
    assert all(t.device.type == "cuda" for t in tree_leaves(gc))
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for gap, scale in _grad_gaps(gc, gh):
        assert gap <= 1e-4 * scale


@pytest.mark.parametrize("name", ["gatedgcn", "pna", "gat"])
def test_sampled_batch_with_unlabelled_nodes_on_card(cuda, name):
    """A ``NeighborSampler`` batch on the card: every node but the seeds
    has label -1; the loss and its backward run without a device-side
    assert, and agree with the CPU (fp32; PNA float64)."""
    import dataclasses as dc
    from repro_torch.data.graphs import NeighborSampler
    from repro_torch.train.loop import value_and_grad
    mod, cfg, p, _ = _family_case(name)
    rng = np.random.default_rng(3)
    n = 400
    src, dst = rng.integers(0, n, 900), rng.integers(0, n, 900)
    x = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    s = NeighborSampler(n, src, dst, x, rng.integers(0, cfg.n_classes, n),
                        fanouts=(5, 3), seed=0)
    seeds = rng.integers(0, n, 16)
    g, labels = s.sample(seeds, device=cuda)
    assert g.x.device.type == "cuda" and bool((labels == -1).any())
    if name == "pna":
        g = dc.replace(g, x=g.x.double())
    lc, gc = value_and_grad(mod.loss_fn, _to(p, cuda), g, labels, cfg)
    torch.cuda.synchronize()
    lh, gh = value_and_grad(mod.loss_fn, p, g.to("cpu"), labels.cpu(), cfg)
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for gap, scale in _grad_gaps(gc, gh):
        assert gap <= 1e-4 * scale


# ---------------------------------------------------------------------------
# The mesh layer on a world of one (NCCL, a 1x1 mesh on the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    try:
        yield make_local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_gcda_mesh_forms_on_card_match_plain(nccl_mesh, cuda):
    """multiply, similarity and regression_distributed on the card's 1x1
    mesh: their kernels launch, and the results equal the plain versions
    (matmul 2e-4; cosine and logreg rtol 3e-4 / atol 3e-5)."""
    from repro_torch.core import analytics
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal((300, 70)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(rng.standard_normal((70, 90)), dtype=torch.float32,
                        device=cuda)
    lab = (x[:, 0] > 0).float()
    before = launch_counts()
    z = analytics.multiply(x, y, mesh=nccl_mesh).to_local()
    s = analytics.similarity(x, x[:50], mesh=nccl_mesh).to_local()
    w, loss = analytics.regression_distributed(x, lab, nccl_mesh, iters=20)
    after = launch_counts()
    for name in ("matmul", "cosine_sim", "logreg_grad"):
        assert after[name] > before[name], name
    torch.testing.assert_close(z, matmul_ref(x, y), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, cosine_sim_ref(x, x[:50]), rtol=3e-4,
                               atol=3e-5)
    w_p, loss_p = analytics.regression(x, lab, iters=20, use_kernel=False)
    torch.testing.assert_close(w, w_p, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(loss, loss_p, rtol=3e-4, atol=3e-5)


def test_non_contiguous_blocks_reach_each_kernel(nccl_mesh, cuda):
    """A column block of Y, a transposed Y and strided row views go through
    the mesh forms' block step (one copy where a wrapper needs contiguous
    rows) and give the plain versions' values."""
    from repro_torch.core import analytics
    rng = np.random.default_rng(12)
    base = torch.as_tensor(rng.standard_normal((256, 160)),
                           dtype=torch.float32, device=cuda)
    x = base[::2, :64]                   # strided rows, a column slice
    yt = base[:64, 64:].T.T              # a view whose rows are not packed
    assert not x.is_contiguous() and not yt.is_contiguous()
    z = analytics.multiply(x, yt, mesh=nccl_mesh).to_local()
    torch.testing.assert_close(z, matmul_ref(x.contiguous(), yt.contiguous()),
                               rtol=2e-4, atol=2e-4)
    s = analytics.similarity(x, base[1::2, 10:74], mesh=nccl_mesh).to_local()
    torch.testing.assert_close(
        s, cosine_sim_ref(x.contiguous(), base[1::2, 10:74].contiguous()),
        rtol=3e-4, atol=3e-5)
    lab = (x[:, 1] > 0).float()
    w, loss = analytics.regression_distributed(x, lab, nccl_mesh, iters=5)
    w_p, loss_p = analytics.regression(x.contiguous(), lab, iters=5,
                                       use_kernel=False)
    torch.testing.assert_close(w, w_p, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(loss, loss_p, rtol=3e-4, atol=3e-5)
