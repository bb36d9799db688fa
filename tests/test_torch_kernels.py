"""The port's kernels: six held against the JAX package's Pallas kernels,
and random-access matrix generation (``matgen``) held against the JAX
package's host function ``random_access_matrix``, bit for bit.

The same numpy inputs, made from a seed, go through the Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` and
``tests/test_traversal_kernels.py`` run it on the CPU) and through the
port's plain PyTorch version — the function the port's kernel is held to on
the card. Tolerances are the reference sweep's: fp32 matmul 2e-4, bf16
2e-2; cosine, logreg, flash attention and embedding bag rtol 3e-4 / atol
3e-5; traversal exact. Also the
dispatch rules: a CPU tensor takes the plain version and never launches,
``use_kernel=True`` on a CPU tensor raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as jax_analytics
from repro.core import storage as jax_storage
from repro.kernels.cosine_sim.cosine_sim import cosine_sim as jax_cosine
from repro.kernels.embedding_bag.embedding_bag import \
    embedding_bag as jax_bag
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash
from repro.kernels.logreg.logreg import logreg_grad as jax_logreg
from repro.kernels.matmul.matmul import matmul as jax_matmul
from repro.kernels.traversal import ops as jax_tops
from repro.kernels.traversal import traversal as jax_hop
from repro_torch.kernels import launch_counts
from repro_torch.kernels.cosine_sim.ops import cosine_sim
from repro_torch.kernels.cosine_sim.ref import cosine_sim_ref
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    TARGET_BLOCKS, num_splits, split_size)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_split_ref)
from repro_torch.kernels.logreg.ops import logreg_grad
from repro_torch.kernels.logreg.ref import logreg_grad_ref
from repro_torch.kernels.matgen.matgen import rank
from repro_torch.kernels.matgen.ops import matgen
from repro_torch.kernels.matgen.ref import matgen_ref
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.traversal import ops as tops
from repro_torch.kernels.traversal import ref as tref

from repro_torch.core import analytics
from repro_torch.core.storage import RaggedColumn
from torch_matgen_cases import (G1_SF40, KINDS, LAYOUTS, MODES, WIDTHS,
                                case_table)

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


@pytest.mark.parametrize("n,d,bn", [(100, 16, 32), (512, 64, 128), (65, 7, 16),
                                    # the shard regression's width; one row
                                    (300, 4, 64), (1, 16, 8)])
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


# the last two: candidates overflowing the capacity; an empty frontier
HOP_CASES = [(0, 128, 12, 6), (1, 128, 12, 6), (2, 256, 12, 6),
             (3, 512, 60, 40), (4, 128, 12, 60), (5, 128, 12, 0)]


@pytest.mark.parametrize("seed,capacity,n,c0", HOP_CASES)
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


@pytest.mark.parametrize("seed,capacity,n,c0", HOP_CASES)
def test_hop_phases_match_reference_prelude(seed, capacity, n, c0):
    """Each phase of the plain hop against the reference: the degree scan
    against the jnp prelude of ``batched_hop`` (out_off, total, overflowed),
    the expand phase, fed that prelude, against the Pallas kernel."""
    tables = _random_hop_inputs(seed, n=n)
    rng = np.random.default_rng(seed + 100)
    frontiers = np.zeros((2, capacity), np.int32)
    fmasks = np.zeros((2, capacity), bool)
    frontiers[0, :c0] = rng.integers(0, n, c0)
    fmasks[0, :c0] = True
    live = rng.random(capacity) < 0.03          # a mask with holes
    frontiers[1] = rng.integers(0, n, capacity)
    fmasks[1] = live
    row_ptr, col_idx, edge_id, member, edge_pred, chunk_alive = tables
    fr = jnp.asarray(frontiers)
    rp = jnp.asarray(row_ptr)
    deg = jnp.where(fmasks, (rp[fr + 1] - rp[fr]).astype(jnp.int32), 0)
    out_off = (jnp.cumsum(deg, axis=1) - deg).astype(jnp.int32)
    total = jnp.sum(deg, axis=1, dtype=jnp.int32)
    _assert_same((out_off, total, total > capacity),
                 tref.hop_degree_scan_ref(T(row_ptr), T(frontiers),
                                          T(fmasks), capacity=capacity))
    kw = dict(capacity=capacity, chunk=8)
    want = jax_hop.batched_hop(*tables[:3], frontiers, fmasks, *tables[3:],
                               interpret=True, **kw)
    got = tref.hop_expand_ref(T(row_ptr), T(col_idx), T(edge_id),
                              T(frontiers), T(np.asarray(out_off)),
                              T(np.asarray(total)), T(member), T(edge_pred),
                              T(chunk_alive), **kw)
    _assert_same(want[:4], got)


def test_logreg_plan_fills_the_card():
    """The row tile comes from the shape: at A1 at least two blocks per SM
    of an H100, with lanes per row so that one pass covers the tile's rows
    (a thread per row at the shard regression's d = 4); a wide d
    shrinks the tile to the shared-memory budget. The cross-block sum takes
    one level where the partials are few (the shard regression), two at
    A1."""
    from repro_torch.kernels.logreg.logreg import TILE_BUDGET, plan
    rows, blocks, lanes, _ = plan(15910, 200, 132)
    assert blocks >= 2 * 132 and rows * 200 <= TILE_BUDGET
    assert rows * lanes <= 256 < 2 * rows * lanes      # one pass of rows
    rows, blocks, lanes, _ = plan(60000, 4, 132)
    assert blocks >= 2 * 132 and lanes == 1
    rows, blocks, lanes, _ = plan(256, 4096, 132)
    assert rows * 4096 <= TILE_BUDGET and blocks * rows >= 256
    # the reduction: one level where the partials are few, else groups
    assert plan(1, 7, 132) == (1, 1, 8, 1)
    assert plan(256, 4096, 132)[2] == 32
    assert plan(60000, 4, 132)[3] == plan(60000, 4, 132)[1]
    assert plan(15910, 200, 132)[3] == 16


def test_embedding_bag_plan_covers_the_row():
    """16-byte loads where the row and the table's alignment allow them,
    else one value a load (4 columns a lane); the least power of two of
    lanes whose loads cover the row (a row wider than a warp's loads takes column chunks);
    narrow rows share a warp; the grid fills the card at the kernels_bench
    shape and at the DLRM-DCNv2 bag; j is split over warps only for few,
    long bags."""
    from repro_torch.kernels.embedding_bag.embedding_bag import (
        BLOCKS_PER_SM, MIN_SLICE, WARPS, plan)
    for D in (1, 3, 16, 20, 32, 33, 64, 128, 200, 1000):
        for elt in (4, 2):
            for aligned in (True, False):
                vec, lanes, splits, blocks = plan(4096, 16, D, elt, aligned,
                                                  132)
                assert (vec > 1) == (aligned and D * elt % 16 == 0)
                assert vec == 1 or vec * elt == 16
                assert lanes & (lanes - 1) == 0 and lanes <= 32
                cols = vec if vec > 1 else 4               # a lane's
                assert lanes * cols >= D or lanes == 32    # covers D
                assert lanes == 1 or lanes // 2 * cols < D  # and no more
                assert 32 // lanes * lanes <= 32           # bags a warp
                assert splits == 1 and blocks >= 1
    assert plan(4096, 16, 32, 4, True, 132)[:2] == (4, 8)     # 4 bags a warp
    assert plan(4096, 16, 64, 4, True, 132)[:2] == (4, 16)    # 2 bags a warp
    assert plan(4096, 16, 128, 4, True, 132)[:2] == (4, 32)
    assert plan(4096, 16, 64, 2, True, 132)[:2] == (8, 8)     # bf16
    assert plan(4096, 16, 64, 4, False, 132)[:2] == (1, 16)   # misaligned
    assert plan(4096, 16, 66, 2, True, 132)[0] == 1           # 132 bytes
    # the grid fills 132 SMs at the two timed shapes
    assert plan(4096, 16, 64, 4, True, 132)[3] >= 132
    assert plan(65536, 100, 128, 4, True, 132)[3] >= 132
    # j split only for few, long bags, each slice at least MIN_SLICE
    for n_bags, bag, D, split in [(8, 4096, 64, True), (8, 4096, 128, True),
                                  (8, 4, 64, False), (4096, 16, 64, False),
                                  (65536, 100, 128, False),
                                  (262144, 1, 64, False),
                                  (100_000, 4096, 64, False)]:
        _, lanes, splits, blocks = plan(n_bags, bag, D, 4, True, 132)
        assert (splits > 1) == split, (n_bags, bag)
        assert splits <= WARPS and bag // splits >= MIN_SLICE or splits == 1
        groups = -(-n_bags // (32 // lanes))     # warps' worth of bags
        assert blocks == min(-(-groups // (WARPS // splits)),
                             BLOCKS_PER_SM * 132)


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


FLASH_SWEEP = [
    (2, 4, 4, 64, 64, True),      # MHA train
    (2, 8, 2, 100, 100, True),    # GQA, ragged seq
    (3, 8, 2, 1, 256, True),      # decode
    (2, 4, 2, 48, 96, False),     # bidirectional, q != kv
]


@pytest.mark.parametrize("b,h,hk,sq,skv,causal", FLASH_SWEEP)
def test_flash_attention_matches_pallas(b, h, hk, sq, skv, causal):
    q = RNG.standard_normal((b, h, sq, 64)).astype(np.float32)
    k = RNG.standard_normal((b, hk, skv, 64)).astype(np.float32)
    v = RNG.standard_normal((b, hk, skv, 64)).astype(np.float32)
    lens = RNG.integers(max(sq, 1), skv + 1, b).astype(np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens), causal=causal, bq=32, bk=32,
                     interpret=True)
    got = flash_attention_ref(T(q), T(k), T(v), T(lens), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-5)


def test_flash_matches_pallas_and_model_dense_attention():
    """dh 16: the plain version, the Pallas kernel and the port's dense
    attention (the model's oracle path) agree."""
    from repro_torch.models.transformer import _dense_attention
    q = RNG.standard_normal((2, 4, 32, 16)).astype(np.float32)
    k = RNG.standard_normal((2, 2, 32, 16)).astype(np.float32)
    v = RNG.standard_normal((2, 2, 32, 16)).astype(np.float32)
    lens = np.full((2,), 32, np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens), causal=True, bq=16, bk=16,
                     interpret=True)
    got = flash_attention_ref(T(q), T(k), T(v), T(lens), causal=True)
    dense = _dense_attention(T(q), T(k), T(v), T(lens), True)
    for out in (got, dense):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-5)


def test_flash_fully_masked_rows_are_zero():
    """length < sq: the first queries sit before position 0, see no key and
    output 0 in both packages (the ``l == 0`` guard)."""
    q = RNG.standard_normal((1, 2, 8, 16)).astype(np.float32)
    k = RNG.standard_normal((1, 1, 8, 16)).astype(np.float32)
    lens = np.array([3], np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                     jnp.asarray(lens), causal=True, bq=8, bk=8,
                     interpret=True)
    got = flash_attention_ref(T(q), T(k), T(k), T(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-5)
    assert not got[:, :, :5].any() and got[:, :, 5:].abs().sum() > 0


def _flash_inputs(b, h, hk, sq, skv, dh=64, lens=None):
    q = RNG.standard_normal((b, h, sq, dh)).astype(np.float32)
    k = RNG.standard_normal((b, hk, skv, dh)).astype(np.float32)
    v = RNG.standard_normal((b, hk, skv, dh)).astype(np.float32)
    if lens is None:
        lens = RNG.integers(max(sq, 1), skv + 1, b)
    return q, k, v, np.asarray(lens, np.int32)


def _check_split_ref(q, k, v, lens, causal, splits, bq=32, bk=32):
    """The split-and-combine plain version against the Pallas kernel in
    interpret mode and against the unsplit plain version."""
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens), causal=causal, bq=bq, bk=bk,
                     interpret=True)
    got = flash_attention_split_ref(T(q), T(k), T(v), T(lens), causal=causal,
                                    splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(
        got.numpy(),
        flash_attention_ref(T(q), T(k), T(v), T(lens), causal=causal).numpy(),
        rtol=3e-4, atol=3e-5)
    return got


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("b,h,hk,sq,skv,causal", FLASH_SWEEP)
def test_flash_split_ref_matches_pallas(b, h, hk, sq, skv, causal, splits):
    _check_split_ref(*_flash_inputs(b, h, hk, sq, skv), causal, splits)


def test_flash_split_ref_decode_with_splits_past_length():
    """Decode over a 512-position cache in 8 splits of 64 keys: row 0 (length
    70) leaves splits 2-7 wholly past its length (empty partials)."""
    assert split_size(512, 8) == 64
    _check_split_ref(*_flash_inputs(2, 4, 2, 1, 512, lens=[70, 300]), True, 8)


def test_flash_split_ref_rows_before_length_are_zero():
    """length 40 < sq 70: the first 30 queries see no key in any split and
    output exactly 0 (total l = 0)."""
    got = _check_split_ref(*_flash_inputs(1, 4, 2, 70, 150, dh=16,
                                          lens=[40]), True, 3)
    assert not got[:, :, :30].any() and got[:, :, 30:].abs().sum() > 0


def test_flash_split_ref_skv_not_a_multiple_of_the_split():
    """skv 200 in 2 splits of 128 keys: the last split is 72 keys long."""
    assert split_size(200, 2) == 128
    _check_split_ref(*_flash_inputs(2, 6, 2, 3, 200, lens=[200, 131]), True,
                     2)


def test_flash_split_choice_is_a_function_of_shapes():
    """``num_splits`` takes shapes (ints) and no tensor, so the wrapper
    never reads ``lengths`` on the host. It returns 1 once b * hk * row
    tiles reaches TARGET_BLOCKS; below that it gives every KV tile its own
    split or, since splits are whole KV tiles of equal count, at least half
    of TARGET_BLOCKS blocks; and no split is empty by shape."""
    assert num_splits(8, 12, 2, 512, 544) == 1       # Qwen2 prefill, 768
    assert num_splits(66, 12, 2, 1, 4096) == 1       # 66 * 2 * 1 = 132
    assert num_splits(11, 12, 2, 64, 4096) == 1      # 11 * 2 * 12 = 264
    assert num_splits(8, 12, 2, 1, 544) == 9         # Qwen2 decode, 16
    assert split_size(544, 9) == 64
    assert num_splits(2, 12, 2, 1, 4096) == 32       # 4 blocks, 64 tiles
    assert split_size(4096, 32) == 128
    assert num_splits(4, 12, 2, 1, 64) == 1          # a single KV tile
    for b, h, hk, sq, skv in [(1, 12, 2, 77, 300), (3, 12, 2, 77, 200),
                              (4, 12, 2, 1, 1024), (2, 8, 2, 1, 1024),
                              (1, 32, 8, 1, 130), (5, 4, 4, 1, 65)]:
        s = num_splits(b, h, hk, sq, skv)
        n = split_size(skv, s)
        assert (s - 1) * n < skv <= s * n
        tiles = b * hk * -(-(h // hk * sq) // 64)
        assert 2 * tiles * s >= TARGET_BLOCKS or s == -(-skv // 64)


def _bag_cases():
    """The fp32 cases under their first names, then bf16 and fp16 tables,
    each weighted by fp32 and by table-typed weights, and unweighted."""
    shapes = [(8, 4, 64, 16), (16, 8, 500, 32)]
    cases = [pytest.param(weighted, *shape, None, None,
                          id="-".join(map(str, (weighted, *shape))))
             for weighted in (True, False) for shape in shapes]
    for dtype in ("bfloat16", "float16"):
        for weighted, wdtype in ((True, "float32"), (True, dtype),
                                 (False, None)):
            cases += [pytest.param(
                weighted, *shape, dtype, wdtype,
                id="-".join(map(str, (weighted, *shape, dtype, wdtype))))
                for shape in shapes]
    return cases


@pytest.mark.parametrize("weighted,nbags,bag,V,D,dtype,wdtype", _bag_cases())
def test_embedding_bag_matches_pallas(weighted, nbags, bag, V, D, dtype,
                                      wdtype):
    table = RNG.standard_normal((V, D)).astype(np.float32)
    idx = RNG.integers(0, V, (nbags, bag)).astype(np.int32)
    idx[0, 1:] = -1
    w = RNG.random((nbags, bag)).astype(np.float32) if weighted else None
    jt, tt = jnp.asarray(table), T(table)
    jw, tw = (None, None) if w is None else (jnp.asarray(w), T(w))
    if dtype is not None:           # cast in both packages
        jt, tt = jt.astype(dtype), tt.to(getattr(torch, dtype))
    if w is not None and wdtype is not None:
        jw, tw = jw.astype(wdtype), tw.to(getattr(torch, wdtype))
    want = jax_bag(jt, jnp.asarray(idx), jw, interpret=True)
    got = embedding_bag_ref(tt, T(idx), tw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-5)


def _dispatch_cases():
    x = T(RNG.standard_normal((8, 4)).astype(np.float32))
    y = T(RNG.integers(0, 2, 8).astype(np.float32))
    w = T(np.zeros(4, np.float32))
    rp, ci, ei, mem, ep, ca = (T(a) for a in _random_hop_inputs(0))
    fr = torch.zeros(128, dtype=torch.int32)
    fm = torch.zeros(128, dtype=torch.bool)
    fm[:3] = True
    hop = (rp, ci, ei, fr, fm, mem, ep, ca)
    q = T(RNG.standard_normal((2, 4, 3, 8)).astype(np.float32))
    kv = T(RNG.standard_normal((2, 2, 5, 8)).astype(np.float32))
    lens = torch.tensor([5, 4], dtype=torch.int32)
    idx = torch.tensor([[0, 3, -1], [7, 7, 1]], dtype=torch.int32)
    wb = T(RNG.random((2, 3)).astype(np.float32))
    return [
        ("matmul", lambda **k: matmul(x, x.T, **k), lambda: matmul_ref(x, x.T)),
        ("cosine_sim", lambda **k: cosine_sim(x, x, **k),
         lambda: cosine_sim_ref(x, x)),
        ("logreg_grad", lambda **k: logreg_grad(x, y, w, **k),
         lambda: logreg_grad_ref(x, y, w)),
        ("batched_hop",
         lambda **k: tops.fused_hop(*hop, capacity=128, chunk=8, **k),
         lambda: tref.fused_hop_ref(*hop, capacity=128, chunk=8)),
        ("flash_attention",
         lambda **k: flash_attention(q, kv, kv, lens, **k),
         lambda: flash_attention_ref(q, kv, kv, lens)),
        ("embedding_bag", lambda **k: embedding_bag(x, idx, wb, **k),
         lambda: embedding_bag_ref(x, idx, wb)),
        ("matgen", lambda **k: matgen(idx[0], idx[1], 4, **k),
         lambda: matgen_ref(idx[0], idx[1], 4)),
    ]


@pytest.mark.parametrize("case", range(7))
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


@pytest.mark.parametrize("case", range(7))
def test_use_kernel_true_on_cpu_tensor_raises(case):
    name, call, _ = _dispatch_cases()[case]
    with pytest.raises(ValueError, match="CUDA"):
        call(use_kernel=True)


_RANK_IDS = {
    "dense": np.random.default_rng(1).integers(-20, 100, 300),
    "dense_unsigned": np.random.default_rng(3).integers(0, 250, 300),
    "sparse": np.random.default_rng(2).integers(0, 50, 300) * 1_000_003,
    "one_id": np.full(7, 42),
    "empty": np.zeros(0, dtype=np.int64),
    "int8_full_range": np.tile(np.arange(-128, 128), 2)[::-3],
    "int64_ends": np.array([-2**63, 2**63 - 1, -2**63]),
    "int64_top": np.array([2**63 - 1, 2**63 - 3, 2**63 - 1] * 3),
    "uint64_top": np.array([2**64 - 1, 2**64 - 5, 2**64 - 1] * 3,
                           dtype=np.uint64),
}
# each set of ids in every integer type that holds it
_RANK_CASES = [(ids, dt) for ids, rows in sorted(_RANK_IDS.items())
               for dt in ("int8", "int32", "int64", "uint8", "uint32",
                          "uint64")
               if not rows.size or (np.iinfo(dt).min <= rows.min()
                                    and rows.max() <= np.iinfo(dt).max)]


@pytest.mark.parametrize("ids,dtype", _RANK_CASES)
def test_matgen_rank_matches_np_unique(ids, dtype):
    """The host's ranking of group ids, by counting where they span few
    slots a pair and by sorting otherwise, gives what ``np.unique`` (the
    reference's ranking) gives: ids, dtype and each pair's index."""
    rows = _RANK_IDS[ids].astype(dtype)
    want_ids, want_idx = np.unique(rows, return_inverse=True)
    got_ids, got_idx = rank(rows)
    assert got_ids.dtype == want_ids.dtype
    assert got_idx.dtype == want_idx.dtype
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_idx, want_idx)


def _jax_table(t):
    """The JAX package's Table of the port's Table ``t``: the same arrays."""
    return jax_storage.Table(t.name, {
        name: (jax_storage.RaggedColumn(values=c.values, offsets=c.offsets)
               if isinstance(c, RaggedColumn) else c)
        for name, c in t.columns.items()})


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS + (G1_SF40,))
def test_matgen_plain_and_dispatch_match_numpy(kind, layout, mode, d):
    """The port's numpy path, the plain version and the CPU dispatch give
    the JAX package's matrix bit for bit and its group ids (values and
    dtype), and launch nothing."""
    t = case_table(kind, layout)
    ref_mat, want_groups = jax_analytics.random_access_matrix(
        _jax_table(t), "g", "v", d, mode)
    want = torch.from_numpy(np.array(ref_mat))
    rows, vals = (T(a) for a in analytics.random_access_pairs(t, "g", "v"))
    before = launch_counts()["matgen"]
    got = matgen(rows, vals, d, mode)
    host, host_groups = analytics.random_access_matrix(t, "g", "v", d, mode,
                                                       device="cpu")
    for mat, groups in ((host, T(host_groups)),
                        matgen_ref(rows, vals, d, mode), got):
        assert mat.dtype == torch.float32 and mat.shape == want.shape
        assert torch.equal(mat.view(torch.int32), want.view(torch.int32))
        assert groups.numpy().dtype == want_groups.dtype
        np.testing.assert_array_equal(groups.numpy(), want_groups)
    assert launch_counts()["matgen"] == before
