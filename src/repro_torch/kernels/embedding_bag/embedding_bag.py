"""Wrapper of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``).

A call is one ``ctypes`` call and one launch. The launch (load width,
lanes per bag, j split, grid) comes from the shape, the table's element
size and its alignment (:func:`plan`, cached)."""
from __future__ import annotations

import functools

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper

# Table and weight types; the index is the C type code (csrc/embedding_bag.cu)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
WARPS = 8             # warps per block
# One block per group of bags (the block scheduler balances bags of uneven
# latency: one persistent wave of 4 blocks per SM measured slower on the
# H100), up to this many per SM; past it the blocks walk the rest in the
# kernel's grid-stride loop.
BLOCKS_PER_SM = 64
# A bag is split over warps only when the bags' warps fill less than this
# many warps per SM, and only down to this many slots per warp.
SPLIT_WARPS_PER_SM = 16
MIN_SLICE = 64


def plan(n_bags: int, bag: int, D: int, elt_bytes: int, aligned: bool,
         sms: int) -> tuple[int, int, int, int]:
    """(vec, lanes, splits, blocks) for ``n_bags`` bags of ``bag`` slots
    over a D-wide table of ``elt_bytes``-byte elements on a card with
    ``sms`` SMs: 16-byte loads (``vec`` values) where rows and the table
    (``aligned``) allow them, else one value a load (``vec`` 1: a lane
    sums 4 columns, ``lanes`` apart); a power of two of lanes per bag
    covering D / (``vec`` or 4), at most a warp (narrow rows share a
    warp); j split over up to ``WARPS`` warps where few long bags would
    leave the card idle; a block per ``WARPS // splits`` warps' worth of
    bags, at most ``BLOCKS_PER_SM`` per SM (a grid-stride loop in the
    kernel walks the rest)."""
    vec = 16 // elt_bytes if aligned and D * elt_bytes % 16 == 0 else 1
    cols = vec if vec > 1 else 4           # columns a lane sums
    lanes = 1
    while lanes < 32 and lanes * cols < D:
        lanes *= 2
    groups = -(-n_bags // (32 // lanes))       # warps' worth of bags
    splits = 1
    while (splits < WARPS and groups * splits < SPLIT_WARPS_PER_SM * sms
           and bag >= 2 * splits * MIN_SLICE):
        splits *= 2
    blocks = min(-(-groups // (WARPS // splits)), BLOCKS_PER_SM * sms)
    return vec, lanes, splits, max(blocks, 1)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(n_bags: int, bag: int, D: int, elt_bytes: int, aligned: bool,
          index: int) -> tuple[int, int, int, int]:
    return plan(n_bags, bag, D, elt_bytes, aligned, _sms(index))


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = sum_j weights[i, j] * table[indices[i, j]] in float32.
    table: (V, D) float32, bfloat16 or float16; indices: (n_bags, bag)
    int32, -1 = padding (weight 0); weights: (n_bags, bag) float32 or of
    the table's dtype, or None (1 for every valid slot). All contiguous, on
    one card. The same bits on every call. Indices are not checked against
    V (that needs a device-to-host copy): one >= V is the caller's error,
    and the kernel reads row V - 1 for it."""
    global launches
    extra = () if weights is None else (weights,)
    _lib.require_cuda("embedding_bag", table, indices, *extra)
    if table.dtype not in DTYPES or indices.dtype != torch.int32 or (
            weights is not None
            and weights.dtype not in (torch.float32, table.dtype)):
        raise TypeError(f"embedding_bag: a float32, bfloat16 or float16 "
                        f"table, int32 indices and float32 or table-typed "
                        f"weights, got {table.dtype}, {indices.dtype}, "
                        f"{None if weights is None else weights.dtype}")
    if table.dim() != 2 or indices.dim() != 2 or table.shape[0] == 0 or \
            (weights is not None and weights.shape != indices.shape):
        raise ValueError(f"embedding_bag: shapes table {tuple(table.shape)}, "
                         f"indices {tuple(indices.shape)}, weights "
                         f"{None if weights is None else tuple(weights.shape)}")
    if not (table.is_contiguous() and indices.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("embedding_bag: table, indices and weights must be "
                         "contiguous")
    n_bags, bag = indices.shape
    V, D = table.shape
    dev = table.device
    out = torch.empty((n_bags, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    ptr = table.data_ptr()
    vec, lanes, splits, blocks = _plan(n_bags, bag, D, table.element_size(),
                                       ptr % 16 == 0, dev.index)
    with _lib.on_device(dev):
        _lib.launch("gredo_embedding_bag", ptr, indices.data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    out.data_ptr(), n_bags, bag, V, D,
                    DTYPES.index(table.dtype),
                    0 if weights is None else DTYPES.index(weights.dtype),
                    vec, lanes, splits, blocks, _lib.stream_of(table))
    launches += 1
    return out
