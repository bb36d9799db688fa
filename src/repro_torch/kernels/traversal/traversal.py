"""Wrapper of the fused traversal-hop CUDA kernels (``csrc/traversal.cu``)
— the device-resident GCDI hot path.

One call advances B padded frontiers one hop. The prelude (degrees, their
exclusive prefix sum, the candidate total and the overflow flag) and the
exclusive scan of the per-block survivor counts between the two kernels
are O(C) and O(capacity / 256) tensor ops; the kernels do the
O(capacity) candidate work (see the source for the design)."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # hops launched through this wrapper

_I32 = torch.int32


def _check(row_ptr, col_idx, edge_id, frontiers, fmasks, member, edge_pred,
           chunk_alive):
    _lib.require_cuda("batched_hop", row_ptr, col_idx, edge_id, frontiers,
                      fmasks, member, edge_pred, chunk_alive)
    for name, t, dtype in (("row_ptr", row_ptr, _I32),
                           ("col_idx", col_idx, _I32),
                           ("edge_id", edge_id, _I32),
                           ("frontiers", frontiers, _I32),
                           ("fmasks", fmasks, torch.bool),
                           ("member", member, torch.bool),
                           ("edge_pred", edge_pred, torch.bool),
                           ("chunk_alive", chunk_alive, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"batched_hop: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"batched_hop: {name} must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"batched_hop: {name} is empty")
    if frontiers.dim() != 2 or fmasks.shape != frontiers.shape:
        raise ValueError(f"batched_hop: frontiers {tuple(frontiers.shape)} "
                         f"and fmasks {tuple(fmasks.shape)} must be (B, C)")
    if edge_id.shape != col_idx.shape:
        raise ValueError("batched_hop: col_idx and edge_id differ in length")


def batched_hop(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                edge_id: torch.Tensor, frontiers: torch.Tensor,
                fmasks: torch.Tensor, member: torch.Tensor,
                edge_pred: torch.Tensor, chunk_alive: torch.Tensor, *,
                capacity: int, chunk: int):
    """B queries, one hop on the card. Same contract as
    ``ref.batched_hop_ref``: (src_slot, dst, eid) as (B, capacity) int32,
    count (B,) int32, overflowed (B,) bool."""
    global launches
    _check(row_ptr, col_idx, edge_id, frontiers, fmasks, member, edge_pred,
           chunk_alive)
    if capacity <= 0 or chunk <= 0:
        raise ValueError(f"batched_hop: capacity {capacity}, chunk {chunk}")
    B, C = frontiers.shape
    dev = frontiers.device
    fr = frontiers.long()
    deg = torch.where(fmasks, row_ptr[fr + 1] - row_ptr[fr], 0)
    out_off = (torch.cumsum(deg, 1, dtype=_I32) - deg).contiguous()
    total = torch.sum(deg, 1, dtype=_I32)
    overflowed = total > capacity

    nblk = _lib.query("gredo_hop_blocks", capacity)
    block_counts = torch.empty((B, nblk), dtype=_I32, device=dev)
    tables = (out_off.data_ptr(), frontiers.data_ptr(), total.data_ptr(),
              row_ptr.data_ptr(), col_idx.data_ptr(), edge_id.data_ptr(),
              member.data_ptr(), edge_pred.data_ptr(),
              chunk_alive.data_ptr())
    sizes = (B, C, capacity, chunk, row_ptr.numel(), col_idx.numel(),
             member.numel(), edge_pred.numel(), chunk_alive.numel())
    src = torch.empty((B, capacity), dtype=_I32, device=dev)
    dst = torch.empty_like(src)
    eid = torch.empty_like(src)
    with torch.cuda.device(dev):
        stream = _lib.stream_of(frontiers)
        _lib.launch("gredo_hop_count", *tables, block_counts.data_ptr(),
                    *sizes, stream)
        block_off = (torch.cumsum(block_counts, 1, dtype=_I32)
                     - block_counts).contiguous()
        count = torch.sum(block_counts, 1, dtype=_I32)
        _lib.launch("gredo_hop_scatter", *tables, block_off.data_ptr(),
                    count.data_ptr(), src.data_ptr(), dst.data_ptr(),
                    eid.data_ptr(), *sizes, stream)
    launches += 1
    return src, dst, eid, count, overflowed


def fused_hop(row_ptr, col_idx, edge_id, frontier, fmask, member, edge_pred,
              chunk_alive, *, capacity: int, chunk: int):
    """Single-query hop (the B=1 row of the batched kernel); same contract
    as ``ref.fused_hop_ref``."""
    src, dst, eid, cnt, ovf = batched_hop(
        row_ptr, col_idx, edge_id, frontier[None, :], fmask[None, :],
        member, edge_pred, chunk_alive, capacity=capacity, chunk=chunk)
    return src[0], dst[0], eid[0], cnt[0], ovf[0]
