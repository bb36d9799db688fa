"""Plain PyTorch version of the fused traversal hop (DeviceMatchPattern).

One "fused hop" is the unit the CUDA kernel implements: CSR row-gather +
neighbour expansion + pushed-predicate evaluation + compaction, over a
padded fixed-capacity frontier. The plain version keeps the exact output
contract the kernel must hit, so the equivalence tests compare arrays, not
row sets:

  * candidates are laid out in slot order — frontier-slot-major, CSR
    position within a row (the same order the host matcher produces);
  * survivors are compacted to the front, preserving slot order;
  * padding is ``src=0, dst=-1, eid=-1`` beyond ``count``;
  * ``overflowed`` is true when the *pre-predicate* candidate total exceeds
    the capacity (the caller doubles and retries — survivors of a truncated
    expansion are never silently returned as complete).

``chunk_alive`` is the zone-map chunk survivor table over the edge-tid
space: a candidate whose edge lands in a predicate-dead chunk is dropped
without consulting ``edge_pred``. Every gather index is clamped explicitly
(PyTorch, unlike the JAX reference, raises on an out-of-range gather).
"""
from __future__ import annotations

import torch

_I32 = torch.int32


def batched_hop_ref(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    edge_id: torch.Tensor, frontiers: torch.Tensor,
                    fmasks: torch.Tensor, member: torch.Tensor,
                    edge_pred: torch.Tensor, chunk_alive: torch.Tensor, *,
                    capacity: int, chunk: int):
    """B independent queries share the CSR and predicate tables and advance
    one hop. frontiers/fmasks: (B, C) padded nids + validity; member: (n,)
    bool over nids; edge_pred: (m,) bool over edge tids; chunk_alive:
    (ceil(m/chunk),) bool. Returns (src_slot, dst, eid) as (B, capacity)
    int32 with the first ``count[q]`` slots of row q holding the compacted
    survivors, count (B,) int32 and overflowed (B,) bool. ``src_slot``
    indexes the INPUT frontier so callers re-join path prefixes."""
    B, C = frontiers.shape
    fr = frontiers.to(torch.int64)
    deg = torch.where(fmasks, (row_ptr[fr + 1] - row_ptr[fr]).to(_I32), 0)
    out_off = torch.cumsum(deg, 1, dtype=_I32) - deg    # exclusive prefix sum
    total = torch.sum(deg, 1, dtype=_I32)
    overflowed = total > capacity

    slots = torch.arange(capacity, dtype=_I32, device=fr.device)
    slots = slots.expand(B, capacity).contiguous()
    src_slot = torch.clamp(
        torch.searchsorted(out_off, slots, right=True) - 1, 0, C - 1)
    within = slots - torch.gather(out_off, 1, src_slot)
    pos = torch.clamp(row_ptr[torch.gather(fr, 1, src_slot)] + within,
                      0, col_idx.shape[0] - 1).long()
    dst = col_idx[pos].to(_I32)
    eid = edge_id[pos].to(_I32)

    ok = slots < torch.clamp(total, max=capacity)[:, None]
    ok &= member[torch.clamp(dst, 0, member.shape[0] - 1).long()]
    ok &= chunk_alive[torch.clamp(torch.div(eid, chunk, rounding_mode="floor"),
                                  0, chunk_alive.shape[0] - 1).long()]
    ok &= edge_pred[torch.clamp(eid, 0, edge_pred.shape[0] - 1).long()]

    # stable compaction in slot order: survivors sort before dead slots and
    # keep their relative order (keys are unique, so no stable-sort caveat)
    count = torch.sum(ok, 1, dtype=_I32)
    order = torch.argsort(torch.where(ok, slots, capacity + slots), dim=1)
    live = slots < count[:, None]
    src_c = torch.where(live, torch.gather(src_slot, 1, order).to(_I32), 0)
    dst_c = torch.where(live, torch.gather(dst, 1, order), -1)
    eid_c = torch.where(live, torch.gather(eid, 1, order), -1)
    return src_c, dst_c, eid_c, count, overflowed


def fused_hop_ref(row_ptr, col_idx, edge_id, frontier, fmask, member,
                  edge_pred, chunk_alive, *, capacity: int, chunk: int):
    """One query's hop (the B=1 row of ``batched_hop_ref``): frontier/fmask
    are (C,); returns (src_slot, dst, eid) as (capacity,), count () and
    overflowed ()."""
    src, dst, eid, cnt, ovf = batched_hop_ref(
        row_ptr, col_idx, edge_id, frontier[None, :], fmask[None, :],
        member, edge_pred, chunk_alive, capacity=capacity, chunk=chunk)
    return src[0], dst[0], eid[0], cnt[0], ovf[0]
