"""Wrapper of the fused traversal-hop CUDA kernels (``csrc/traversal.cu``)
— the device-resident GCDI hot path.

One call advances B padded frontiers one hop with one ``ctypes`` call that
launches two kernels (the degree scan and the expand/compact pass; see the
source for the design) and no torch op besides allocating the outputs. The
look-back status words, the tile counters, the totals and ``out_off`` live
in a workspace cached per (device, stream) (``_lib.workspace``), grown when
a larger shape arrives. The kernels leave the status words and counters at
0 for the next call, so nothing is cleared on the host and a call can be
captured in a CUDA graph and replayed."""
from __future__ import annotations

import functools

import torch

from .. import _lib

launches = 0          # hops launched through this wrapper


@functools.lru_cache(maxsize=256)
def _specs(B: int, C: int, capacity: int) -> tuple:
    """The workspace of a (B, C, capacity) hop (``gredo_hop_workspace``'s
    parts): the scan's and the expand kernel's look-back words, each zeroed
    once, and the int32 data."""
    return tuple((_lib.query("gredo_hop_workspace", part, B, C, capacity),
                  dtype, part < 2)
                 for part, dtype in enumerate((torch.int64, torch.int64,
                                               torch.int32)))


_I32 = torch.int32


_DTYPES = (_I32, _I32, _I32, _I32, torch.bool, torch.bool, torch.bool,
           torch.bool)
_NAMES = ("row_ptr", "col_idx", "edge_id", "frontiers", "fmasks", "member",
          "edge_pred", "chunk_alive")


def _check(capacity, chunk, dims, *tensors):
    """The wrapper's input checks; ``tensors`` in ``_NAMES`` order."""
    _lib.require_cuda("batched_hop", *tensors)
    if tuple(t.dtype for t in tensors) != _DTYPES:
        name, t, dtype = next((n, t, d) for n, t, d in
                              zip(_NAMES, tensors, _DTYPES) if t.dtype != d)
        raise TypeError(f"batched_hop: {name} must be {dtype}, got {t.dtype}")
    for name, t in zip(_NAMES, tensors):
        if not t.is_contiguous():
            raise ValueError(f"batched_hop: {name} must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"batched_hop: {name} is empty")
    row_ptr, col_idx, edge_id, frontiers, fmasks = tensors[:5]
    if frontiers.dim() != dims or fmasks.shape != frontiers.shape:
        raise ValueError(f"batched_hop: frontiers {tuple(frontiers.shape)} "
                         f"and fmasks {tuple(fmasks.shape)} must be "
                         f"{'(B, C)' if dims == 2 else '(C,)'}")
    if edge_id.shape != col_idx.shape:
        raise ValueError("batched_hop: col_idx and edge_id differ in length")
    if capacity <= 0 or chunk <= 0:
        raise ValueError(f"batched_hop: capacity {capacity}, chunk {chunk}")


def _hop(row_ptr, col_idx, edge_id, frontiers, fmasks, member, edge_pred,
         chunk_alive, capacity, chunk, B, C, rows):
    """One launch window of ``gredo_hop``; outputs of shape ``rows +
    (capacity,)`` and ``rows`` (``(B,)`` batched, ``()`` for one query)."""
    global launches
    dev = frontiers.device
    # one allocation for the three slot outputs (each its own view)
    src, dst, eid = torch.empty((3,) + rows + (capacity,), dtype=_I32,
                                device=dev).unbind(0)
    count = torch.empty(rows, dtype=_I32, device=dev)
    overflowed = torch.empty(rows, dtype=torch.bool, device=dev)
    with _lib.on_device(dev):
        stream = _lib.stream_of(frontiers)
        scan_words, expand_words, data = _lib.workspace(
            "batched_hop", dev, stream, _specs(B, C, capacity))
        _lib.launch("gredo_hop", row_ptr.data_ptr(), col_idx.data_ptr(),
                    edge_id.data_ptr(), frontiers.data_ptr(),
                    fmasks.data_ptr(), member.data_ptr(),
                    edge_pred.data_ptr(), chunk_alive.data_ptr(),
                    scan_words.data_ptr(), expand_words.data_ptr(),
                    data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                    eid.data_ptr(), count.data_ptr(), overflowed.data_ptr(),
                    B, C, capacity, chunk, row_ptr.numel(), col_idx.numel(),
                    member.numel(), edge_pred.numel(), chunk_alive.numel(),
                    stream)
    launches += 1
    return src, dst, eid, count, overflowed


def batched_hop(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                edge_id: torch.Tensor, frontiers: torch.Tensor,
                fmasks: torch.Tensor, member: torch.Tensor,
                edge_pred: torch.Tensor, chunk_alive: torch.Tensor, *,
                capacity: int, chunk: int):
    """B queries, one hop on the card. Same contract as
    ``ref.batched_hop_ref``: (src_slot, dst, eid) as (B, capacity) int32,
    count (B,) int32, overflowed (B,) bool."""
    _check(capacity, chunk, 2, row_ptr, col_idx, edge_id, frontiers, fmasks,
           member, edge_pred, chunk_alive)
    B, C = frontiers.shape
    return _hop(row_ptr, col_idx, edge_id, frontiers, fmasks, member,
                edge_pred, chunk_alive, capacity, chunk, B, C, (B,))


def fused_hop(row_ptr, col_idx, edge_id, frontier, fmask, member, edge_pred,
              chunk_alive, *, capacity: int, chunk: int):
    """Single-query hop (the B=1 case of the batched kernel, without the
    views of a batch axis); same contract as ``ref.fused_hop_ref``."""
    _check(capacity, chunk, 1, row_ptr, col_idx, edge_id, frontier, fmask,
           member, edge_pred, chunk_alive)
    return _hop(row_ptr, col_idx, edge_id, frontier, fmask, member,
                edge_pred, chunk_alive, capacity, chunk, 1, frontier.shape[0],
                ())
