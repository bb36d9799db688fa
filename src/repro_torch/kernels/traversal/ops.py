"""Dispatch + whole-chain runners for the fused traversal kernels.

``fused_hop``/``batched_hop`` follow the family convention: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors,
``use_kernel`` to force either (``True`` on CPU tensors raises).

``traverse_chain``/``batched_traverse`` run a whole chain pattern as one
launch window — every hop's expansion, predicate evaluation, compaction and
path re-join stays on the device, and the host synchronizes once at the end
(the overflow flag and the final count are read together). That is the
latency contrast with the per-hop ``DevicePatternMatcher``, which syncs
every hop.

COUNTERS feed the telemetry registry through
``core.pattern_jit.metrics`` (cumulative — per-query deltas come from
registry snapshots).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ref
from . import traversal as kern

_I32 = torch.int32


@dataclasses.dataclass
class _Counters:
    launches: int = 0           # chain launches (one per traverse_chain call)
    hops: int = 0               # fused hops executed
    batched_queries: int = 0    # queries carried by batched launches
    chunks_alive: int = 0       # zone-map chunks surviving the prefetch filter
    chunks_total: int = 0       # zone-map chunks examined

    def metrics(self) -> dict:
        return {"launches": self.launches, "hops": self.hops,
                "batched_queries": self.batched_queries,
                "chunks_alive": self.chunks_alive,
                "chunks_total": self.chunks_total}

    def reset(self) -> None:
        self.launches = self.hops = self.batched_queries = 0
        self.chunks_alive = self.chunks_total = 0


COUNTERS = _Counters()


def fused_hop(row_ptr, col_idx, edge_id, frontier, fmask, member, edge_pred,
              chunk_alive, *, capacity: int, chunk: int,
              use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = frontier.is_cuda
    hop = kern.fused_hop if use_kernel else ref.fused_hop_ref
    return hop(row_ptr, col_idx, edge_id, frontier, fmask, member, edge_pred,
               chunk_alive, capacity=capacity, chunk=chunk)


def batched_hop(row_ptr, col_idx, edge_id, frontiers, fmasks, member,
                edge_pred, chunk_alive, *, capacity: int, chunk: int,
                use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = frontiers.is_cuda
    hop = kern.batched_hop if use_kernel else ref.batched_hop_ref
    return hop(row_ptr, col_idx, edge_id, frontiers, fmasks, member,
               edge_pred, chunk_alive, capacity=capacity, chunk=chunk)


# ---------------------------------------------------------------------------
# Whole-chain runners (single launch window, one end-of-chain host sync)
# ---------------------------------------------------------------------------


def _chain_device(row_ptr, col_idx, edge_id, frontier, fmask, members,
                  edge_preds, chunk_alives, *, capacity: int, chunk: int,
                  use_kernel: bool):
    hop = kern.fused_hop if use_kernel else ref.fused_hop_ref
    slots = torch.arange(capacity, dtype=_I32, device=frontier.device)
    vcols = [frontier]
    ecols: list = []
    count = torch.sum(fmask, dtype=_I32)
    ovf = torch.zeros((), dtype=torch.bool, device=frontier.device)
    for vm, ep, ca in zip(members, edge_preds, chunk_alives):
        src, dst, eid, count, o = hop(row_ptr, col_idx, edge_id, frontier,
                                      fmask, vm, ep, ca, capacity=capacity,
                                      chunk=chunk)
        # re-join path prefixes through the compacted src slots
        src = src.long()
        vcols = [c.index_select(0, src) for c in vcols]
        ecols = [c.index_select(0, src) for c in ecols]
        vcols.append(dst)
        ecols.append(eid)
        frontier = torch.clamp_min(dst, 0)
        fmask = slots < count
        ovf = ovf | o
    return vcols, ecols, count, ovf


def _batched_chain_device(row_ptr, col_idx, edge_id, frontiers, fmasks,
                          members, edge_preds, chunk_alives, *, capacity: int,
                          chunk: int, use_kernel: bool):
    hop = kern.batched_hop if use_kernel else ref.batched_hop_ref
    slots = torch.arange(capacity, dtype=_I32, device=frontiers.device)
    vcols = [frontiers]
    ecols: list = []
    counts = torch.sum(fmasks, 1, dtype=_I32)
    ovf = torch.zeros((frontiers.shape[0],), dtype=torch.bool,
                      device=frontiers.device)
    for vm, ep, ca in zip(members, edge_preds, chunk_alives):
        src, dst, eid, counts, o = hop(row_ptr, col_idx, edge_id, frontiers,
                                       fmasks, vm, ep, ca, capacity=capacity,
                                       chunk=chunk)
        src = src.long()
        vcols = [torch.take_along_dim(c, src, dim=1) for c in vcols]
        ecols = [torch.take_along_dim(c, src, dim=1) for c in ecols]
        vcols.append(dst)
        ecols.append(eid)
        frontiers = torch.clamp_min(dst, 0)
        fmasks = slots[None, :] < counts[:, None]
        ovf = ovf | o
    return vcols, ecols, counts, ovf


def _device_tables(n_vertices, n_edges, chunk, members, edge_preds,
                   chunk_alives, device):
    """Normalize optional host tables to device tensors (None = all-true)."""
    m = max(int(n_edges), 1)
    nch = max(-(-m // chunk), 1)
    ones_v = torch.ones((max(int(n_vertices), 1),), dtype=torch.bool,
                        device=device)
    ones_e = torch.ones((m,), dtype=torch.bool, device=device)
    ones_c = torch.ones((nch,), dtype=torch.bool, device=device)

    def table(v, ones):
        return ones if v is None else torch.as_tensor(np.asarray(v, bool),
                                                      device=device)
    mem = tuple(table(v, ones_v) for v in members)
    epr = tuple(table(e, ones_e) for e in edge_preds)
    cal = tuple(table(c, ones_c) for c in chunk_alives)
    return mem, epr, cal


def _padded_csr(row_ptr, col_idx, edge_id, n_edges):
    """The CSR as int32 tensors (a no-op for the matcher's int32 device
    snapshot)."""
    rp = torch.as_tensor(row_ptr).to(_I32)
    if n_edges:
        return (rp, torch.as_tensor(col_idx).to(_I32),
                torch.as_tensor(edge_id).to(_I32))
    # degenerate graph: 1-entry dummies keep every gather in range (deg is
    # all zero, so no candidate is ever valid)
    dummy = torch.zeros((1,), dtype=_I32, device=rp.device)
    return rp, dummy, dummy


def _to_host(cols: list, k: int | None = None) -> list:
    """Device columns -> host numpy arrays in one transfer (trimmed to the
    first ``k`` entries when given)."""
    if not cols:
        return []
    stacked = torch.stack(cols)
    if k is not None:
        stacked = stacked[..., :k]
    return list(stacked.cpu().numpy())


def traverse_chain(row_ptr, col_idx, edge_id, n_vertices: int, n_edges: int,
                   start_nids, members, edge_preds, chunk_alives, *,
                   capacity: int, chunk: int, use_kernel: bool | None = None):
    """Run a whole chain in one launch window on ``row_ptr``'s device.
    ``members[h]`` / ``edge_preds[h]`` / ``chunk_alives[h]`` are per-hop
    tables (None = unconstrained). Returns (vcols, ecols, ok): trimmed int32
    numpy arrays of the matched path columns (hop order), or ``ok=False``
    on capacity overflow (caller doubles and retries)."""
    rp, ci, ei = _padded_csr(row_ptr, col_idx, edge_id, n_edges)
    dev = rp.device
    if use_kernel is None:
        use_kernel = rp.is_cuda
    mem, epr, cal = _device_tables(n_vertices, n_edges, chunk, members,
                                   edge_preds, chunk_alives, dev)
    C0 = len(start_nids)
    if capacity < C0 or capacity % 128:
        raise ValueError(f"capacity {capacity} must be a multiple of 128 "
                         f">= the start frontier ({C0})")
    frontier = torch.zeros((capacity,), dtype=_I32, device=dev)
    frontier[:C0] = torch.as_tensor(np.asarray(start_nids), dtype=_I32,
                                    device=dev)
    fmask = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    fmask[:C0] = True
    vcols, ecols, count, ovf = _chain_device(
        rp, ci, ei, frontier, fmask, mem, epr, cal, capacity=capacity,
        chunk=chunk, use_kernel=bool(use_kernel))
    COUNTERS.launches += 1
    COUNTERS.hops += len(mem)
    # the chain's one host sync: overflow flag and count read together
    ovf_h, k = torch.stack([ovf.to(_I32), count]).tolist()
    if ovf_h:
        return None, None, False
    n_v = len(vcols)
    cols = _to_host(vcols + ecols, k)
    return cols[:n_v], cols[n_v:], True


def batched_traverse(row_ptr, col_idx, edge_id, n_vertices: int,
                     n_edges: int, start_nids, members, edge_preds,
                     chunk_alives, *, capacity: int, chunk: int,
                     use_kernel: bool | None = None):
    """Point-lookup batching: ``start_nids`` is (B,) — one start vertex per
    query; all B queries advance through the chain in single launches.
    Returns (vcols, ecols, counts, ok): per-query path columns as
    (B, capacity) numpy arrays valid up to ``counts[q]``, or ``ok=False``
    if any query overflowed."""
    rp, ci, ei = _padded_csr(row_ptr, col_idx, edge_id, n_edges)
    dev = rp.device
    if use_kernel is None:
        use_kernel = rp.is_cuda
    mem, epr, cal = _device_tables(n_vertices, n_edges, chunk, members,
                                   edge_preds, chunk_alives, dev)
    start = torch.as_tensor(np.asarray(start_nids), dtype=_I32, device=dev)
    B = start.shape[0]
    if capacity % 128:
        raise ValueError(f"capacity {capacity} must be a multiple of 128")
    frontiers = torch.zeros((B, capacity), dtype=_I32, device=dev)
    frontiers[:, 0] = start
    fmasks = torch.zeros((B, capacity), dtype=torch.bool, device=dev)
    fmasks[:, 0] = True
    vcols, ecols, counts, ovf = _batched_chain_device(
        rp, ci, ei, frontiers, fmasks, mem, epr, cal, capacity=capacity,
        chunk=chunk, use_kernel=bool(use_kernel))
    COUNTERS.launches += 1
    COUNTERS.hops += len(mem)
    COUNTERS.batched_queries += int(B)
    # the batch's one host sync: overflow flags and counts read together
    flags = torch.cat([torch.any(ovf).to(_I32).view(1), counts]).cpu()
    if int(flags[0]):
        return None, None, None, False
    n_v = len(vcols)
    cols = _to_host(vcols + ecols)
    return cols[:n_v], cols[n_v:], flags[1:].numpy(), True
