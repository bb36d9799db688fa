"""Device-resident pattern matching: fixed-capacity padded frontiers with
overflow-detect-and-retry (the DESIGN §2 static-shape adaptation — the
device analogue of buffer-pool spill).

The host engine (core.pattern) is the system of record; this module is the
accelerator glue. Two device flavors share the predicate-lowering code (the
access labels ``device-jit`` / ``device-pallas`` are the JAX package's plan
labels, kept so plans and explain output match it):

  * ``DevicePatternMatcher`` — the per-hop path: one ``expand_frontier``
    (plain tensor ops) per hop with a host overflow sync between hops,
    dense predicate tables built by full column scans.
  * ``device_match(flavor="pallas")`` — the fused path
    (:mod:`repro_torch.kernels.traversal`): the whole chain is one launch
    window (the CUDA hop kernel per hop on the card, its plain PyTorch
    version on the CPU), predicate tables are built through zone-map
    skip-scans (predicate-dead chunks are never read) and the chunk-survivor
    bitmap rides into the kernel as a filter; the host syncs once at the
    end of the chain.

Both flavors are epoch-stamped against the graph: a snapshot taken before a
write burst refuses to serve (pending deltas) or re-syncs (compacted) before
the next match — mirroring the ``IndexManager`` refresh discipline.

The planner's cardinality estimates choose the initial capacity; on overflow
the wrapper doubles and re-runs (amortized O(1) recompiles thanks to
power-of-two capacities). The CSR snapshot is cast to int32 once, as
the JAX package's device arrays are. ``COUNTERS``/``metrics()`` surface recompiles,
per-capacity retries and kernel launch counts to the telemetry registry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.traversal import ops as kernel_ops

from . import pattern as pattern_mod
from .storage import Graph, Table


class StaleSnapshotError(ValueError):
    """The device CSR snapshot no longer matches the graph and cannot be
    refreshed (pending deltas — compact first)."""


@dataclasses.dataclass
class _Counters:
    matches: int = 0            # device_match invocations
    recompiles: int = 0         # jit-path capacity doublings
    retries: int = 0            # fused-path capacity doublings
    refreshes: int = 0          # snapshot re-syncs after epoch bumps
    stale_rejects: int = 0      # refused matches on pending deltas
    retry_caps: dict = dataclasses.field(default_factory=dict)

    def bump_retry(self, cap: int) -> None:
        self.retry_caps[cap] = self.retry_caps.get(cap, 0) + 1

    def metrics(self) -> dict:
        out = {"matches": self.matches, "recompiles": self.recompiles,
               "retries": self.retries, "refreshes": self.refreshes,
               "stale_rejects": self.stale_rejects}
        for cap, k in sorted(self.retry_caps.items()):
            out[f"retries.cap_{cap}"] = k
        return out


COUNTERS = _Counters()


def metrics() -> dict:
    """Telemetry registry source: matcher counters + fused-kernel launch
    counters, one flat namespace (cumulative; the engine's per-query view
    comes from registry snapshot deltas)."""
    out = COUNTERS.metrics()
    for k, v in kernel_ops.COUNTERS.metrics().items():
        out[f"kernel.{k}"] = v
    return out


def expand_frontier(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    edge_id: torch.Tensor, frontier: torch.Tensor,
                    frontier_mask: torch.Tensor, member: torch.Tensor,
                    edge_mask: torch.Tensor, *, capacity: int):
    """One hybrid-traversal hop on device (plain tensor ops).

    frontier: (C,) padded nids; member/edge_mask: boolean tables over nids /
    edge tids (the pushed predicates). Returns (src_slot, dst, eid, mask,
    overflowed): all (capacity,) padded outputs where ``src_slot`` indexes
    into the INPUT frontier (so callers can join path prefixes).
    """
    C = frontier.shape[0]
    fr = frontier.long()
    deg = torch.where(frontier_mask, row_ptr[fr + 1] - row_ptr[fr], 0)
    out_off = torch.cumsum(deg, 0) - deg                # exclusive prefix sum
    total = torch.sum(deg)
    overflowed = total > capacity

    # slot i of the output belongs to the frontier entry whose out_off range
    # covers i: searchsorted over the (sorted) offsets
    slots = torch.arange(capacity, dtype=out_off.dtype, device=fr.device)
    src_slot = torch.clamp(
        torch.searchsorted(out_off, slots, right=True) - 1, 0, C - 1)
    within = slots - out_off[src_slot]
    valid = slots < torch.clamp(total, max=capacity)
    src_nid = fr[src_slot]
    pos = torch.clamp(row_ptr[src_nid] + within, 0, col_idx.shape[0] - 1)
    dst = col_idx[pos].to(torch.int32)
    eid = edge_id[pos].to(torch.int32)
    valid &= member[torch.clamp(dst, 0, member.shape[0] - 1).long()]
    valid &= edge_mask[torch.clamp(eid, 0, edge_mask.shape[0] - 1).long()]
    return src_slot, dst, eid, valid, overflowed


class DevicePatternMatcher:
    """Chain-pattern matching fully on device with capacity retry. The CSR
    snapshot is epoch-stamped: ``refresh()`` re-syncs after a compaction
    and refuses (``StaleSnapshotError``) while deltas are pending, so the
    matcher can be cached on the graph and reused across write bursts."""

    def __init__(self, g: Graph, initial_capacity: int = 1 << 12,
                 max_capacity: int = 1 << 26,
                 device: "torch.device | str" = "cuda"):
        self.g = g
        self.device = torch.device(device)
        self.initial_capacity = initial_capacity
        self.max_capacity = max_capacity
        self.recompiles = 0
        self.refreshes = 0
        self.last_capacity = 0
        self._snapshot()

    def _snapshot(self) -> None:
        g = self.g
        if g.delta.has_pending():
            # the device snapshot reads base CSRs only; compacting here
            # would silently renumber edge tids under the caller's feet
            COUNTERS.stale_rejects += 1
            raise StaleSnapshotError(
                f"graph {g.name!r} has pending delta writes; call "
                "g.compact() before building a DevicePatternMatcher")
        if g.fwd.n_edges >= 1 << 31:
            raise ValueError(f"graph {g.name!r} has {g.fwd.n_edges} edges; "
                             "the device CSR is int32")

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=self.device)
        self.row_ptr = dev(g.fwd.row_ptr)
        self.col_idx = dev(g.fwd.col_idx)
        self.edge_id = dev(g.fwd.edge_id)
        self.row_ptr_r = dev(g.rev.row_ptr)
        self.col_idx_r = dev(g.rev.col_idx)
        self.edge_id_r = dev(g.rev.edge_id)
        self.epoch = g.epoch

    def refresh(self) -> None:
        """Refuse-or-refresh before serving: no-op while the graph epoch is
        unchanged; re-snapshot after a compaction settled the writes; raise
        while deltas are pending (mirrors ``ColumnIndex.refresh``)."""
        if self.g.epoch == self.epoch:
            return
        self._snapshot()
        self.refreshes += 1
        COUNTERS.refreshes += 1

    def csr(self, reverse: bool = False):
        if reverse:
            return self.row_ptr_r, self.col_idx_r, self.edge_id_r
        return self.row_ptr, self.col_idx, self.edge_id

    def match_chain(self, start_nids: np.ndarray,
                    vertex_members: list,
                    edge_masks: list, reverse: bool = False,
                    initial_capacity: Optional[int] = None):
        """vertex_members[h]: bool table over nids for hop-h target (None =
        label-unconstrained); edge_masks[h] likewise over edge tids.
        Returns (vcols, ecols): per-hop nid columns and per-hop edge-tid
        columns of the matched paths (compacted, host arrays).
        """
        self.refresh()
        cap = max(initial_capacity or self.initial_capacity,
                  1 << int(np.ceil(np.log2(max(len(start_nids), 1)))))

        while True:
            self.last_capacity = cap
            cols, ecols, ok = self._run(start_nids, vertex_members,
                                        edge_masks, cap, reverse)
            if ok:
                return cols, ecols
            if cap >= self.max_capacity:
                raise RuntimeError(f"pattern frontier exceeded max capacity "
                                   f"{self.max_capacity}")
            cap *= 2
            self.recompiles += 1
            COUNTERS.recompiles += 1
            COUNTERS.bump_retry(cap)

    def _run(self, start_nids, vertex_members, edge_masks, cap, reverse):
        n, m = self.g.n_vertices, self.g.edges.nrows
        dev = self.device
        ones_v = torch.ones((n,), dtype=torch.bool, device=dev)
        ones_e = torch.ones((max(m, 1),), dtype=torch.bool, device=dev)
        row_ptr, col_idx, edge_id = self.csr(reverse)
        if m == 0:      # keep every gather in range (no candidate is valid)
            col_idx = edge_id = torch.zeros((1,), dtype=torch.int32,
                                            device=dev)

        C0 = len(start_nids)
        frontier = torch.zeros((cap,), dtype=torch.int32, device=dev)
        frontier[:C0] = torch.as_tensor(np.asarray(start_nids),
                                        dtype=torch.int32, device=dev)
        fmask = torch.zeros((cap,), dtype=torch.bool, device=dev)
        fmask[:C0] = True
        path_cols = [frontier]
        path_ecols: list = []
        path_mask = fmask

        def table(v, ones):
            return ones if v is None else torch.as_tensor(
                np.asarray(v, bool), device=dev)
        for vm, em in zip(vertex_members, edge_masks):
            src_slot, dst, eid, valid, overflow = expand_frontier(
                row_ptr, col_idx, edge_id, path_cols[-1], path_mask,
                table(vm, ones_v), table(em, ones_e), capacity=cap)
            if bool(overflow):          # per-hop host sync
                return None, None, False
            # re-join path prefixes through src_slot
            path_cols = [c[src_slot] for c in path_cols]
            path_ecols = [c[src_slot] for c in path_ecols]
            path_cols.append(dst)
            path_ecols.append(eid)
            path_mask = valid & path_mask[src_slot]

        # compact on host (final materialization = the graph-relation)
        keep = path_mask.cpu().numpy()
        return ([c.cpu().numpy()[keep] for c in path_cols],
                [c.cpu().numpy()[keep] for c in path_ecols], True)


def get_matcher(g: Graph, initial_capacity: int = 1 << 12,
                device: "torch.device | str" = "cuda"
                ) -> DevicePatternMatcher:
    """The graph's cached matcher on ``device`` (holds the device CSR
    snapshot across queries); built lazily, kept fresh via ``refresh()``."""
    device = torch.device(device)
    m = getattr(g, "_device_matcher", None)
    if m is None or m.g is not g or m.device != device:
        m = DevicePatternMatcher(g, initial_capacity, device=device)
        g._device_matcher = m
    return m


# ---------------------------------------------------------------------------
# Plan lowering: PatternPlan -> device tables (shared by both flavors)
# ---------------------------------------------------------------------------


def prepare_chain(g: Graph, pplan, zone: bool = True) -> Optional[dict]:
    """Lower a chain PatternPlan to the device-table form: start nids, a
    per-hop member table over the nid space (pushed vertex predicates and
    the multi-label constraint folded in), per-hop edge-predicate tables
    over the tid space, and — with ``zone=True`` — the zone-map chunk
    survivor bitmap per hop (built via ``masked_eval`` skip-scans, so
    predicate-dead chunks are never read even while building the table).
    Uses the same ``pattern._candidate_set`` logic as the host matcher, so
    index-seeded start frontiers carry over. Returns None for non-chain
    patterns (the host matcher keeps those)."""
    pattern = pplan.pattern
    if not pattern.is_chain or not pattern.edges:
        return None
    chain_vars = [pattern.vertices[0].var] + [e.dst for e in pattern.edges]
    edge_vars = [e.var for e in pattern.edges]
    hop_vars = chain_vars[::-1] if pplan.reverse else chain_vars
    hop_edges = edge_vars[::-1] if pplan.reverse else edge_vars

    cand = {v: pattern_mod._candidate_set(g, pattern, v,
                                          pplan.pushed.get(v, []))
            for v in chain_vars}

    def member_of(v: str) -> Optional[np.ndarray]:
        c = cand[v]
        if c is None:
            if len(g.labels) > 1:
                # label constraint (host matcher's implicit hop filter)
                return np.asarray(
                    g.vertex_label_code
                    == g.label_code_of(pattern.vertex(v).label))
            return None
        full = np.zeros(g.n_vertices, dtype=bool)
        if c[0] == "mask":
            full[g.label_nids(pattern.vertex(v).label)] = c[1]
        else:       # vid rows -> nids
            full[g.nid_of(pattern.vertex(v).label, c[1])] = True
        return full

    members = [member_of(v) for v in hop_vars[1:]]

    im = getattr(g, "_index_manager", None)
    chunk = 0
    edge_preds: list = []
    chunk_alives: list = []
    for evar in hop_edges:
        preds = pplan.pushed.get(evar, [])
        if not preds:
            edge_preds.append(None)
            chunk_alives.append(None)
            continue
        mask: Optional[np.ndarray] = None
        alive: Optional[np.ndarray] = None
        for p in preds:
            pm = None
            ch = None
            idx = im.get(g.name, p.column) if (zone and im is not None) \
                else None
            if idx is not None:
                pm = idx.zone_mask(p)       # skip-scan: dead chunks unread
                if pm is not None and idx.zones is not None:
                    ch = idx.zones.candidate_chunks(p)
                    chunk = idx.zones.chunk
                    kernel_ops.COUNTERS.chunks_alive += int(ch.sum())
                    kernel_ops.COUNTERS.chunks_total += len(ch)
            if pm is None:
                pm = np.asarray(g.edges.eval_predicate(p))
            mask = pm if mask is None else mask & pm
            if ch is not None:
                alive = ch if alive is None else alive & ch
        edge_preds.append(mask)
        chunk_alives.append(alive)

    v0 = hop_vars[0]
    c0 = cand[v0]
    if c0 is None:
        start_nids = g.label_nids(pattern.vertex(v0).label)
    elif c0[0] == "rows":
        start_nids = np.atleast_1d(g.nid_of(pattern.vertex(v0).label, c0[1]))
    else:
        v0_nids = g.label_nids(pattern.vertex(v0).label)
        start_nids = v0_nids[c0[1]]

    from .cost import ZONE_CHUNK
    return {"start_nids": start_nids, "members": members,
            "edge_preds": edge_preds, "chunk_alives": chunk_alives,
            "reverse": bool(pplan.reverse),
            "chunk": chunk or ZONE_CHUNK,
            "chain_vars": chain_vars, "edge_vars": edge_vars}


def _round_capacity(n: int) -> int:
    return 1 << max(7, int(np.ceil(np.log2(max(n, 1)))))


def _estimate_capacity(g: Graph, prep: dict) -> int:
    """Pick the launch capacity from the lowered plan itself: walk the hops
    with the label-aware fan-out and the *actual* predicate-table survivor
    fractions, and size for the peak pre-predicate candidate count (the
    kernel must hold every candidate before compaction). Headroom 2x; the
    overflow-retry loop still backstops underestimates, this just keeps the
    steady state at one launch."""
    fan = g.hop_expansion(reverse=prep["reverse"])
    fr = float(len(prep["start_nids"]))
    peak = max(fr, 64.0)
    for mem, ep in zip(prep["members"], prep["edge_preds"]):
        cand = fr * fan
        peak = max(peak, cand)
        s_e = float(np.mean(ep)) if ep is not None else 1.0
        s_m = float(np.mean(mem)) if mem is not None else 1.0
        fr = cand * s_e * s_m
    return _round_capacity(int(2.0 * peak))


def _kernel_span_args(hops: int, capacity: int, n_vertices: int,
                      n_edges: int, prep: dict, launches: int) -> dict:
    """Analytic flops/bytes of the device traversal — the span payload
    ``roofline.from_trace`` reads (the operator is a DAG leaf, so the
    generic shape-derived model in ``telemetry.kernel_args`` has nothing to
    work from). Memory model: per hop, three int32 outputs plus per-slot
    gather traffic over the padded capacity (the device moves padded
    arrays regardless of validity), plus the predicate tables actually
    read — edge tables scaled by the zone-survivor fraction."""
    per_slot = 3 * 4 + (4 + 4 + 8 + 2 + 1)    # outputs + gathers
    tbl_bytes = 0.0
    for mem in prep["members"]:
        if mem is not None:
            tbl_bytes += n_vertices
    for ep, ca in zip(prep["edge_preds"], prep["chunk_alives"]):
        if ep is None:
            continue
        frac = (float(ca.sum()) / max(len(ca), 1)) if ca is not None else 1.0
        tbl_bytes += frac * n_edges + (0 if ca is None else len(ca))
    flops = float(hops) * capacity * 12.0 * launches
    nbytes = (float(hops) * capacity * per_slot * launches + tbl_bytes)
    return {"flops": flops, "bytes": int(nbytes), "hops": hops,
            "capacity": capacity,
            "zone_chunks_alive": kernel_ops.COUNTERS.chunks_alive,
            "zone_chunks_total": kernel_ops.COUNTERS.chunks_total}


def device_match(g: Graph, pplan, *, flavor: str = "pallas",
                 initial_capacity: Optional[int] = None,
                 max_capacity: int = 1 << 24,
                 use_kernel: Optional[bool] = None,
                 device: "torch.device | str" = "cuda"):
    """Execute a chain PatternPlan on the device path and build the same
    graph-relation Table as ``pattern.match`` (vertex columns hold vids,
    edge columns hold tids; deferred predicates applied). Returns
    (rel, kernel_args) — the second element is the telemetry span payload.
    ``flavor``: "pallas" (fused chain, zone-filtered tables) or "jit"
    (per-hop ``DevicePatternMatcher``). ``device`` holds the CSR snapshot
    and runs the hops. Raises ``StaleSnapshotError`` on pending deltas;
    callers degrade to the host matcher."""
    COUNTERS.matches += 1
    matcher = get_matcher(g, device=device)
    matcher.refresh()
    prep = prepare_chain(g, pplan, zone=(flavor == "pallas"))
    if prep is None:
        raise ValueError(f"pattern {pplan.pattern.canonical()!r} is not a "
                         "chain; device path unavailable")
    pattern = pplan.pattern
    start = prep["start_nids"]
    hops = len(prep["edge_vars"])
    launches = 1

    if flavor == "jit":
        vcols, ecols = matcher.match_chain(
            start, prep["members"], prep["edge_preds"],
            reverse=prep["reverse"],
            initial_capacity=initial_capacity or _estimate_capacity(g, prep))
        cap = matcher.last_capacity
    else:
        row_ptr, col_idx, edge_id = matcher.csr(prep["reverse"])
        cap = initial_capacity or _estimate_capacity(g, prep)
        cap = max(cap, _round_capacity(len(start)))
        while True:
            vcols, ecols, ok = kernel_ops.traverse_chain(
                row_ptr, col_idx, edge_id, g.n_vertices, g.edges.nrows,
                start, prep["members"], prep["edge_preds"],
                prep["chunk_alives"], capacity=cap, chunk=prep["chunk"],
                use_kernel=use_kernel)
            if ok:
                break
            if cap >= max_capacity:
                raise RuntimeError(f"pattern frontier exceeded max capacity "
                                   f"{max_capacity}")
            cap *= 2
            launches += 1
            COUNTERS.retries += 1
            COUNTERS.bump_retry(cap)

    if prep["reverse"]:
        vcols = vcols[::-1]
        ecols = ecols[::-1]
    cols: dict[str, np.ndarray] = {}
    for var, col in zip(prep["chain_vars"], vcols):
        cols[var] = g.vids_of(col)
    for evar, col in zip(prep["edge_vars"], ecols):
        cols[evar] = col
    rel = Table(f"match:{pattern.graph}", cols)
    rel = pattern_mod.apply_deferred(g, pattern, rel, pplan.deferred)
    kargs = _kernel_span_args(hops, cap, g.n_vertices, g.edges.nrows, prep,
                              launches)
    kargs["flavor"] = flavor
    return rel, kargs
