"""Cost model (paper §6.3), retargeted from disk I/O to a memory-hierarchy
model for a vectorized engine.

The paper charges ``Cost_IO`` per record fetch and ``Cost_cpu`` per function
call / predicate evaluation. We keep the exact formula structure (Eqs. 11-16)
and re-interpret the constants: one "I/O" = moving a record through the
memory hierarchy, one "cpu" = one vector-lane op. The *ratio* is what drives
planning; record fetches dominate identifier-space ops, as on the paper's
disk engine.
"""
from __future__ import annotations

import numpy as np

# Relative unit costs. Every constant in this module is unitless and kept
# identical to the JAX package's, so the optimizer picks the same plans
# (plan parity); none of them is calibrated to the GPU.
COST_IO = 40.0
COST_CPU = 1.0


# ---- hybrid traversal costs (4 cases, §6.3) --------------------------------

def cost_v_to_nid(n: int) -> float:
    return n * COST_CPU


def cost_nid_to_v(n: int) -> float:
    return n * (COST_CPU + COST_IO)


def cost_nid_to_nid(n: int, avg_deg: float) -> float:
    return n * avg_deg * COST_CPU


def cost_nid_to_e(n: int, avg_deg: float) -> float:
    return n * avg_deg * (2 * COST_CPU + COST_IO)


# ---- pattern matching cost (Eq. 11-13) --------------------------------------

def cost_pattern(n_push_v: int, n_push_e: int, n_vertices: int, n_edges: int,
                 est_frontier: float, hops: int, avg_deg: float,
                 est_result: float, n_deferred: int) -> float:
    cost_algo2 = (n_push_v * n_vertices + n_push_e * n_edges) * (COST_IO + COST_CPU)
    lam = sum(avg_deg ** (h + 1) for h in range(hops))  # traversals per start record
    cost_algo2 += est_frontier * lam * COST_CPU
    cost_prop = est_result * n_deferred * COST_CPU
    return cost_algo2 + cost_prop


COST_LAUNCH = 5000.0   # fixed dispatch + host<->device sync per launch window
DEVICE_LANES = 8.0     # vector-lane speedup of device frontier expansion


def cost_device_match(n_push_v: int, n_push_e: int, n_vertices: int,
                      n_edges: int, est_frontier: float, hops: int,
                      avg_deg: float, est_result: float, n_deferred: int, *,
                      zone_frac: float = 1.0,
                      per_hop_sync: bool = False) -> float:
    """Device-resident pattern match (DeviceMatchPattern). Differs from
    ``cost_pattern`` in three ways: vertex predicate tables are pure columnar
    scans (no per-record fetch), edge predicate tables read only the
    zone-candidate fraction of the edge column (the kernel's prefetch filter
    skips dead chunks), and the per-record traversal work runs at vector
    width. In exchange every launch window pays a fixed dispatch+sync
    charge — per hop for the jit matcher (it syncs on the overflow flag each
    hop), once for the fused chain (one end-of-chain sync)."""
    tables = (n_push_v * n_vertices * COST_CPU
              + n_push_e * max(zone_frac, 0.0) * n_edges * (COST_IO + COST_CPU))
    lam = sum(avg_deg ** (h + 1) for h in range(hops))
    traverse = est_frontier * lam * COST_CPU / DEVICE_LANES
    launches = (2.0 * hops) if per_hop_sync else 2.0
    return tables + traverse + launches * COST_LAUNCH + est_result * n_deferred * COST_CPU


def should_push_range(g, tbl, pred) -> bool:
    """Cost-compare pushing a range predicate at the end vertex vs deferring
    it to the graph-relation (Fig. 6 end-vertex rule)."""
    sel = tbl.stats(pred.column).selectivity(pred)
    n = tbl.nrows
    avg_deg = g.avg_out_degree
    # push: full column scan now, but frontier shrinks by sel
    est_matches = n * avg_deg  # rough |P(G,P)| upper bound for one hop
    push_cost = n * (COST_IO + COST_CPU) + sel * est_matches * COST_CPU
    # defer: full expansion, then evaluate on result rows (record fetch each)
    defer_cost = est_matches * (COST_CPU + COST_IO)
    return push_cost <= defer_cost


# ---- physical-operator costs (consumed by physical.estimate) ---------------

def cost_scan(n: int) -> float:
    """Sequential RecordAM scan of n records."""
    return n * (COST_IO + COST_CPU)


def cost_project(n: int, n_attrs: int) -> float:
    """Graph projection π̂_A': one tid-based record fetch per (row, attr)."""
    return n * max(n_attrs, 1) * (COST_IO + COST_CPU)


def cost_filter(n: float, n_preds: int = 1) -> float:
    """Post-scan/post-join predicate application (Select residue,
    IntraFilter, Residual): one vector-lane compare per (row, predicate).
    Shared by ``physical.estimate`` and the optimizer's join enumerator so
    both charge identical prices for folding a predicate into a plan."""
    return float(n) * max(n_preds, 1) * COST_CPU


def cost_index_lookup(n: float, hits: float) -> float:
    """Posting-list access path: binary probes into the sorted postings
    (log n) plus one tid-based record fetch per matching row — the price
    that undercuts ``cost_scan`` exactly when the predicate is selective."""
    return (np.log2(max(n, 2.0)) * COST_CPU
            + max(hits, 0.0) * (COST_IO + COST_CPU))


ZONE_CHUNK = 2048   # rows per zone-map chunk (repro_torch.core.index imports this)


def cost_zone_scan(n: float, frac: float, n_chunks: float = 0.0) -> float:
    """Zone-map skip-scan: one min/max probe per chunk, then a sequential
    scan of the candidate fraction only. Callers holding the live ZoneMap
    pass its actual ``n_chunks``; the default derives from ZONE_CHUNK."""
    nch = n_chunks if n_chunks else max(float(n) / ZONE_CHUNK, 1.0)
    return nch * COST_CPU + max(frac, 0.0) * float(n) * (COST_IO + COST_CPU)


def cost_semijoin(n_left: int, n_right: int) -> float:
    """Semi-join reduction (Eq. 9/10 mask build): sort the smaller key set,
    binary-probe the larger — no output expansion."""
    nl, nr = max(n_left, 1), max(n_right, 1)
    small = min(nl, nr)
    return (small * np.log2(max(small, 2)) + nl + nr) * COST_CPU


# ---- matrix generation + analytical operator costs (GCDA, Eq. 5/6) ---------

def cost_matrix_gen(n: int, k: int) -> float:
    """REL2MATRIX / random access: one gather+scatter per (row, feature)."""
    return n * max(k, 1) * (COST_IO + COST_CPU)


def cost_matmul(n: int, k: int, m: int) -> float:
    return float(n) * max(k, 1) * max(m, 1) * COST_CPU


def cost_similarity(n: int, k: int, m: int) -> float:
    # normalize both sides + one (n, m) score matmul
    return (n + m) * max(k, 1) * COST_CPU + cost_matmul(n, k, m)


def cost_regression(n: int, k: int, iters: int) -> float:
    return 2.0 * float(iters) * cost_matmul(n, k, 1)


# ---- cross-model join cost (Eq. 14-16) ---------------------------------------

BLOCK_RECORDS = 1024  # b: records per block (vector register tile analogue)


def cost_join(n_left: int, n_right: int, in_memory: bool = True) -> float:
    if in_memory:  # Eq. 14 — but our engine sorts: O((N+M) log) cpu
        nl, nr = max(n_left, 1), max(n_right, 1)
        return (nl * np.log2(nl) + nr * np.log2(nr) + nl + nr) * COST_CPU
    # Eq. 15 (both fit in buffer) — kept for fidelity with the paper
    return ((n_left + n_right) / BLOCK_RECORDS) * COST_IO + n_left * n_right * COST_CPU


def cost_join_nested(n_left: int, n_right: int) -> float:
    """Eq. 14 literal (nested loop) — used by the volcano baseline."""
    return n_left * n_right * COST_CPU


# ---- sharded execution costs (morsel-parallel operator DAG) -----------------

MORSEL_ROWS = 262144        # probe-side rows per morsel (large: amortizes
                            # per-morsel dispatch; fits L2-ish working sets)
SHARD_MIN_ROWS = 100000     # below this dominant input, serial execution wins
SHARD_OVERHEAD = 2000.0     # fixed per-shard setup (task dispatch, slicing)


def cost_exchange(n: float, k: int) -> float:
    """Partition-exchange: hash every key (one lane op), one stable counting
    sort into k runs (two passes over the rows), then a per-shard key sort.
    Co-partitioned inputs (cached partitions at the same epoch) skip this
    entirely — the cost the executor's exchange cache saves."""
    n = max(float(n), 1.0)
    per_shard = n / max(k, 1)
    return (3.0 * n + k * per_shard * np.log2(max(per_shard, 2.0))) * COST_CPU


def cost_sharded_scan(n: float, n_preds: int, k: int) -> float:
    """Fused per-shard filter: predicate masks are ANDed per shard and rows
    are gathered once, instead of one full ``take`` per predicate — the
    row-movement term drops from ``n_preds`` gathers to one."""
    n = max(float(n), 0.0)
    return (n * max(n_preds, 1) * COST_CPU     # mask evaluation
            + n * COST_IO                       # single gather
            + k * SHARD_OVERHEAD)


def cost_sharded_join(n_left: float, n_right: float, k: int) -> float:
    """Hash-sharded sort-merge join: the build side pays the exchange + one
    per-shard key sort; each probe morsel binary-searches its shard only
    (log of the per-shard run, not of the whole build side)."""
    nl, nr = max(float(n_left), 1.0), max(float(n_right), 1.0)
    per_shard = nr / max(k, 1)
    probe = nl * (1.0 + np.log2(max(per_shard, 2.0))) * COST_CPU
    return cost_exchange(nr, k) + probe + k * SHARD_OVERHEAD


def choose_shard_count(dominant_rows: float, k_requested: int) -> int:
    """Cost-based shard-count choice: serial (k=1) when the dominant input
    is too small for the per-shard setup + exchange to pay off. The
    crossover is where the sharded join/scan costs (above) undercut the
    serial ``cost_join``/``cost_scan`` — in practice a fixed floor, since
    both models scale linearly past it."""
    k = max(int(k_requested), 1)
    if k == 1 or dominant_rows < SHARD_MIN_ROWS:
        return 1
    return k


# ---------------------------------------------------------------------------
# Device traversal capacity (§ device lowering): shared by the optimizer's
# access-path selection and the static plan verifier — the two must derive
# the identical bound or verification would reject the optimizer's own plans.
# ---------------------------------------------------------------------------


def padded_capacity(peak: float) -> int:
    """Static-shape frontier capacity for an estimated peak candidate count:
    2x headroom (estimates err low on skewed fan-out), rounded up to a
    power of two with a 128-slot floor (one compaction block)."""
    need = max(int(peak * 2.0), 1)
    return 1 << max(7, (need - 1).bit_length())


def device_frontier_peak(g, pplan) -> float:
    """Statically derivable peak frontier of a mask-free chain pattern:
    start-label cardinality scaled by pushed-predicate selectivity, then
    per-hop label-aware expansion — *pre*-predicate, since the kernel's
    capacity must hold every candidate before in-kernel compaction."""
    pat = pplan.pattern
    chain = [pat.vertices[0].var] + [e.dst for e in pat.edges]
    hop_order = chain[::-1] if pplan.reverse else chain
    start = hop_order[0]
    stbl = g.vertex_tables[pat.vertex(start).label]
    n_start = float(stbl.nrows)
    for pr in pplan.pushed.get(start, []):
        n_start *= stbl.stats(pr.column).selectivity(pr)
    peak = front = max(n_start, 1.0)
    for v in hop_order[:-1]:
        front *= g.hop_expansion(reverse=pplan.reverse,
                                 label=pat.vertex(v).label)
        peak = max(peak, front)
    return peak
