"""Hybrid traversal operator ``|->`` (paper §5.1, Algorithm 1), vectorized.

The paper's operator is a binary volcano iterator emitting (r1, r2) pairs for
operand combinations V×I, I×V, I×I, I×E. Here we re-derive it with set
semantics: one call consumes a whole operand set and returns all pairs as
parallel arrays. ``tests/test_oracle_equivalence.py`` checks this against a
literal transcription of Algorithm 1.

Operand encodings:
  * vertex records  -> (label, vid array)  [record side]
  * nid sets        -> int array of nids   [topology side]
  * edge records    -> edge tid array
A "membership filter" operand (the paper's ``nid_t in O^2`` test, Line 17) is
passed as an optional boolean lookup table over nids — an O(1) symbolic
identifier test, exactly as the paper argues (no record I/O).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .storage import Graph


class TraversalCounters:
    """Execution counters consumed by the cost model's calibration and the
    benchmark harness (records touched == the paper's I/O proxy)."""

    def __init__(self):
        self.record_fetches = 0   # Cost_IO-weighted accesses
        self.cpu_ops = 0          # Cost_cpu-weighted ops

    def reset(self):
        self.record_fetches = 0
        self.cpu_ops = 0


COUNTERS = TraversalCounters()


# ---- Case 1: V x I  (vertex records -> nids) -------------------------------

def v_to_nid(g: Graph, label: str, vids: np.ndarray) -> np.ndarray:
    """nidMap: (oid, vid) -> nid; vectorized one-to-one mapper."""
    COUNTERS.cpu_ops += len(vids)
    return g.nid_of(label, vids)


# ---- Case 2: I x V  (nids -> vertex records) -------------------------------

def nid_to_v(g: Graph, nids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """vertexMap + tid-based RecordAM: nids -> (label_code, vid). The caller
    gathers property columns with ``Table.take(vid)``."""
    nids = np.asarray(nids)
    COUNTERS.cpu_ops += len(nids)
    COUNTERS.record_fetches += len(nids)
    return g.vertex_label_code[nids], g.vertex_vid_of[nids]


# ---- Case 3: I x I  (source nids -> target nids) ---------------------------

def nid_to_nid(g: Graph, nids: np.ndarray, member: Optional[np.ndarray] = None,
               reverse: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-frontier adjacency expansion. Returns (src_rep, dst_nid, edge_tid)
    filtered by the optional ``member`` boolean table over target nids.

    The membership test is the paper's Line 17 — here a single vectorized
    gather ``member[dst]`` instead of a per-pair set probe, which removes the
    O(|O1|·|O2|) blowup the paper warns about (§5.1) by construction.
    """
    nids = np.asarray(nids)
    pos, dst, eid = g.expand(nids, reverse=reverse)
    src_rep = nids[pos]
    COUNTERS.cpu_ops += len(dst) + len(nids)
    if member is not None:
        keep = member[dst]
        COUNTERS.cpu_ops += len(dst)
        return src_rep[keep], dst[keep], eid[keep]
    return src_rep, dst, eid


# ---- Case 4: I x E  (source nids -> edge records) --------------------------

def nid_to_e(g: Graph, nids: np.ndarray, edge_mask: Optional[np.ndarray] = None,
             reverse: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Adjacency expansion emitting edge tids (edgeMap + tid-based RecordAM).
    ``edge_mask`` is a boolean table over edge tids (predicate already
    evaluated columnar-side)."""
    nids = np.asarray(nids)
    pos, dst, eid = g.expand(nids, reverse=reverse)
    src_rep = nids[pos]
    COUNTERS.cpu_ops += len(dst) + len(nids)
    COUNTERS.record_fetches += len(eid)
    if edge_mask is not None:
        keep = edge_mask[eid]
        COUNTERS.cpu_ops += len(eid)
        return src_rep[keep], dst[keep], eid[keep]
    return src_rep, dst, eid


def member_table(n: int, nids: np.ndarray) -> np.ndarray:
    """Build the boolean membership lookup used by Case 3/4 filters."""
    m = np.zeros(n, dtype=bool)
    m[np.asarray(nids)] = True
    return m
