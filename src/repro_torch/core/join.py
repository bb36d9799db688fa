"""Cross-model join operator ``⋈̂`` (paper §5.3, Algorithm 3), vectorized.

Two strategies, as in the paper:
  1. rel/doc x rel/doc — record-level equi-join. The paper uses nested-loop /
     PK-index joins; the vectorized equivalent is a sort+searchsorted
     equi-join (one gather per probe, no hash tables, fully vectorizable).
  2. graph x rel/doc — entity linking: the join filters the graph's vertex or
     edge record set in place and returns the (still-graph) collection, so a
     subsequent match runs on the reduced candidate sets (join pushdown,
     Eq. 9/10).
"""
from __future__ import annotations

import numpy as np

from . import traversal
from .schema import JoinPred
from .storage import DictColumn, Graph, RaggedColumn, Table


def _key_arrays(tbl: Table, column: str):
    """Return (keys, row_ids). Ragged (multi-valued NF²) columns unnest:
    each element becomes a probe key with its parent row id."""
    col = tbl.col(column)
    if isinstance(col, DictColumn):
        return col.vocab[col.codes], np.arange(tbl.nrows)
    if isinstance(col, RaggedColumn):
        rows = np.repeat(np.arange(len(col)), col.lengths())
        return col.values, rows
    return np.asarray(col), np.arange(tbl.nrows)


def equi_join_indices(left: Table, lcol: str, right: Table, rcol: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """All (left_row, right_row) pairs with left.lcol == right.rcol.
    Sort-based: sort right keys, binary-search each left key, expand runs."""
    lk, lrows = _key_arrays(left, lcol)
    rk, rrows = _key_arrays(right, rcol)
    traversal.COUNTERS.cpu_ops += len(lk) + len(rk)

    order = np.argsort(rk, kind="stable")
    rk_s, rrows_s = rk[order], rrows[order]
    lo = np.searchsorted(rk_s, lk, side="left")
    hi = np.searchsorted(rk_s, lk, side="right")
    counts = hi - lo
    total = int(counts.sum())
    l_rep = np.repeat(np.arange(len(lk)), counts)
    out_off = np.zeros(len(lk) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    pos = np.repeat(lo, counts) + (np.arange(total) - np.repeat(out_off[:-1], counts))
    traversal.COUNTERS.cpu_ops += total
    return lrows[l_rep], rrows_s[pos]


def join_tables(left: Table, right: Table, pred: JoinPred,
                lprefix: str = "", rprefix: str = "") -> Table:
    """Strategy 1: rel/doc ⋈̂ rel/doc producing a linked NF² collection."""
    lcol = pred.left.split(".", 1)[1]
    rcol = pred.right.split(".", 1)[1]
    li, ri = equi_join_indices(left, lcol, right, rcol)
    lt, rt = left.take(li), right.take(ri)
    cols = {}
    for k, v in lt.columns.items():
        cols[f"{lprefix or left.name}.{k}"] = v
    for k, v in rt.columns.items():
        cols[f"{rprefix or right.name}.{k}"] = v
    traversal.COUNTERS.record_fetches += len(li) + len(ri)
    return Table(f"{left.name}⋈{right.name}", cols)


def member_mask(tbl: Table, col: str, keys: np.ndarray) -> np.ndarray:
    """Boolean mask over ``tbl`` rows whose ``col`` value appears in ``keys``
    (ANY semantics for ragged columns). The shared probe of both semi-join
    sidings: graph-side candidate masks and table-side reductions."""
    tk, trows = _key_arrays(tbl, col)
    traversal.COUNTERS.cpu_ops += len(tk) + len(keys)
    keys_u = np.unique(np.asarray(keys))
    hit = np.zeros(tbl.nrows, dtype=bool)
    if len(keys_u):
        pos = np.clip(np.searchsorted(keys_u, tk), 0, len(keys_u) - 1)
        np.logical_or.at(hit, trows, keys_u[pos] == tk)
    return hit


def semi_join_graph(g: Graph, label: str, vcol: str, other: Table, ocol: str
                    ) -> np.ndarray:
    """Strategy 2 (Lines 4-12): graph ⋈̂ rel/doc. Returns the boolean mask of
    vertices of ``label`` whose ``vcol`` appears in ``other.ocol`` — i.e. the
    updated vertex record set V of the output graph. The topology is shared
    (candidate-set semantics), which is what enables join pushdown into the
    match (Eq. 9/10)."""
    ok, _ = _key_arrays(other, ocol)
    return member_mask(g.vertex_tables[label], vcol, ok)


def semi_join_table(tbl: Table, col: str, g: Graph, label: str, vcol: str
                    ) -> np.ndarray:
    """The reverse siding of the Eq. 9/10 semi-join: boolean mask of *table*
    rows whose ``col`` appears among the graph's ``label.vcol`` vertex keys.
    Reduces the relational/document side before the final equi-join when the
    vertex key set is the smaller build input."""
    vk, _ = _key_arrays(g.vertex_tables[label], vcol)
    return member_mask(tbl, col, vk)


def match_by_joins(g: Graph, pat) -> Table:
    """TBS-style pattern matching (GredoDB-S): k-hop pattern == k-way
    self-join of the edge table on svid/tvid (index-accelerated in
    AgensGraph; sort-merge here). No topology store, no pushdown —
    intermediate results grow multiplicatively, which is exactly the §2.2
    critique. Executed by the physical plan's TableJoinMatch operator."""
    from .deltastore import expand_runs
    chain_vars = [pat.vertices[0].var] + [e.dst for e in pat.edges]
    edge_vars = [e.var for e in pat.edges]
    if not edge_vars:  # vertex-only pattern: full vertex scan
        var = pat.vertices[0].var
        n = g.vertex_tables[pat.vertex(var).label].nrows
        traversal.COUNTERS.record_fetches += n
        return Table("join0", {var: np.arange(n)})
    live = g.live_edge_ids()  # tombstoned edges never join
    svid = np.asarray(g.edges.col("svid"))
    tvid = np.asarray(g.edges.col("tvid"))
    if g.delta.n_tombstones:  # only copy-filter when something is dead
        svid, tvid = svid[live], tvid[live]
    traversal.COUNTERS.record_fetches += 2 * len(svid) * max(len(edge_vars), 1)

    cols = {chain_vars[0]: svid, edge_vars[0]: live, chain_vars[1]: tvid}
    cur = Table("join0", cols)
    # the edge table is static across hops: sort once, probe per hop
    order = np.argsort(svid, kind="stable")
    svid_s = svid[order]
    for h in range(1, len(edge_vars)):
        # join cur.tail == edges.svid
        tail = np.asarray(cur.col(chain_vars[h]))
        lo = np.searchsorted(svid_s, tail, "left")
        hi = np.searchsorted(svid_s, tail, "right")
        l_rep, pos = expand_runs(lo, hi - lo)
        total = len(pos)
        traversal.COUNTERS.cpu_ops += total
        traversal.COUNTERS.record_fetches += total
        rows = order[pos]
        ncols = {k: np.asarray(v)[l_rep] for k, v in cur.columns.items()}
        ncols[edge_vars[h]] = live[rows]
        ncols[chain_vars[h + 1]] = tvid[rows]
        cur = Table(f"join{h}", ncols)
    return cur


def semi_join_graph_edges(g: Graph, ecol: str, other: Table, ocol: str) -> np.ndarray:
    """graph ⋈̂ rel/doc over edge records: boolean mask of edges."""
    ok, _ = _key_arrays(other, ocol)
    return member_mask(g.edges, ecol, ok)
