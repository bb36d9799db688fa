"""Cross-model join operator ``⋈̂`` (paper §5.3, Algorithm 3), vectorized.

Two strategies, as in the paper:
  1. rel/doc x rel/doc — record-level equi-join. The paper uses nested-loop /
     PK-index joins; the vectorized equivalent is a sort+searchsorted
     equi-join (no hash tables, fully vectorizable). Dense integer keys skip
     the sort and the binary searches: a table indexed by key less the least
     build key gives each probe its run (or its one row) by a gather.
  2. graph x rel/doc — entity linking: the join filters the graph's vertex or
     edge record set in place and returns the (still-graph) collection, so a
     subsequent match runs on the reduced candidate sets (join pushdown,
     Eq. 9/10).
"""
from __future__ import annotations

import numpy as np

from . import traversal
from .deltastore import expand_runs
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


# The direct-address path is taken when the build keys span at most this many
# times the rows of both sides. Its table (an int64 slot or run start per key)
# then costs a few linear passes over memory of about the inputs' own size,
# where the sort join pays n log n for the build's sort and a binary search
# per probe into it.
DENSE_SPAN = 4
# Keys beyond this magnitude take the sort path, so that key − least key
# cannot overflow int64 (see ``_dense_offsets``).
_KEY_LIMIT = 2 ** 62


class _Counters:
    """How often each probe path ran: ``direct`` (the direct-address table)
    and ``sorted`` (the sort join). Process-wide and cumulative, as the
    traversal counters; the engine's per-query view is a registry delta."""

    def __init__(self):
        self.direct = 0
        self.sorted = 0

    def metrics(self) -> dict:
        return {"direct": self.direct, "sorted": self.sorted}


COUNTERS = _Counters()


def metrics() -> dict:
    """Telemetry registry source ``join``: both probes' path counts."""
    return COUNTERS.metrics()


def _dense_dtype(dt: np.dtype) -> bool:
    """Integers that int64 holds whole (uint64 does not)."""
    return dt.kind == "i" or (dt.kind == "u" and dt.itemsize < 8)


def _dense_offsets(build: np.ndarray, probe: np.ndarray):
    """The one test of both probes for the direct path, and its offsets.

    Where both key arrays are integer, the build is not empty, its keys lie
    within ±2^62 and span at most ``DENSE_SPAN`` times the rows of both
    sides, returns ``(span, build_off, probe_off)``: each key less the least
    build key, as int64, a probe key outside the build's range mapped to
    ``span`` (one slot past the table, which matches nothing). Else None.

    A probe key far from the build's range wraps in the subtraction, but
    both its true and its wrapped offset lie outside ``[0, span)``, so
    clamping the offset read as unsigned to ``span`` is exact."""
    if not (_dense_dtype(build.dtype) and _dense_dtype(probe.dtype)
            and len(build)):
        return None
    kmin, kmax = int(build.min()), int(build.max())
    span = kmax - kmin + 1
    if (kmin < -_KEY_LIMIT or kmax > _KEY_LIMIT
            or span > DENSE_SPAN * (len(build) + len(probe))):
        return None
    build_off = np.subtract(build, kmin, dtype=np.int64)
    probe_off = np.subtract(probe, kmin, dtype=np.int64)
    wide = probe_off.view(np.uint64)
    np.minimum(wide, span, out=wide)
    return span, build_off, probe_off


def equi_join_indices(left: Table, lcol: str, right: Table, rcol: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """All (left_row, right_row) pairs with left.lcol == right.rcol, left
    major, equal keys in right-row order (a stable sort's order).

    Dense integer keys (``_dense_offsets``) take a direct-address table:
    unique build keys one slot per key and one gather per probe; duplicate
    keys a counting sort whose run starts and lengths come from a bincount.
    Everything else sorts the right keys, binary-searches each left key and
    expands the runs. Both give the same pairs in the same order."""
    lk, lrows = _key_arrays(left, lcol)
    rk, rrows = _key_arrays(right, rcol)
    traversal.COUNTERS.cpu_ops += len(lk) + len(rk)

    dense = _dense_offsets(rk, lk)
    if dense is None:
        COUNTERS.sorted += 1
        order = np.argsort(rk, kind="stable")
        rk_s = rk[order]
        lo = np.searchsorted(rk_s, lk, side="left")
        counts = np.searchsorted(rk_s, lk, side="right") - lo
    else:
        COUNTERS.direct += 1
        span, roff, loff = dense
        runs = np.bincount(roff, minlength=span + 1)   # runs[span] = 0
        if runs.max() <= 1:
            slot = np.full(span + 1, -1, dtype=np.int64)
            slot[roff] = np.arange(len(roff))
            r = slot[loff]
            l_rep = np.flatnonzero(r >= 0)
            traversal.COUNTERS.cpu_ops += len(l_rep)
            return lrows[l_rep], rrows[r[l_rep]]
        # numpy's stable sort is a radix sort on 16-bit keys
        order = np.argsort(roff.astype(np.uint16) if span <= 1 << 16
                           else roff, kind="stable")
        start = np.cumsum(runs) - runs
        lo, counts = start[loff], runs[loff]
    l_rep, pos = expand_runs(lo, counts)
    traversal.COUNTERS.cpu_ops += len(pos)
    return lrows[l_rep], rrows[order[pos]]


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
    sidings: graph-side candidate masks and table-side reductions. Dense
    integer keys (``_dense_offsets``) take a presence bitmap over the keys'
    range, read by each table key; others a sorted key set."""
    tk, trows = _key_arrays(tbl, col)
    keys = np.asarray(keys)
    traversal.COUNTERS.cpu_ops += len(tk) + len(keys)
    hit = np.zeros(tbl.nrows, dtype=bool)
    dense = _dense_offsets(keys, tk)
    if dense is not None:
        COUNTERS.direct += 1
        span, koff, toff = dense
        present = np.zeros(span + 1, dtype=bool)   # present[span] = False
        present[koff] = True
        hit[trows[present[toff]]] = True
        return hit
    COUNTERS.sorted += 1
    keys_u = np.unique(keys)
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
