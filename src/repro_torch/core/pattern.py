"""Topology- and attribute-aware pattern matching (paper §5.2, Algorithm 2).

Vectorized re-derivation: Algorithm 2's DFS stack over partial paths becomes
whole-frontier expansion — at hop i the set of valid partial paths is a
(n_paths, i+1) binding matrix; one CSR gather advances every path at once.
Semantics (the multiset of matched bindings) are identical; property tests
check against a literal transcription of the pseudocode.

Attribute-awareness (Fig. 6):
  * rule-based: single-sided predicates are pushed and traversal starts from
    the predicate side (forward/reverse);
  * cost-based: with predicates on both ends, effective cardinalities
    |M(v)| * S_phi(v) decide the start side; end-vertex equality predicates are
    always pushed, inequality deferred, range predicates cost-compared.
Query-aware traversal pruning (§6.2): hops whose target carries no predicate
and is not projected skip the record fetch entirely (topology-only gather).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import cost as cost_mod
from . import traversal
from .schema import Pattern, Predicate
from .storage import Graph, Table


@dataclasses.dataclass
class PatternPlan:
    pattern: Pattern
    reverse: bool                       # traversal direction (Fig. 6)
    pushed: dict                        # var -> [Predicate] evaluated before traversal
    deferred: dict                      # var -> [Predicate] evaluated on the graph-relation
    fetch_vars: set                     # vars whose records must be fetched (projection/deferred)
    est_cost: float = 0.0

    def describe(self) -> str:
        d = "reverse" if self.reverse else "forward"
        return (f"PatternPlan(dir={d}, pushed={{{', '.join(f'{k}:{v}' for k, v in self.pushed.items())}}}, "
                f"deferred={{{', '.join(f'{k}:{v}' for k, v in self.deferred.items())}}}, "
                f"fetch={sorted(self.fetch_vars)})")


def _predicate_selectivity(tbl: Table, preds: list[Predicate]) -> float:
    s = 1.0
    for p in preds:
        s *= tbl.stats(p.column).selectivity(p)
    return s


def plan_pattern(g: Graph, pattern: Pattern, phi: dict[str, list[Predicate]],
                 projected: set[str], force_reverse: Optional[bool] = None,
                 enable_pushdown: bool = True) -> PatternPlan:
    """Choose direction + pushdown set per Fig. 6. ``phi`` maps pattern var ->
    predicates (the predicate assignment function), ``projected`` lists vars
    referenced by the enclosing projection."""
    chain_vars = [pattern.vertices[0].var] + [e.dst for e in pattern.edges]
    src_var, dst_var = chain_vars[0], chain_vars[-1]
    pushed: dict[str, list[Predicate]] = {}
    deferred: dict[str, list[Predicate]] = {v: list(ps) for v, ps in phi.items() if ps}

    if not enable_pushdown:
        reverse = bool(force_reverse)
        fetch = set(projected) | set(deferred)
        return PatternPlan(pattern, reverse, {}, deferred, fetch)

    def tbl_of(var: str) -> Table:
        return g.vertex_tables[pattern.vertex(var).label]

    s_preds = deferred.get(src_var, [])
    t_preds = deferred.get(dst_var, [])

    if s_preds and not t_preds:
        reverse = False                      # Fig. 6(a): start from predicate side
    elif t_preds and not s_preds:
        reverse = True                       # Fig. 6(b)
    elif s_preds and t_preds:                # Fig. 6(c): cost-based
        cs = tbl_of(src_var).nrows * _predicate_selectivity(tbl_of(src_var), s_preds)
        ct = tbl_of(dst_var).nrows * _predicate_selectivity(tbl_of(dst_var), t_preds)
        reverse = ct < cs
    else:
        # no end predicates: start from the smaller candidate set
        reverse = tbl_of(dst_var).nrows < tbl_of(src_var).nrows
    if force_reverse is not None:
        reverse = force_reverse

    start_var = dst_var if reverse else src_var
    end_var = src_var if reverse else dst_var

    # start-side predicates always pushed (they define the initial frontier)
    if deferred.get(start_var):
        pushed[start_var] = deferred.pop(start_var)

    # end-vertex rules: equality -> push; inequality -> defer; range -> cost
    if deferred.get(end_var):
        push_list, defer_list = [], []
        tbl = tbl_of(end_var)
        for p in deferred[end_var]:
            if p.is_equality or p.op == "in":
                push_list.append(p)
            elif p.is_inequality:
                defer_list.append(p)
            else:  # range: compare push vs defer costs (§6.3)
                if cost_mod.should_push_range(g, tbl, p):
                    push_list.append(p)
                else:
                    defer_list.append(p)
        if push_list:
            pushed[end_var] = push_list
        if defer_list:
            deferred[end_var] = defer_list
        else:
            deferred.pop(end_var)

    # interior vertices / edges: equality+in pushed (columnar mask is cheap),
    # everything else deferred
    for var in list(deferred):
        if var in (start_var, end_var):
            continue
        push_list = [p for p in deferred[var] if p.is_equality or p.op == "in" or p.is_range]
        defer_list = [p for p in deferred[var] if not (p.is_equality or p.op == "in" or p.is_range)]
        if push_list:
            pushed.setdefault(var, []).extend(push_list)
        if defer_list:
            deferred[var] = defer_list
        else:
            deferred.pop(var)

    fetch = set(projected) | set(deferred)
    return PatternPlan(pattern, reverse, pushed, deferred, fetch)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

# Below this row count a vectorized column scan beats the posting-list
# machinery (binary probes + gathers carry fixed per-call overhead), so
# candidate sets fall back to the scan path on tiny labels.
MIN_INDEX_ROWS = 1024


def _candidate_set(g: Graph, pattern: Pattern, var: str,
                   preds: list[Predicate],
                   extra: Optional[np.ndarray] = None
                   ) -> Optional[tuple[str, np.ndarray]]:
    """M(v_p) after pushdown, as a tagged candidate set over the label's
    vid (or edge-tid) space: ``("rows", row_ids)`` when an index served the
    predicates (postings, no O(n) scan), ``("mask", bool_mask)`` from the
    scan path, or the ``None`` sentinel when the var carries no constraint
    at all — callers skip the all-true mask and its downstream
    intersections entirely (Lines 3-7 of Algorithm 2 with the §5.2
    pushdown modification). ``extra`` is a pre-computed candidate mask over
    the same space — the semi-join output of join pushdown (Eq. 9/10),
    intersected in.

    When the graph carries a composite (label, attr) index serving a
    pushed predicate (:mod:`repro_torch.core.index`), the candidate set is
    seeded from the index postings and the remaining predicates are
    point-evaluated on those rows only — no O(n) column scan."""
    if not preds and extra is None:
        return None
    is_edge = any(e.var == var for e in pattern.edges)
    tbl = g.edges if is_edge else g.vertex_tables[pattern.vertex(var).label]
    if preds:
        im = getattr(g, "_index_manager", None)
        rows = None
        rest = list(preds)
        if im is not None and tbl.nrows >= MIN_INDEX_ROWS:
            rest = []
            label = None if is_edge else pattern.vertex(var).label
            for p in preds:
                hit = im.lookup(g.name, p, label=label)
                if hit is None:
                    rest.append(p)
                    continue
                rows = hit if rows is None \
                    else np.intersect1d(rows, hit, assume_unique=True)
                traversal.COUNTERS.cpu_ops += len(hit)
        if rows is not None:
            # index-seeded: residual predicates touch the candidates only
            for p in rest:
                if len(rows):
                    rows = rows[tbl.eval_predicate(p, rows=rows)]
                traversal.COUNTERS.record_fetches += len(rows)
                traversal.COUNTERS.cpu_ops += len(rows)
            if extra is not None:
                rows = rows[extra[rows]]
            return ("rows", rows)
        mask: Optional[np.ndarray] = None
        for p in preds:
            m = tbl.eval_predicate(p)
            mask = m if mask is None else (mask & m)
            traversal.COUNTERS.record_fetches += tbl.nrows  # column scan
            traversal.COUNTERS.cpu_ops += tbl.nrows
        if extra is not None:
            mask = mask & extra
        return ("mask", mask)
    return ("mask", extra)


def _as_mask(cand: Optional[tuple[str, np.ndarray]],
             n: int) -> Optional[np.ndarray]:
    """Materialize a tagged candidate set as a boolean mask of length n."""
    if cand is None:
        return None
    kind, data = cand
    if kind == "mask":
        return data
    mask = np.zeros(n, dtype=bool)
    mask[data] = True
    return mask


@dataclasses.dataclass
class MatchState:
    """Prepared (pre-traversal) state of one pattern match: candidate/member
    masks, per-edge masks, and the start frontier. Splitting preparation from
    the hop loop lets the sharded executor run :func:`expand_chain` on
    contiguous blocks of ``start_nids`` — every path is seeded by exactly one
    start vertex and the hop loop preserves row order, so the block outputs
    concatenate to the serial result bit-for-bit."""

    plan: PatternPlan
    chain_vars: list
    edge_vars: list
    hop_vars: list
    hop_edges: list
    member_of: "callable"
    edge_mask: dict
    start_nids: np.ndarray

    def materialize_members(self) -> None:
        """Force every lazily-built member mask (call before fanning the hop
        loop out to worker threads — the memo is not thread-safe)."""
        for v in self.hop_vars[1:]:
            self.member_of(v)


def prepare_match(g: Graph, plan: PatternPlan,
                  extra_masks: Optional[dict] = None) -> MatchState:
    """Candidate-set construction + start-frontier seeding of Algorithm 2
    (everything before the hop loop)."""
    extra_masks = extra_masks or {}
    pattern = plan.pattern
    chain_vars = [pattern.vertices[0].var] + [e.dst for e in pattern.edges]
    edge_vars = [e.var for e in pattern.edges]

    hop_vars = list(chain_vars)
    hop_edges = list(edge_vars)
    if plan.reverse:
        hop_vars = hop_vars[::-1]
        hop_edges = hop_edges[::-1]

    # vertex candidate sets over the vid space; nid-space member masks are
    # materialized lazily (scatter through label_nids: with pending delta
    # vertices a label's nid set is its base block plus appended delta
    # nids, in merged-table row order) — and only for vars that actually
    # filter a hop. Index-seeded ("rows") start vars never pay the scatter.
    cand = {v: _candidate_set(g, pattern, v, plan.pushed.get(v, []),
                              extra_masks.get(v)) for v in chain_vars}
    member: dict[str, Optional[np.ndarray]] = {}

    def member_of(v: str) -> Optional[np.ndarray]:
        if v not in member:
            c = cand[v]
            if c is None:
                member[v] = None
            else:
                full = np.zeros(g.n_vertices, dtype=bool)
                if c[0] == "mask":
                    full[g.label_nids(pattern.vertex(v).label)] = c[1]
                else:   # vid rows -> nids (delta rows included)
                    full[g.nid_of(pattern.vertex(v).label, c[1])] = True
                member[v] = full
        return member[v]

    edge_mask: dict[str, Optional[np.ndarray]] = {
        e: _as_mask(_candidate_set(g, pattern, e, plan.pushed.get(e, [])),
                    g.edges.nrows) for e in edge_vars}

    # initial frontier (Line 9): candidates of the first hop var
    v0 = hop_vars[0]
    c0 = cand[v0]
    if c0 is None:
        start_nids = g.label_nids(pattern.vertex(v0).label)
    elif c0[0] == "rows":
        # frontier seeded straight from index postings — no full-label mask
        start_nids = np.atleast_1d(g.nid_of(pattern.vertex(v0).label, c0[1]))
    else:
        v0_nids = g.label_nids(pattern.vertex(v0).label)
        start_nids = v0_nids[c0[1]]

    return MatchState(plan, chain_vars, edge_vars, hop_vars, hop_edges,
                      member_of, edge_mask, start_nids)


def expand_chain(g: Graph, st: MatchState,
                 start_nids: np.ndarray) -> dict[str, np.ndarray]:
    """The hop loop of Algorithm 2 over a given start frontier. Returns the
    graph-relation columns (vertex vars -> vids, edge vars -> edge tids),
    rows in start-major order. Deferred predicates are NOT applied here."""
    plan, pattern = st.plan, st.plan.pattern
    paths_v = [np.asarray(start_nids)]  # per-var nid columns, in hop order
    paths_e: list[np.ndarray] = []      # per-edge tid columns

    for evar, nvar in zip(st.hop_edges, st.hop_vars[1:]):
        frontier = paths_v[-1]
        # base ⊕ delta expansion (tombstoned edges already filtered)
        row_rep, dst, eid = g.expand(frontier, reverse=plan.reverse)
        total = len(dst)
        traversal.COUNTERS.cpu_ops += total + len(frontier)

        # build the hop filter lazily: unconstrained hops never allocate
        # (or intersect) an all-true mask
        keep = None
        nmask = st.member_of(nvar)
        if nmask is not None:
            keep = nmask[dst]
            traversal.COUNTERS.cpu_ops += total
        elif len(g.labels) > 1:
            # label constraint: dst must carry nvar's label
            keep = (g.vertex_label_code[dst]
                    == g.label_code_of(pattern.vertex(nvar).label))
        if st.edge_mask[evar] is not None:
            em = st.edge_mask[evar][eid]
            keep = em if keep is None else (keep & em)
            traversal.COUNTERS.cpu_ops += total

        if keep is not None:
            row_rep, dst, eid = row_rep[keep], dst[keep], eid[keep]
        paths_v = [c[row_rep] for c in paths_v]
        paths_e = [c[row_rep] for c in paths_e]
        paths_v.append(dst)
        paths_e.append(eid)

    if plan.reverse:
        paths_v = paths_v[::-1]
        paths_e = paths_e[::-1]

    cols: dict[str, np.ndarray] = {}
    for var, col in zip(st.chain_vars, paths_v):
        cols[var] = g.vids_of(col)  # store vids (label-local) in the graph-relation
    for evar, col in zip(st.edge_vars, paths_e):
        cols[evar] = col
    return cols


def match(g: Graph, plan: PatternPlan,
          extra_masks: Optional[dict] = None) -> Table:
    """Execute P(G, P): returns the graph-relation as a Table with one column
    per pattern var — vertex columns hold vids, edge columns hold edge tids.
    ``extra_masks`` maps vertex vars to semi-join candidate masks (join
    pushdown inputs, supplied as explicit plan edges by the physical DAG)."""
    st = prepare_match(g, plan, extra_masks)
    cols = expand_chain(g, st, st.start_nids)
    rel = Table(f"match:{plan.pattern.graph}", cols)

    # deferred predicate evaluation on the graph-relation (Cost_prop, Eq. 13)
    return apply_deferred(g, plan.pattern, rel, plan.deferred)


def apply_deferred(g: Graph, pattern: Pattern, rel: Table, deferred: dict) -> Table:
    """Evaluate deferred predicates on a materialized graph-relation."""
    edge_vars = [e.var for e in pattern.edges]
    if not deferred or not rel.nrows:
        return rel
    mask = np.ones(rel.nrows, dtype=bool)
    for var, preds in deferred.items():
        is_edge = var in edge_vars
        tbl = g.edges if is_edge else g.vertex_tables[pattern.vertex(var).label]
        ids = np.asarray(rel.col(var))
        traversal.COUNTERS.record_fetches += len(ids) * len(preds)
        for p in preds:
            if len(ids) < tbl.nrows:
                # fewer bindings than records: point-evaluate on the
                # referenced rows instead of scanning the whole column
                mask &= tbl.eval_predicate(p, rows=ids)
            else:
                mask &= tbl.eval_predicate(p)[ids]
            traversal.COUNTERS.cpu_ops += len(ids)
    return rel.take(np.nonzero(mask)[0])


# ---------------------------------------------------------------------------
# Shortest-path search (topology-only GraphAM; powers M2Bench G6-G8)
# ---------------------------------------------------------------------------


def shortest_path_lengths(g: Graph, src_nids: np.ndarray, dst_nids: np.ndarray,
                          max_hops: int = 64) -> np.ndarray:
    """Multi-source BFS over the CSR topology (no record access — the pure
    topology-driven mode the hybrid operator also supports). Returns hop
    distance per (src, dst) pair, -1 if unreachable."""
    src_nids = np.asarray(src_nids)
    dst_nids = np.asarray(dst_nids)
    out = np.full(len(src_nids), -1, dtype=np.int32)
    # group by src to share BFS frontiers
    uniq, inv = np.unique(src_nids, return_inverse=True)
    for i, s in enumerate(uniq):
        dist = np.full(g.n_vertices, -1, dtype=np.int32)
        dist[s] = 0
        frontier = np.array([s])
        for h in range(1, max_hops + 1):
            _, nxt, _ = g.expand(frontier)
            nxt = np.unique(nxt)
            nxt = nxt[dist[nxt] < 0]
            if len(nxt) == 0:
                break
            dist[nxt] = h
            frontier = nxt
        sel = inv == i
        out[sel] = dist[dst_nids[sel]]
    return out
