"""Cost-based optimizer: stats-driven rewrites of the physical operator DAG.

Sits between the planner and the executor. ``planner.plan`` makes the
*logical* decisions (predicate assignment and pushdown, match trimming,
projection trimming), ``physical.build_gcdi`` lowers them to a *naive* DAG
(clusters join in query order, graph↔table joins stay post-match), and
:func:`optimize` is the single physical rewrite pass:

1. **Selection sink-down** — residual σ predicates move below the joins,
   into the ``Select`` above the owning ``ScanTable`` (or onto the graph
   cluster), so joins see fewer rows.
2. **Column pruning** — base-table columns never referenced above the scan
   (projection, join keys, residual predicates) are dropped right after the
   pushed selections (projection sink-down into the scan).
3. **Join enumeration with semi-join siding (Eq. 8 → 9/10)** — a
   Selinger-style dynamic program over the connected subsets of the join
   graph (≤ :data:`MAX_DP_RELATIONS` relations; greedy
   smallest-intermediate-first above) produces **bushy** ``EquiJoin`` trees
   costed with distribution-aware join cardinalities
   (``physical.est_join_rows``: per-key / per-bucket overlap of the two key
   distributions, NDV containment only as fallback). The §6.3 semi-join
   siding choices — post-match equi-join vs. graph-side ``SemiJoinMask``
   vs. table-side ``SemiJoinReduce`` — are enumerated *inside* the same
   search (every siding configuration gets its own enumeration and the
   cheapest whole plan wins), not greedily in a separate pass. The smaller
   side of every join becomes the build (right) side of the sort-merge.
4. **Common-subexpression elimination** — structurally identical subtrees
   (equal node signatures) collapse to one shared node, so the DAG walks,
   caches, and reports them once.

All rewrites are plan-equivalence preserving: selections and semi-joins
commute with equi-joins, and equi-joins commute/associate. The estimates
come from the live column statistics (NDV, equi-width histograms, MCV
counts) via :func:`physical.estimate`; a caller-held estimate cache is
keyed on the catalog's write-epoch snapshot, so estimates cached across
queries are invalidated by any delta-store append.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from . import cost as cost_mod
from . import physical as ph
from . import verify as verify_mod
from .planner import _graph_join_side
from .storage import Database

MAX_DP_RELATIONS = 8     # DP over connected subsets up to this many leaves
MAX_SIDING_ENUM = 3      # joint 3^k siding enumeration up to k candidates
MAX_CACHE_ENTRIES = 50_000   # estimate-cache size backstop

DEVICE_MATCH = True              # consider device access paths for patterns
DEVICE_MAX_FRONTIER = float(1 << 18)   # skip device lowering past this peak


@dataclasses.dataclass
class OptReport:
    """What the rewrite pass did, plus the §6.3 cost totals before/after."""

    rewrites: list = dataclasses.field(default_factory=list)
    est_cost_before: float = 0.0
    est_cost_after: float = 0.0

    def add(self, rule: str, detail: str) -> None:
        self.rewrites.append(f"{rule}: {detail}")

    def notes(self) -> list:
        out = list(self.rewrites)
        out.append(f"est_cost {self.est_cost_before:.3g} -> "
                   f"{self.est_cost_after:.3g}")
        return out

    def rule_counts(self) -> dict:
        """Rewrites applied per rule name — what the engine feeds into its
        ``optimizer.rewrites.<rule>`` telemetry counters."""
        counts: dict[str, int] = {}
        for note in self.rewrites:
            rule = note.split(":", 1)[0].strip().replace(" ", "_")
            counts[rule] = counts.get(rule, 0) + 1
        return counts


def optimize(root: ph.PhysicalOp, db: Database, cache: Optional[dict] = None,
             join_enum: str = "dp") -> tuple[ph.PhysicalOp, OptReport]:
    """Rewrite a physical DAG (GCDI or full GCDIA) against the §6.3 cost
    model. Returns ``(new_root, report)``; the input DAG is not mutated.

    ``cache`` may be a caller-held estimate memo reused across calls (the
    engine keeps one per instance); it is keyed on the catalog write-epoch
    snapshot and cleared whenever any source collection mutated, so stale
    cardinalities can never steer a plan. ``join_enum`` selects the
    enumerator: ``"dp"`` (bushy Selinger DP, the default), ``"dp-leftdeep"``
    (DP restricted to left-deep trees — the measurable baseline), or
    ``"greedy"`` (smallest-intermediate-first)."""
    report = OptReport()
    if cache is None:
        cache = {}
    # snapshot = every collection's write epoch + the join-estimate model
    # toggle: node signatures embed the epochs but not HIST_JOIN_EST, so a
    # flag flip must also drop estimates cached under the other model
    snap = (ph.catalog_epochs(db), ph.HIST_JOIN_EST)
    if cache.get("__catalog__") != snap or len(cache) > MAX_CACHE_ENTRIES:
        cache.clear()
        cache["__catalog__"] = snap
    report.est_cost_before = _est_cost(root, db, cache)
    proj = _find_kind(root, ph.Project)
    if proj is not None and getattr(proj, "logical", None) is not None:
        new_proj = _optimize_gcdi(proj, db, report, cache, join_enum)
        if new_proj is not proj:
            root = _replace(root, {id(proj): new_proj})
    root, merged = _cse(root)
    if merged:
        report.add("cse", f"unified {merged} duplicate subtree(s)")
    report.est_cost_after = _est_cost(root, db, cache)
    # refresh the schema annotations the rewrites invalidated (pruned
    # columns, re-sided semi-joins, replaced access paths)
    verify_mod.annotate_out_cols(root, db)
    return root, report


# ---------------------------------------------------------------------------
# DAG surgery helpers
# ---------------------------------------------------------------------------


def _find_kind(node: ph.PhysicalOp, cls) -> Optional[ph.PhysicalOp]:
    if isinstance(node, cls):
        return node
    for c in node.children:
        hit = _find_kind(c, cls)
        if hit is not None:
            return hit
    return None


def _replace(node: ph.PhysicalOp, mapping: dict) -> ph.PhysicalOp:
    """Memoized rebuild substituting ``mapping[id(old)] -> new`` subtrees;
    shared nodes stay shared."""
    memo = dict(mapping)

    def walk(n: ph.PhysicalOp) -> ph.PhysicalOp:
        if id(n) in memo:
            return memo[id(n)]
        kids = tuple(walk(c) for c in n.children)
        out = n if all(a is b for a, b in zip(kids, n.children)) \
            else n.with_children(*kids)
        memo[id(n)] = out
        return out

    return walk(node)


def _cse(root: ph.PhysicalOp) -> tuple[ph.PhysicalOp, int]:
    """Collapse structurally identical subtrees (same signature) into one
    shared node instance, bottom-up. Already-shared nodes are walked once
    (per-object memo), so ``merged`` counts genuine duplicates only."""
    seen: dict = {}     # signature -> canonical node
    memo: dict = {}     # id(original) -> rewritten/canonical node
    merged = 0

    def walk(n: ph.PhysicalOp) -> ph.PhysicalOp:
        nonlocal merged
        if id(n) in memo:
            return memo[id(n)]
        kids = tuple(walk(c) for c in n.children)
        cand = n if all(a is b for a, b in zip(kids, n.children)) \
            else n.with_children(*kids)
        sig = cand.signature()
        if sig in seen:
            if seen[sig] is not cand:
                merged += 1
            cand = seen[sig]
        else:
            seen[sig] = cand
        memo[id(n)] = cand
        return cand

    return walk(root), merged


def _est_rows(node: ph.PhysicalOp, db: Database, cache: dict) -> float:
    return ph.estimate(node, db, _cache=cache)[id(node)][0]


def _est_cost(node: ph.PhysicalOp, db: Database, cache: dict) -> float:
    return ph.estimate(node, db, _cache=cache)[id(node)][1]


# ---------------------------------------------------------------------------
# The GCDI rewrite pipeline (runs on the Project subtree)
# ---------------------------------------------------------------------------


def _optimize_gcdi(proj: ph.PhysicalOp, db: Database, report: OptReport,
                   cache: dict, join_enum: str) -> ph.PhysicalOp:
    p = proj.logical
    q = p.query
    pattern = q.match

    node = proj.children[0]
    residual = []
    if isinstance(node, ph.Residual):
        residual = list(node.preds)
        node = node.children[0]

    # -- extract the join tree: cluster leaves + the full join predicate set
    leaves: list[ph.PhysicalOp] = []

    def collect(n: ph.PhysicalOp) -> None:
        if isinstance(n, (ph.EquiJoin, ph.IntraFilter)):
            for c in n.children:
                collect(c)
        else:
            leaves.append(n)

    collect(node)

    # -- pass 1: selection sink-down --------------------------------------
    leaves, residual = _sink_selections(leaves, residual, report)

    # -- pass 2: column pruning (projection sink-down into the scans) ------
    leaves = _prune_columns(leaves, db, q, residual, report)

    # -- pass 2b: cost-based access-path selection per table scan ----------
    leaves = _select_access_paths(leaves, db, report)

    # -- pass 3+4: join enumeration with semi-join siding inside ----------
    cands = []
    if pattern is not None and p.semi_join_idx:
        cands = _siding_candidates(leaves, db, p)
    if len(cands) > MAX_SIDING_ENUM:
        # too many candidates for the joint 3^k sweep: decide each siding
        # greedily against the all-post plan, then enumerate the join order
        leaves = _side_semi_joins(leaves, db, p, report, cache)
        cands = []

    best = None     # (cost, config, root, notes)
    costs: dict[tuple, float] = {}
    for config in itertools.product(SIDINGS, repeat=len(cands)):
        leaves_v = _apply_siding(leaves, cands, config, db, p)
        current, order, bushy = _enumerate_joins(
            leaves_v, db, q, pattern, residual, cache, join_enum)
        cost = _est_cost(current, db, cache)
        costs[config] = cost
        if best is None or cost < best[0]:
            best = (cost, config, current, order, bushy)

    cost, config, current, order, bushy = best
    for cand, choice in zip(cands, config):
        alt = costs.get(config[:cand["pos"]] + ("post",)
                        + config[cand["pos"] + 1:], cost)
        jp = cand["jp"]
        if choice == "mask":
            report.add("semi-join", f"join#{cand['i']} ({jp}): graph-side "
                       f"mask on {cand['vvar']} — plan cost {cost:.3g} < "
                       f"post-match {alt:.3g}")
        elif choice == "reduce":
            report.add("semi-join", f"join#{cand['i']} ({jp}): table-side "
                       f"reduce of {cand['tcoll']} — plan cost {cost:.3g} < "
                       f"post-match {alt:.3g}")
        else:
            others = [c for cfg, c in costs.items()
                      if cfg[cand["pos"]] != "post"]
            detail = f" (cost {cost:.3g} <= {min(others):.3g})" if others else ""
            report.add("semi-join",
                       f"join#{cand['i']} ({jp}): kept post-match{detail}")
    if order is not None and (bushy or list(order) != sorted(order)):
        shape = "bushy " if bushy else ""
        report.add("join-order", f"{join_enum} {shape}{list(order)} "
                                 f"(query order {sorted(order)})")

    _annotate_match_access(current, db)
    current = _select_match_path(current, db, report, cache)
    if residual:
        current = ph.Residual(residual, current)
    return proj.with_children(current)


def _leaf_cols(leaf: ph.PhysicalOp) -> frozenset:
    return getattr(leaf, "out_cols", frozenset())


def _table_leaf(leaf: ph.PhysicalOp) -> Optional[ph.Alias]:
    return leaf if isinstance(leaf, ph.Alias) else None


def _sink_selections(leaves: list, residual: list, report: OptReport
                     ) -> tuple[list, list]:
    """Move residual σ predicates below the joins: into the Select above the
    owning table scan, or as a filter on the owning cluster."""
    leaves = list(leaves)
    kept: list = []
    for pred in residual:
        target = None
        for li, leaf in enumerate(leaves):
            if ph._static_has_col(_leaf_cols(leaf), pred.attr):
                target = li
                break
        if target is None:
            kept.append(pred)
            continue
        leaf = leaves[target]
        alias = _table_leaf(leaf)
        if alias is not None and pred.collection == alias.name:
            inner = alias.children[0]
            if isinstance(inner, ph.Select):
                inner = ph.Select(inner.children[0], list(inner.preds) + [pred])
            else:
                inner = ph.Select(inner, [pred])
            new_leaf = alias.with_children(inner)
            report.add("sink-down", f"{pred!r} -> Select[{alias.name}]")
        else:
            new_leaf = ph.Residual([pred], leaf)
            new_leaf.out_cols = _leaf_cols(leaf)
            report.add("sink-down", f"{pred!r} -> {leaf.kind} cluster")
        leaves[target] = new_leaf
    return leaves, kept


# ---------------------------------------------------------------------------
# Access-path selection (index / zone skip-scan / full scan), per table leaf
# ---------------------------------------------------------------------------


def _select_access_paths(leaves: list, db: Database,
                         report: OptReport) -> list:
    """Cost-compare the three access paths of every ``Select``-over-
    ``ScanTable`` leaf — posting-list :class:`~repro_torch.core.physical.IndexScan`,
    zone-map :class:`~repro_torch.core.physical.IndexSelect` skip-scan, and the
    full scan — using the existing ``ColumnStats`` selectivities and the
    live zone-map candidate fractions. The cheapest replaces the pair; the
    decision is recorded as ``access=`` provenance either way (rendered by
    ``explain``/``explain_last``)."""
    im = getattr(db, "_index_manager", None)
    leaves = list(leaves)
    for li, leaf in enumerate(leaves):
        alias = _table_leaf(leaf)
        if alias is None or alias.name not in db.tables:
            continue
        top = alias.children[0]
        prune = top if isinstance(top, ph.PruneCols) else None
        node = prune.children[0] if prune is not None else top
        if isinstance(node, ph.ScanTable):
            node.access = "full-scan"
            continue
        if not (isinstance(node, ph.Select)
                and isinstance(node.children[0], ph.ScanTable)):
            continue
        sel_node, scan = node, node.children[0]
        tbl = db.tables[alias.name]
        n = float(tbl.nrows)
        preds = sel_node.preds
        sels = [tbl.stats(p.column).selectivity(p) for p in preds]
        cost_full = cost_mod.cost_scan(n) + cost_mod.cost_filter(n, len(preds))
        best = ("full-scan", cost_full, None)
        for i, p in enumerate(preds):
            if im is None:
                break
            idx = im.get(alias.name, p.column)
            if idx is None:
                continue
            hits = n * sels[i]
            # residual predicates point-evaluate on the picked pred's hits
            rest = (cost_mod.cost_filter(hits, len(preds) - 1)
                    if len(preds) > 1 else 0.0)
            if idx.serves(p.op):
                c = cost_mod.cost_index_lookup(n, hits) + rest
                if c < best[1]:
                    best = (idx.kind, c, i)
            frac = idx.zone_fraction(p)
            if frac is not None:
                c = cost_mod.cost_zone_scan(
                    n, frac, idx.zones.n_chunks if idx.zones else 0.0) + rest
                if c < best[1]:
                    best = ("zone", c, i)
        access, c, i = best
        if i is None:
            sel_node.access = "full-scan"
            scan.access = "full-scan"
            continue
        if access == "zone":
            new_node = ph.IndexSelect(alias.name, scan.epoch, preds, i)
        else:
            new_node = ph.IndexScan(alias.name, scan.epoch, preds, i, access)
        rebuilt = (prune.with_children(new_node) if prune is not None
                   else new_node)
        leaves[li] = alias.with_children(rebuilt)
        report.add("access-path",
                   f"{alias.name}: {access} on {preds[i]!r} "
                   f"(cost {c:.3g} < full scan {cost_full:.3g})")
    return leaves


def _annotate_match_access(root: ph.PhysicalOp, db: Database) -> None:
    """Record (as ``access=`` provenance) whether the pattern's pushed
    predicates will seed candidate sets from the graph's composite
    (label, attr) indexes at match time — mirroring the runtime check in
    ``pattern._candidate_set`` (including its MIN_INDEX_ROWS floor)."""
    mp = _find_kind(root, ph.MatchPattern)
    if mp is None or mp.pplan is None:
        return
    from . import pattern as pattern_mod
    im = getattr(db, "_index_manager", None)
    served = []
    if im is not None:
        g = db.graphs[mp.graph]
        pat = mp.pplan.pattern
        edge_vars = {e.var for e in pat.edges}
        for var, ps in sorted(mp.pplan.pushed.items()):
            label = None if var in edge_vars else pat.vertex(var).label
            tbl = g.edges if label is None else g.vertex_tables[label]
            if tbl.nrows < pattern_mod.MIN_INDEX_ROWS:
                continue    # runtime falls back to the vectorized scan
            if any((idx := im.get(mp.graph, pr.column, label=label)) is not None
                   and idx.serves(pr.op) for pr in ps):
                served.append(var)
    mp.access = f"index-seed[{','.join(served)}]" if served else "mask-scan"


def _select_match_path(root: ph.PhysicalOp, db: Database, report: OptReport,
                       cache: dict) -> ph.PhysicalOp:
    """Third access path for pattern matching: cost-compare the host matcher
    (``pattern.match``) against the device flavors — the fused traversal-kernel chain
    (zone-filtered predicate tables, one end-of-chain sync) and the per-hop
    jit matcher — and lower the MatchPattern to a ``DeviceMatchPattern``
    when a device plan wins. Only mask-free chain patterns on settled
    (no-pending-delta) graphs qualify; the frontier-size estimate gates out
    patterns whose padded capacity would not fit the static-shape budget."""
    if not DEVICE_MATCH:
        return root
    mp = _find_kind(root, ph.MatchPattern)
    if (mp is None or mp.pplan is None or mp.children
            or not mp.pplan.pattern.edges or not mp.pplan.pattern.is_chain):
        return root
    g = db.graphs.get(mp.graph)
    if g is None or g.delta.has_pending():
        return root
    p = mp.pplan
    # peak padded-frontier estimate across hops (pre-predicate expansion —
    # the kernel's capacity must hold every candidate before compaction);
    # shared with the static plan verifier, which re-derives the same bound
    peak = cost_mod.device_frontier_peak(g, p)
    if peak > DEVICE_MAX_FRONTIER:
        report.add("access-path", f"{mp.graph}: pattern stays on host "
                   f"matcher (est peak frontier {peak:.3g} exceeds device "
                   f"budget {DEVICE_MAX_FRONTIER:.3g})")
        return root
    cap = cost_mod.padded_capacity(peak)
    cost_host = _est_cost(mp, db, cache)
    best = None
    for access in ("device-pallas", "device-jit"):
        # the node embeds the graph's *catalog* write epoch (base + lineage
        # carry), matching MatchPattern — g.epoch alone diverges after a
        # graph is replaced via db.add_graph and would collide signatures
        # across the replacement
        dm = ph.DeviceMatchPattern(mp.graph, db.epoch_of(mp.graph), p,
                                   access=access, capacity=cap)
        c = _est_cost(dm, db, cache)
        if best is None or c < best[0]:
            best = (c, dm)
    c, dm = best
    if c < cost_host:
        report.add("access-path",
                   f"{mp.graph}: {dm.access} pattern match, capacity={cap} "
                   f"(cost {c:.3g} < host {cost_host:.3g})")
        return _replace(root, {id(mp): dm})
    report.add("access-path", f"{mp.graph}: pattern stays on host matcher "
               f"(cost {cost_host:.3g} <= device {c:.3g})")
    return root


def _needed_columns(q, coll: str, residual: list) -> set:
    """Bare column names of ``coll`` referenced above its scan."""
    need: set = set()
    for a in q.select:
        c, _, col = a.partition(".")
        if c == coll and col:
            need.add(col)
    for jp in q.joins:
        for side in (jp.left, jp.right):
            c, _, col = side.partition(".")
            if c == coll and col:
                need.add(col)
    for pred in residual:
        if pred.collection == coll:
            need.add(pred.column)
    return need


def _prune_columns(leaves: list, db: Database, q, residual: list,
                   report: OptReport) -> list:
    leaves = list(leaves)
    for li, leaf in enumerate(leaves):
        alias = _table_leaf(leaf)
        if alias is None or alias.name not in db.tables:
            continue
        have = set(db.tables[alias.name].columns)
        need = _needed_columns(q, alias.name, residual) & have
        if not need or need >= have:
            continue
        pruned = ph.PruneCols(alias.children[0], tuple(sorted(need)))
        leaves[li] = alias.with_children(pruned)
        # with_children carried the full-table out_cols over — narrow the
        # annotation to the surviving columns or downstream passes (and the
        # verifier's V-ANN check) see a stale schema
        leaves[li].out_cols = frozenset(f"{alias.name}.{c}" for c in need)
        report.add("prune", f"{alias.name}: keep {sorted(need)} "
                            f"of {len(have)} column(s)")
    return leaves


# ---------------------------------------------------------------------------
# Semi-join siding (Eq. 8 -> 9/10), enumerated jointly with the join order
# ---------------------------------------------------------------------------

SIDINGS = ("post", "mask", "reduce")


def _siding_candidates(leaves: list, db: Database, p) -> list[dict]:
    """Resolve each Eq. 9/10 candidate graph↔table join to its leaves: the
    table leaf to reduce / feed the mask from, and the pattern var to mask."""
    q = p.query
    pattern = q.match
    vset = {v.var for v in pattern.vertices}
    graph_i = next((i for i, l in enumerate(leaves)
                    if _find_kind(l, ph.MatchPattern) is not None), None)
    if graph_i is None:
        return []
    out: list[dict] = []
    for i in sorted(p.semi_join_idx):
        jp = q.joins[i]
        side = _graph_join_side(q, vset, jp)
        if side is None:
            continue
        tbl_attr, var_attr = side
        tcoll, tcol = tbl_attr.split(".", 1)
        vvar, vcol = var_attr.split(".", 1)
        tbl_i = next((ti for ti, l in enumerate(leaves)
                      if _table_leaf(l) is not None
                      and _table_leaf(l).name == tcoll), None)
        if tbl_i is None:
            continue
        out.append({"pos": len(out), "i": i, "jp": jp, "vvar": vvar,
                    "vcol": vcol, "tcoll": tcoll, "tcol": tcol,
                    "label": pattern.vertex(vvar).label,
                    "graph_i": graph_i, "tbl_i": tbl_i})
    return out


def _apply_siding(leaves: list, cands: list, config: tuple, db: Database,
                  p) -> list:
    """Build the leaf set for one siding configuration. Mask children are
    the *same* table subtree objects that feed the final equi-joins, so the
    dedup-aware cumulative cost (and later CSE) charges them once."""
    if not cands:
        return leaves
    leaves_v = list(leaves)
    pattern = p.query.match
    gname = pattern.graph
    gep = db.epoch_of(gname)
    orig_subtrees = {c["tbl_i"]: leaves[c["tbl_i"]].children[0]
                     for c in cands}
    masks: list[tuple[str, ph.PhysicalOp]] = []
    for cand, choice in zip(cands, config):
        if choice == "mask":
            mask = ph.SemiJoinMask(gname, gep, cand["label"], cand["vcol"],
                                   cand["tcol"], orig_subtrees[cand["tbl_i"]])
            mask.ocol_src = ("table", cand["tcoll"], cand["tcol"])
            masks.append((cand["vvar"], mask))
        elif choice == "reduce":
            alias = leaves_v[cand["tbl_i"]]
            reduce_node = ph.SemiJoinReduce(gname, gep, cand["label"],
                                            cand["vcol"], cand["tcol"],
                                            alias.children[0])
            reduce_node.ocol_src = ("table", cand["tcoll"], cand["tcol"])
            leaves_v[cand["tbl_i"]] = alias.with_children(reduce_node)
    if masks:
        gi = cands[0]["graph_i"]
        mp = _find_kind(leaves_v[gi], ph.MatchPattern)
        mp_new = mp.with_children(*mp.children, *(m for _, m in masks))
        mp_new.mask_vars = tuple(mp.mask_vars) + tuple(v for v, _ in masks)
        leaves_v[gi] = _replace(leaves_v[gi], {id(mp): mp_new})
    return leaves_v


# ---------------------------------------------------------------------------
# Join enumeration: Selinger DP over connected subsets (bushy), greedy
# fallback for large join graphs
# ---------------------------------------------------------------------------


def _enumerate_joins(leaves: list, db: Database, q, pattern, residual: list,
                     cache: dict, join_enum: str
                     ) -> tuple[ph.PhysicalOp, Optional[list], bool]:
    """Re-merge the join clusters. Returns ``(root, order, bushy)`` where
    ``order`` is the applied join-predicate sequence (None when nothing was
    enumerated) and ``bushy`` flags a tree with composite inputs on both
    sides of some join."""
    clusters = [{"node": leaf, "cols": set(_leaf_cols(leaf)),
                 "rows": _est_rows(leaf, db, cache)} for leaf in leaves]
    pending = [(i, jp, (ph._key_source(q, pattern, jp.left),
                        ph._key_source(q, pattern, jp.right)))
               for i, jp in enumerate(q.joins)]
    order: list[int] = []

    def find(attr: str) -> Optional[int]:
        for ci, c in enumerate(clusters):
            if ph._static_has_col(c["cols"], attr):
                return ci
        return None

    def apply_intra(ci: int) -> None:
        """Fold every pending predicate now internal to cluster ``ci``."""
        for item in list(pending):
            i, jp, ks = item
            li, ri = find(jp.left), find(jp.right)
            if li == ri == ci:
                node = ph.IntraFilter(jp, clusters[ci]["node"])
                node.key_src = ks
                ls, rs = (ph.resolve_key_stats(db, src) for src in ks)
                clusters[ci]["node"] = node
                clusters[ci]["rows"] = ph.est_intra_filter_rows(
                    clusters[ci]["rows"], ls, rs)
                pending.remove(item)
                order.append(i)

    for ci in range(len(clusters)):
        apply_intra(ci)

    if pending and join_enum != "greedy" and len(clusters) <= MAX_DP_RELATIONS:
        return _dp_joins(clusters, pending, db, q, residual, cache, order,
                         leftdeep=(join_enum == "dp-leftdeep"))
    return _greedy_joins(clusters, pending, db, q, residual, cache, order,
                         find, apply_intra)


def _greedy_joins(clusters, pending, db, q, residual, cache, order,
                  find, apply_intra) -> tuple[ph.PhysicalOp, list, bool]:
    """Greedy smallest-intermediate-first re-merge of the join clusters —
    the fallback above :data:`MAX_DP_RELATIONS` (and ``join_enum="greedy"``)."""
    while pending:
        best = None
        for item in pending:
            i, jp, ks = item
            li, ri = find(jp.left), find(jp.right)
            if li is None or ri is None or li == ri:
                continue
            ls, rs = (ph.resolve_key_stats(db, s) for s in ks)
            est = ph.est_join_rows(clusters[li]["rows"], clusters[ri]["rows"],
                                   ls, rs)
            if best is None or (est, i) < (best[0], best[1]):
                best = (est, i, item, li, ri)
        if best is None:
            break   # remaining predicates span unreachable clusters
        est, i, item, li, ri = best
        _, jp, ks = item
        pending.remove(item)
        lc, rc = clusters[li], clusters[ri]
        # build-side selection: the smaller estimated input becomes the
        # right (sorted/build) side of the sort-merge equi-join
        if lc["rows"] < rc["rows"]:
            jp = type(jp)(jp.right, jp.left)
            ks = (ks[1], ks[0])
            lc, rc = rc, lc
        join = ph.EquiJoin(jp, lc["node"], rc["node"])
        join.key_src = ks
        keep, drop = min(li, ri), max(li, ri)
        clusters[keep] = {"node": join, "cols": lc["cols"] | rc["cols"],
                          "rows": est}
        del clusters[drop]
        order.append(i)
        apply_intra(keep)

    if len(clusters) > 1:
        # same covering rule as build_gcdi, including its loud failure on a
        # genuinely disconnected query — clusters are never dropped silently
        current = ph.pick_connected_cluster(
            [(c["node"], c["cols"]) for c in clusters],
            list(q.select) + [pr.attr for pr in residual])
    else:
        current = clusters[0]["node"]
    return current, order, False


def _dp_joins(clusters, pending, db, q, residual, cache, order,
              leftdeep: bool) -> tuple[ph.PhysicalOp, list, bool]:
    """Selinger-style DP over connected subsets of the join graph. Each
    subset keeps its cheapest plan; splits without a connecting predicate
    are skipped (no cross products), so only *connected* subsets fill in —
    a genuinely disconnected query falls back to build_gcdi's covering
    rule per component. With ``leftdeep`` the splits are restricted to
    (composite, single-leaf), which yields the best left-deep plan — the
    baseline the bushy enumerator is measured against."""
    n = len(clusters)

    def leaf_of(attr: str) -> Optional[int]:
        for ci, c in enumerate(clusters):
            if ph._static_has_col(c["cols"], attr):
                return ci
        return None

    edges = []          # (pred idx, jp, key_src, left leaf, right leaf)
    for (i, jp, ks) in pending:
        li, ri = leaf_of(jp.left), leaf_of(jp.right)
        if li is None or ri is None or li == ri:
            continue    # unresolvable predicate: same outcome as greedy
        edges.append((i, jp, ks, li, ri))

    best: dict[int, dict] = {}
    for ci, c in enumerate(clusters):
        best[1 << ci] = {"node": c["node"], "rows": c["rows"],
                         "cost": _est_cost(c["node"], db, cache),
                         "cols": c["cols"], "joins": (), "bushy": False}

    full = (1 << n) - 1
    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0:
            continue                        # singleton
        low = mask & -mask
        # canonical split walk: s1 always contains the lowest bit of mask,
        # so each unordered (s1, s2) pair is visited exactly once
        s1 = (mask - 1) & mask
        while s1:
            s2 = mask ^ s1
            if (s1 & low) and (not leftdeep
                               or bin(s1).count("1") == 1
                               or bin(s2).count("1") == 1):
                e1, e2 = best.get(s1), best.get(s2)
                if e1 is not None and e2 is not None:
                    conn = [(i, jp, ks, li, ri) for (i, jp, ks, li, ri)
                            in edges
                            if ((1 << li) & s1 and (1 << ri) & s2)
                            or ((1 << ri) & s1 and (1 << li) & s2)]
                    if conn:
                        cand = _join_entry(e1, e2, conn, s1, s2, db, cache)
                        if mask not in best \
                                or cand["cost"] < best[mask]["cost"]:
                            best[mask] = cand
            s1 = (s1 - 1) & mask

    if full in best:
        entry = best[full]
        return entry["node"], order + list(entry["joins"]), entry["bushy"]

    # disconnected join graph: resolve each connected component, then keep
    # the component covering the projection (build_gcdi's loud covering rule)
    comps = _components(n, edges)
    parts = []
    for comp in comps:
        entry = best.get(comp)
        if entry is not None:
            parts.append((entry["node"], entry["cols"]))
    current = ph.pick_connected_cluster(
        parts, list(q.select) + [pr.attr for pr in residual])
    for comp in comps:
        entry = best.get(comp)
        if entry is not None and entry["node"] is current:
            order = order + list(entry["joins"])
    return current, order, any(best[c]["bushy"] for c in comps if c in best)


def _join_entry(e1: dict, e2: dict, conn: list, s1: int, s2: int,
                db: Database, cache: dict) -> dict:
    """Combine two DP entries across their connecting predicates: the most
    selective predicate becomes the EquiJoin, the rest fold in as
    IntraFilters on top (exactly what the executor runs)."""
    cands = []
    for (i, jp, ks, li, ri) in conn:
        if not ((1 << li) & s1):            # orient: left attr lives in e1
            jp = type(jp)(jp.right, jp.left)
            ks = (ks[1], ks[0])
        ls, rs = (ph.resolve_key_stats(db, s) for s in ks)
        est = ph.est_join_rows(e1["rows"], e2["rows"], ls, rs)
        cands.append((est, i, jp, ks))
    cands.sort(key=lambda t: (t[0], t[1]))
    est, i0, jp0, ks0 = cands[0]
    l, r = e1, e2
    if l["rows"] < r["rows"]:               # build side = smaller input
        jp0 = type(jp0)(jp0.right, jp0.left)
        ks0 = (ks0[1], ks0[0])
        l, r = r, l
    node = ph.EquiJoin(jp0, l["node"], r["node"])
    node.key_src = ks0
    rows = est
    cost = e1["cost"] + e2["cost"] + cost_mod.cost_join(l["rows"], r["rows"])
    applied = [i0]
    for (_, i, jp, ks) in sorted(cands[1:], key=lambda t: t[1]):
        node = ph.IntraFilter(jp, node)
        node.key_src = ks
        ls2, rs2 = (ph.resolve_key_stats(db, src) for src in ks)
        cost += cost_mod.cost_filter(rows)
        rows = ph.est_intra_filter_rows(rows, ls2, rs2)
        applied.append(i)
    return {"node": node, "rows": rows, "cost": cost,
            "cols": e1["cols"] | e2["cols"],
            "joins": e1["joins"] + e2["joins"] + tuple(applied),
            "bushy": (e1["bushy"] or e2["bushy"]
                      or (bin(s1).count("1") > 1 and bin(s2).count("1") > 1))}


def _components(n: int, edges: list) -> list[int]:
    """Connected components of the leaf join graph, as bitmasks."""
    parent = list(range(n))

    def root(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (_, _, _, li, ri) in edges:
        parent[root(li)] = root(ri)
    comps: dict[int, int] = {}
    for i in range(n):
        comps[root(i)] = comps.get(root(i), 0) | (1 << i)
    return list(comps.values())


# ---------------------------------------------------------------------------
# Greedy per-candidate siding (fallback above MAX_SIDING_ENUM candidates)
# ---------------------------------------------------------------------------


def _side_semi_joins(leaves: list, db: Database, p, report: OptReport,
                     cache: dict) -> list:
    """Eq. 8 -> 9/10 with cost-based *siding*, one candidate at a time: per
    candidate graph↔table join, compare (A) post-match join only, (B)
    graph-side candidate mask, (C) table-side reduction by vertex keys —
    apply the cheapest. (The joint enumeration in ``_optimize_gcdi`` covers
    the common small-candidate case; this pass is its scalable fallback.)"""
    pattern = p.query.match
    gep = db.epoch_of(pattern.graph)
    leaves = list(leaves)

    for cand in _siding_candidates(leaves, db, p):
        i, jp = cand["i"], cand["jp"]
        vvar, vcol = cand["vvar"], cand["vcol"]
        tcoll, tcol = cand["tcoll"], cand["tcol"]
        label = cand["label"]
        graph_i, tbl_i = cand["graph_i"], cand["tbl_i"]
        alias = leaves[tbl_i]
        tbl_subtree = alias.children[0]
        mp = _find_kind(leaves[graph_i], ph.MatchPattern)

        def mp_cost_excl_tables(node: ph.MatchPattern) -> float:
            """Match cost with every mask's *table* subtree excluded — the
            table scans execute once under any siding (they feed the final
            equi-joins regardless), so no option gets charged for them."""
            c = _est_cost(node, db, cache)
            seen: set = set()
            for m in node.children:
                t = m.children[0]
                if id(t) not in seen:   # shared subtrees are counted once
                    seen.add(id(t))
                    c -= _est_cost(t, db, cache)
            return c

        n_t = _est_rows(tbl_subtree, db, cache)
        est_match = _est_rows(mp, db, cache)

        # (A) keep the post-match equi-join
        cost_a = mp_cost_excl_tables(mp) + cost_mod.cost_join(est_match, n_t)

        # (B) graph-side mask shrinking the candidate vertex set
        mask = ph.SemiJoinMask(pattern.graph, gep, label, vcol, tcol,
                               tbl_subtree)
        mask.ocol_src = ("table", tcoll, tcol)
        mp_b = mp.with_children(*mp.children, mask)
        mp_b.mask_vars = tuple(mp.mask_vars) + (vvar,)
        est_match_b = _est_rows(mp_b, db, cache)
        cost_b = (mp_cost_excl_tables(mp_b)
                  + cost_mod.cost_join(est_match_b, n_t))

        # (C) table-side reduction by the vertex keys
        reduce_node = ph.SemiJoinReduce(pattern.graph, gep, label, vcol,
                                        tcol, tbl_subtree)
        reduce_node.ocol_src = ("table", tcoll, tcol)
        n_t_c = _est_rows(reduce_node, db, cache)
        cost_c = (mp_cost_excl_tables(mp)
                  + _est_cost(reduce_node, db, cache)
                  - _est_cost(tbl_subtree, db, cache)
                  + cost_mod.cost_join(est_match, n_t_c))

        best = min(cost_a, cost_b, cost_c)
        if best == cost_b:
            leaves[graph_i] = _replace(leaves[graph_i], {id(mp): mp_b})
            report.add("semi-join", f"join#{i} ({jp}): graph-side mask on "
                       f"{vvar} — cost {cost_b:.3g} < post-match {cost_a:.3g}")
        elif best == cost_c:
            leaves[tbl_i] = alias.with_children(reduce_node)
            report.add("semi-join", f"join#{i} ({jp}): table-side reduce of "
                       f"{tcoll} — cost {cost_c:.3g} < post-match {cost_a:.3g}")
        else:
            report.add("semi-join", f"join#{i} ({jp}): kept post-match "
                       f"(cost {cost_a:.3g} <= {min(cost_b, cost_c):.3g})")
    return leaves
