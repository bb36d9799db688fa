"""GCDI plan generation + optimization framework (paper §6.1-6.3).

Four mechanisms, as in the paper:
  1. *Graph predicate pushdown* — predicates on pattern vars are assigned to
     the pattern (Phi) and pushed per the Fig. 6 rule/cost strategies; and
     predicates on a rel/doc collection joined with a pattern vertex on the
     same attribute are *replicated* onto the graph side (transitivity).
  2. *Join pushdown* — Eq. (8) -> Eq. (9)/(10): a join between a table and the
     graph-relation is rewritten (cost-based) into a semi-join that shrinks
     the graph's candidate vertex sets *before* matching.
  3. *GCDI rewriting* — match trimming (patterns with no topology constraint
     -> record scan; v-e-v patterns touching only edges -> edge scan) and
     projection trimming (drop graph-projection columns never referenced).
  4. *Query-aware traversal pruning* — carried by PatternPlan.fetch_vars:
     unreferenced, predicate-free pattern vars never fetch records.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import pattern as pattern_mod
from .schema import JoinPred, Predicate, Query
from .storage import Database, Table


@dataclasses.dataclass
class GCDIPlan:
    query: Query
    pattern_plan: Optional[pattern_mod.PatternPlan]
    table_pushdown: dict                  # collection -> [Predicate]
    residual: list                        # predicates evaluated post-join
    semi_join_idx: set                    # candidate graph↔table join indices (Eq. 9/10
                                          # siding is decided by repro_torch.core.optimizer)
    graph_projection: set                 # pattern vars kept after projection trimming
    match_trim: Optional[str]             # None | "vertex_scan" | "edge_scan"
    notes: list = dataclasses.field(default_factory=list)

    def explain(self) -> str:
        lines = ["GCDI plan:"]
        for c, ps in self.table_pushdown.items():
            lines.append(f"  σ-pushdown[{c}]: {ps}")
        if self.pattern_plan:
            lines.append("  " + self.pattern_plan.describe())
        if self.match_trim:
            lines.append(f"  match-trimming: {self.match_trim}")
        if self.semi_join_idx:
            lines.append(f"  join-pushdown candidates (Eq.9/10): joins "
                         f"{sorted(self.semi_join_idx)} (siding: optimizer)")
        lines.append(f"  graph-projection A' = {sorted(self.graph_projection)}")
        if self.residual:
            lines.append(f"  residual σ: {self.residual}")
        lines.extend("  note: " + n for n in self.notes)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def plan(db: Database, q: Query, enable_opt: bool = True,
         enable_pattern_pushdown: Optional[bool] = None) -> GCDIPlan:
    if enable_pattern_pushdown is None:
        enable_pattern_pushdown = enable_opt
    notes: list[str] = []
    pattern = q.match
    pattern_vars: set[str] = set()
    if pattern:
        pattern_vars = {v.var for v in pattern.vertices} | {e.var for e in pattern.edges}

    # --- split predicates: table-pushable / pattern (Phi) / residual ---
    table_pushdown: dict[str, list[Predicate]] = {}
    phi: dict[str, list[Predicate]] = {}
    residual: list[Predicate] = []
    for p in q.where:
        if p.collection in pattern_vars:
            phi.setdefault(p.collection, []).append(p)   # mechanism 1 (into match)
        elif p.collection in q.froms:
            if enable_opt:
                table_pushdown.setdefault(p.collection, []).append(p)
            else:
                residual.append(p)
        else:
            residual.append(p)

    # --- mechanism 1b: replicate predicates across models via join equality ---
    if enable_opt and pattern:
        for jp in q.joins:
            lc, rc = jp.left_collection, jp.right_collection
            tbl_side, var_side = None, None
            if lc in q.froms and rc in pattern_vars:
                tbl_side, var_side = jp.left, jp.right
            elif rc in q.froms and lc in pattern_vars:
                tbl_side, var_side = jp.right, jp.left
            if tbl_side is None:
                continue
            tcoll, tcol = tbl_side.split(".", 1)
            vvar, vcol = var_side.split(".", 1)
            for p in table_pushdown.get(tcoll, []):
                if p.column == tcol and p.is_equality:
                    rep = Predicate(f"{vvar}.{vcol}", p.op, p.value, p.value2)
                    if rep in phi.get(vvar, []):
                        continue    # the query already states it directly
                    phi.setdefault(vvar, []).append(rep)
                    notes.append(f"replicated {p} across join {jp} -> {rep}")

    # --- mechanism 3a: match trimming ---
    match_trim = None
    if enable_opt and pattern:
        referenced = _referenced_vars(q, pattern_vars)
        if not pattern.edges:
            match_trim = "vertex_scan"
            notes.append("match-trimming: pattern has no topology constraint")
        elif (len(pattern.edges) == 1 and len(pattern.vertices) == 2
              and all(v not in phi for v in (pattern.vertices[0].var, pattern.vertices[1].var))
              and referenced <= {pattern.edges[0].var}):
            match_trim = "edge_scan"
            notes.append("match-trimming: v-e-v with edge-only predicates/projection")

    # --- mechanism 3b: projection trimming ---
    graph_projection: set[str] = set()
    if pattern:
        graph_projection = _referenced_vars(q, pattern_vars)
        if enable_opt:
            notes.append(f"projection-trimming keeps {sorted(graph_projection)} of "
                         f"{sorted(pattern_vars)}")
        else:
            graph_projection = set(pattern_vars)

    # --- mechanism 2: join pushdown candidates (Eq. 8 -> 9/10) ---
    # The *logical* decision stops at eligibility: which joins connect a
    # table/document collection to a pattern vertex. The cost-based siding
    # (graph-side mask vs. table-side reduce vs. post-match join) is a
    # physical rewrite, made by repro_torch.core.optimizer against live statistics.
    semi_join_idx: set[int] = set()
    if enable_opt and pattern and not match_trim:
        for i, jp in enumerate(q.joins):
            if _graph_join_side(q, pattern_vars, jp) is not None:
                semi_join_idx.add(i)
                notes.append(f"join-pushdown candidate join#{i} ({jp}): "
                             "siding decided by the optimizer")

    # --- pattern plan (mechanism 1 + 4 inside) ---
    pattern_plan = None
    if pattern and not match_trim:
        pattern_plan = pattern_mod.plan_pattern(
            db.graphs[pattern.graph], pattern, phi, graph_projection,
            enable_pushdown=enable_pattern_pushdown)
    elif pattern and match_trim:
        pattern_plan = pattern_mod.PatternPlan(pattern, False, {}, phi, graph_projection)

    return GCDIPlan(q, pattern_plan, table_pushdown, residual, semi_join_idx,
                    graph_projection, match_trim, notes)


def _referenced_vars(q: Query, pattern_vars: set[str]) -> set[str]:
    """Vars referenced by projection, joins, or residual predicates."""
    ref = set()
    for a in q.select:
        c = a.split(".", 1)[0]
        if c in pattern_vars:
            ref.add(c)
    for jp in q.joins:
        for side in (jp.left, jp.right):
            c = side.split(".", 1)[0]
            if c in pattern_vars:
                ref.add(c)
    for p in q.where:
        if p.collection in pattern_vars:
            ref.add(p.collection)
    return ref


def _graph_join_side(q: Query, pattern_vars: set[str], jp: JoinPred):
    if jp.left_collection in q.froms and jp.right_collection in pattern_vars:
        return jp.left, jp.right
    if jp.right_collection in q.froms and jp.left_collection in pattern_vars:
        return jp.right, jp.left
    return None


# ---------------------------------------------------------------------------
# Execution — the logical plan is lowered to the physical operator DAG
# (repro_torch.core.physical) and walked bottom-up; steps 1-5 of the old monolithic
# executor are now node constructors in ``physical.build_gcdi``.
# ---------------------------------------------------------------------------


def execute(db: Database, p: GCDIPlan, mode: str = "gredo") -> Table:
    from . import physical
    dag = physical.build_gcdi(db, p, mode=mode)
    return physical.execute(dag, physical.ExecContext(db))
