"""Multi-model schema, predicates, and the SFMW query AST (paper §3.2).

A GCDI task is a Select-From-Match-Where (SFMW) expression, Eq. (1):

    T = pi_A( sigma_Psi( H1 join_F1 ... join_Fk-1 ( gpi_A' P(Hk, Pk) ) ) )

The AST here mirrors that algebra: ``Query`` holds projections (``select``),
collections (``froms``), an optional graph ``match`` (pattern), cross-model
join predicates (``joins``), and residual predicates (``where``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

# ---------------------------------------------------------------------------
# Predicates (paper Definition 5)
# ---------------------------------------------------------------------------

OPS = ("==", "!=", "<", "<=", ">", ">=", "range", "in")


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Single-collection predicate  F: record -> bool  over one attribute.

    ``attr`` is ``"collection.column"`` (document path expressions use dots
    too — the storage layer shreds paths into columns, so ``orders.item.id``
    is just a column name).
    """

    attr: str
    op: str
    value: Any
    value2: Any = None  # upper bound for "range"

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"bad predicate op {self.op!r}")

    @property
    def collection(self) -> str:
        return self.attr.split(".", 1)[0]

    @property
    def column(self) -> str:
        return self.attr.split(".", 1)[1]

    @property
    def is_equality(self) -> bool:
        return self.op == "=="

    @property
    def is_inequality(self) -> bool:
        return self.op == "!="

    @property
    def is_range(self) -> bool:
        return self.op in ("<", "<=", ">", ">=", "range")

    def __repr__(self):  # compact for plan printouts
        if self.op == "range":
            return f"{self.attr} in [{self.value},{self.value2}]"
        return f"{self.attr} {self.op} {self.value!r}"


@dataclasses.dataclass(frozen=True)
class JoinPred:
    """Cross-model equi-join predicate  F(h1, h2) := h1.left == h2.right."""

    left: str   # "collection.column"
    right: str  # "collection.column"

    @property
    def left_collection(self) -> str:
        return self.left.split(".", 1)[0]

    @property
    def right_collection(self) -> str:
        return self.right.split(".", 1)[0]

    def __repr__(self):
        return f"{self.left}={self.right}"


# ---------------------------------------------------------------------------
# Graph patterns (paper §5.2):  P = (G_p, U, Phi)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PatternVertex:
    var: str            # variable name, e.g. "p"
    label: str          # vertex label, e.g. "Persons"


@dataclasses.dataclass(frozen=True)
class PatternEdge:
    var: str
    label: str
    src: str            # source vertex var
    dst: str            # target vertex var


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A chain/star pattern graph. ``vertices``/``edges`` define G_p; the
    ordered hybrid-traversal sequence U is derived by the planner (forward or
    reverse, per the cost model); ``Phi`` (predicate assignment) lives in the
    enclosing Query.where and is *assigned* to pattern elements by the
    planner's graph-predicate-pushdown pass.
    """

    graph: str                       # graph collection name
    vertices: tuple[PatternVertex, ...]
    edges: tuple[PatternEdge, ...]

    def vertex(self, var: str) -> PatternVertex:
        for v in self.vertices:
            if v.var == var:
                return v
        raise KeyError(var)

    def canonical(self) -> tuple:
        """Structural identity of the pattern graph — the stable tuple the
        physical plan's node signatures embed (§6.4 structural matching)."""
        return (self.graph,
                tuple((v.var, v.label) for v in self.vertices),
                tuple((e.var, e.label, e.src, e.dst) for e in self.edges))

    @property
    def is_chain(self) -> bool:
        # v0 -e0-> v1 -e1-> v2 ... (each edge links consecutive vertices)
        if not self.edges:
            return True
        order = [v.var for v in self.vertices]
        for i, e in enumerate(self.edges):
            if e.src not in order or e.dst not in order:
                return False
        return True


def chain_pattern(graph: str, *hops: tuple[str, str, str, str, str]) -> Pattern:
    """Build a chain pattern from (src_var, src_label, edge_label, dst_var,
    dst_label) hops, e.g. ``chain_pattern("Interested_in",
    ("p","Persons","Interested_in","t","Tags"))``."""
    vertices: list[PatternVertex] = []
    edges: list[PatternEdge] = []
    seen = {}
    for i, (sv, sl, el, dv, dl) in enumerate(hops):
        if sv not in seen:
            seen[sv] = PatternVertex(sv, sl)
            vertices.append(seen[sv])
        if dv not in seen:
            seen[dv] = PatternVertex(dv, dl)
            vertices.append(seen[dv])
        edges.append(PatternEdge(f"e{i}", el, sv, dv))
    return Pattern(graph, tuple(vertices), tuple(edges))


# ---------------------------------------------------------------------------
# SFMW query
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Query:
    """Select-From-Match-Where GCDI task (Eq. 1)."""

    select: tuple[str, ...]                 # projection attributes "coll.col" or "var.prop"
    froms: tuple[str, ...]                  # relational/document collection names
    match: Optional[Pattern] = None         # at most one graph pattern (paper Eq. 8)
    joins: tuple[JoinPred, ...] = ()        # cross-model join predicates, in join order
    where: tuple[Predicate, ...] = ()       # selection predicate set Psi

    def predicates_on(self, collection: str) -> list[Predicate]:
        return [p for p in self.where if p.collection == collection]

    def source_names(self) -> tuple[str, ...]:
        """Every collection this task reads (tables/documents + the matched
        graph) — the set whose write epochs gate inter-buffer reuse."""
        names = list(self.froms)
        if self.match is not None:
            names.append(self.match.graph)
        return tuple(names)


# ---------------------------------------------------------------------------
# GCDA task spec (Eq. 5/6):  T = A(G(T_GCDI))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnalyticsTask:
    """``op`` in {"MULTIPLY", "SIMILARITY", "REGRESSION"} applied to matrices
    generated from GCDI results (paper Table 3). ``inputs`` name matrix
    sources: either ("rel2matrix", query, columns) local access, or
    ("random", query, group_col, value_col) random access aggregation.
    """

    op: str
    inputs: Sequence[Any]
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GCDIATask:
    integration: Query
    analytics: AnalyticsTask
