"""Static plan verification: typed schema inference over the physical DAG.

Three plan-mutating layers — the cost-based optimizer (DP join enumeration,
semi-join siding, CSE, sink-down), the shard rewriter (``Exchange``
insertion), and device lowering (``DeviceMatchPattern``) — all emit operator
DAGs that until now were only checked by running them. This module checks
them *without executing*: a bottom-up schema-inference pass computes the
exact output columns/dtypes of every operator (``ScanTable`` → ``Regression``)
and validates the invariants each layer is supposed to preserve. Violations
carry rule IDs:

========  ==================================================================
rule      invariant
========  ==================================================================
V-COL     every column reference resolves (join keys, predicates,
          projections, prune lists, mask variables); silent drops are WARNs
V-TYPE    join-key dtype compatibility: dict (string) keys never meet
          numeric keys; numeric width promotions are flagged as WARNs
V-GCDA    relational→matrix boundary: feature columns exist, ragged columns
          never feed ``Rel2Matrix``, float32 narrowing promotions are WARNs,
          analytical operators consume matrices (labels are one column wide)
V-EPOCH   epoch soundness: every source-reading leaf embeds its source's
          *current* write epoch; the GCDI root's epoch vector covers every
          collection its subtree reads
V-SIG     signatures of distinct schemas never collide (two nodes with equal
          ``signature()`` must infer equal schemas — the inter-buffer and
          CSE both key on it)
V-SHARD   shard invariants: ``shards`` stamps only on shardable kinds and
          with one consistent k; every sharded EquiJoin's build side is an
          ``Exchange`` partitioned on the join key; ``Exchange`` appears
          only as an EquiJoin build side
V-DEV     device-lowering preconditions: ``DeviceMatchPattern`` only on
          mask-free chain patterns with edges, capacity ≥ the statically
          derivable padded frontier bound; pending deltas (host fallback at
          runtime) are WARNs
V-ANN     ``out_cols`` annotations agree with the inferred schema (stale
          annotations mislead column pruning and the optimizer)
V-EQ      rewrite equivalence: optimizer/shard output schemas ≡ naive-plan
          schemas (rewrites may reorder, never retype)
========  ==================================================================

A plan *passes* verification when it has no ERROR-severity violations; WARNs
(silent promotions, runtime fallbacks) are surfaced but non-fatal. Entry
points: :func:`verify_plan` (one DAG), :func:`verify_equivalence` (naive vs
rewritten), :func:`annotate_out_cols` (stamp the inferred column sets on
every relational node — the full-coverage ``out_cols`` propagation the
optimizer's column pruning reads). Engine wiring lives in
``GredoEngine.verify`` / ``GredoEngine(debug=True)``.

Dispatch is by ``node.kind`` string, so this module never imports
``physical`` (which imports it back for annotation at build time).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import cost
from .storage import Database, DictColumn, RaggedColumn, Table

ERROR = "ERROR"
WARN = "WARN"


@dataclasses.dataclass(frozen=True)
class MatrixType:
    """Inferred type of a GCDA node: a device matrix (None = statically
    unknown width, e.g. the n×n output of a self-similarity)."""
    dtype: str
    width: Optional[int]

    def __repr__(self):
        w = "?" if self.width is None else self.width
        return f"matrix[{self.dtype}, k={w}]"


@dataclasses.dataclass(frozen=True)
class MaskType:
    """Inferred type of a SemiJoinMask output: a boolean candidate-vertex
    mask over ``graph``'s ``label`` vertex table."""
    graph: str
    label: str

    def __repr__(self):
        return f"mask[{self.graph}.{self.label}]"


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str       # "V-COL" | "V-TYPE" | ...
    severity: str   # ERROR | WARN
    node: str       # node.describe() of the offending operator
    message: str

    def render(self) -> str:
        return f"verify:{self.rule} {self.severity} {self.node}: {self.message}"


class VerifyReport:
    """Outcome of one or more verification passes: the violation list plus
    the per-node inferred schemas (keyed by ``id(node)``)."""

    def __init__(self):
        self.violations: list[Violation] = []
        self.schemas: dict[int, object] = {}

    @property
    def ok(self) -> bool:
        return not any(v.severity == ERROR for v in self.violations)

    @property
    def errors(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == ERROR]

    @property
    def warnings(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == WARN]

    def by_rule(self, rule: str) -> list[Violation]:
        return [v for v in self.violations if v.rule == rule]

    def add(self, rule: str, severity: str, node, message: str):
        desc = node if isinstance(node, str) else node.describe()
        self.violations.append(Violation(rule, severity, desc, message))

    def render(self) -> list[str]:
        return [v.render() for v in self.violations]

    def __repr__(self):
        ne, nw = len(self.errors), len(self.warnings)
        return f"VerifyReport(ok={self.ok}, errors={ne}, warnings={nw})"


class PlanVerificationError(RuntimeError):
    """Raised by debug-mode engines when a plan fails verification."""

    def __init__(self, report: VerifyReport):
        self.report = report
        lines = [v.render() for v in report.errors]
        super().__init__("plan verification failed:\n" + "\n".join(lines))


# ---------------------------------------------------------------------------
# dtype model
# ---------------------------------------------------------------------------


def dtype_of(col) -> str:
    """Dtype string of a stored column: ``dict`` (dictionary-encoded
    strings), ``ragged[<values>]`` (multi-valued NF²), or the numpy name."""
    if isinstance(col, DictColumn):
        return "dict"
    if isinstance(col, RaggedColumn):
        dt = getattr(col.values, "dtype", None)
        return f"ragged[{dt if dt is not None else np.asarray(col.values).dtype}]"
    dt = getattr(col, "dtype", None)   # ndarray / merged view: no copy
    return str(dt if dt is not None else np.asarray(col).dtype)


def table_schema(t: Table) -> dict:
    """Schema of a stored table, cached on the table object (debug-mode
    verification re-reads every leaf per stage; dtype strings are stable
    while the column set is). Callers must not mutate the result — every
    deriving inference rule builds a fresh dict."""
    marker = (len(t.columns),) + tuple(map(id, t.columns.values()))
    cached = getattr(t, "_verify_schema", None)
    if cached is not None and cached[0] == marker:
        return cached[1]
    s = {name: dtype_of(col) for name, col in t.columns.items()}
    t._verify_schema = (marker, s)
    return s


def _key_kind(dtype: str) -> str:
    """Join-key comparison class of a dtype string. Dict columns decode to
    their string vocab for joins; ragged columns unnest to their values."""
    if dtype == "dict":
        return "str"
    if dtype.startswith("ragged["):
        dtype = dtype[len("ragged["):-1]
    try:
        kind = np.dtype(dtype).kind
    except TypeError:
        return "other"
    if kind in "iub":
        return "int"
    if kind == "f":
        return "float"
    if kind in "UOS":
        return "str"
    return "other"


def _vtable(g, label: str) -> Optional[Table]:
    """Vertex table of ``label``, or None (``g.vertex_tables`` is a mapping
    view without ``.get``)."""
    return g.vertex_tables[label] if label in g.vertex_tables else None


def _resolve(schema: dict, attr: str) -> Optional[str]:
    """Static mirror of ``physical._col_in``: exact name, else the bare
    suffix after the collection qualifier. None when unresolved."""
    if attr in schema:
        return attr
    if "." in attr:
        bare = attr.split(".", 1)[1]
        if bare in schema:
            return bare
    return None


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

_INT64 = str(np.dtype(np.int64))


class _Inference:
    """One bottom-up inference walk. Never raises: structural breakage is
    recorded as a violation and inference continues with the best available
    approximation (empty schema), so one bad node reports every downstream
    consequence instead of aborting the pass."""

    def __init__(self, db: Database, report: VerifyReport):
        self.db = db
        self.report = report
        self.memo: dict[int, object] = {}
        self.sources: dict[int, set] = {}   # id(node) -> collection names read

    # -- helpers --

    def err(self, rule, node, msg):
        self.report.add(rule, ERROR, node, msg)

    def warn(self, rule, node, msg):
        self.report.add(rule, WARN, node, msg)

    def _graph(self, node):
        g = self.db.graphs.get(node.graph)
        if g is None:
            self.err("V-COL", node, f"graph {node.graph!r} not in catalog")
        return g

    def _check_graph_epoch(self, node):
        if node.graph in self.db.graphs and node.epoch != self.db.epoch_of(node.graph):
            self.err("V-EPOCH", node,
                     f"embeds epoch {node.epoch} but {node.graph!r} is at "
                     f"write epoch {self.db.epoch_of(node.graph)}")

    def _check_preds(self, node, preds, schema, what="predicate"):
        """Pushed-selection predicates resolve by bare column name
        (``Table.eval_predicate`` uses ``pred.column``)."""
        for pred in preds:
            if "." not in pred.attr:
                self.err("V-COL", node,
                         f"{what} {pred!r} is unqualified (needs "
                         f"collection.column)")
                continue
            if pred.column not in schema:
                self.err("V-COL", node,
                         f"{what} column {pred.column!r} not in input "
                         f"schema {sorted(schema)[:8]}")

    def _check_join_key_types(self, node, rule, lname, ldt, rname, rdt):
        lk, rk = _key_kind(ldt), _key_kind(rdt)
        if lk == rk:
            return
        if "str" in (lk, rk) and {lk, rk} & {"int", "float"}:
            self.err(rule, node,
                     f"join key dtype mismatch: {lname}:{ldt} vs "
                     f"{rname}:{rdt} (string keys never match numeric keys)")
        elif {lk, rk} == {"int", "float"}:
            self.warn(rule, node,
                      f"silent promotion at join key: {lname}:{ldt} vs "
                      f"{rname}:{rdt} (int keys compare as floats)")
        else:
            self.err(rule, node,
                     f"incomparable join key dtypes: {lname}:{ldt} vs "
                     f"{rname}:{rdt}")

    def _source_names(self, *nodes) -> set:
        out: set = set()
        for n in nodes:
            out |= self.sources.get(id(n), set())
        return out

    # -- the walk --

    def schema(self, node):
        nid = id(node)
        if nid in self.memo:
            return self.memo[nid]
        child_schemas = [self.schema(c) for c in node.children]
        fn = getattr(self, f"_infer_{node.kind}", None)
        if fn is None:
            self.err("V-COL", node, f"unknown operator kind {node.kind!r}")
            out = {}
        else:
            out = fn(node, *child_schemas)
        self.memo[nid] = out
        srcs = self._source_names(*node.children)
        if hasattr(node, "name") and node.kind in ("ScanTable", "IndexScan",
                                                   "IndexSelect"):
            srcs = srcs | {node.name}
        elif hasattr(node, "graph"):
            srcs = srcs | {node.graph}
        self.sources[nid] = srcs
        self.report.schemas[nid] = out
        # V-ANN: a carried out_cols annotation must agree with inference
        ann = getattr(node, "out_cols", None)
        if ann is not None and isinstance(out, dict) and out:
            if frozenset(ann) != frozenset(out):
                stale = sorted(set(ann) - set(out))[:6]
                missing = sorted(set(out) - set(ann))[:6]
                self.warn("V-ANN", node,
                          f"out_cols annotation disagrees with inferred "
                          f"schema (stale={stale}, unannotated={missing})")
        return out

    # -- relational / document leaves --

    def _table(self, node, name):
        t = self.db.tables.get(name)
        if t is None:
            self.err("V-COL", node, f"table {name!r} not in catalog")
            return None
        return t

    def _infer_ScanTable(self, node):
        t = self._table(node, node.name)
        if t is None:
            return {}
        if node.epoch != self.db.epoch_of(node.name):
            self.err("V-EPOCH", node,
                     f"embeds epoch {node.epoch} but {node.name!r} is at "
                     f"write epoch {self.db.epoch_of(node.name)}")
        return table_schema(t)

    def _infer_IndexScan(self, node):
        t = self._table(node, node.name)
        if t is None:
            return {}
        if node.epoch != self.db.epoch_of(node.name):
            self.err("V-EPOCH", node,
                     f"embeds epoch {node.epoch} but {node.name!r} is at "
                     f"write epoch {self.db.epoch_of(node.name)}")
        schema = table_schema(t)
        if not (0 <= node.pick < len(node.preds)):
            self.err("V-COL", node,
                     f"pick={node.pick} out of range for "
                     f"{len(node.preds)} predicate(s)")
        self._check_preds(node, node.preds, schema)
        return schema

    _infer_IndexSelect = _infer_IndexScan

    def _infer_Select(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        self._check_preds(node, node.preds, child)
        return child

    def _infer_Alias(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        return {f"{node.name}.{k}": v for k, v in child.items()}

    def _infer_PruneCols(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        missing = [c for c in node.cols if c not in child]
        if missing:
            self.warn("V-COL", node,
                      f"prune list names absent column(s) {missing} "
                      f"(silently dropped at runtime)")
        return {c: child[c] for c in node.cols if c in child}

    # -- semi-joins --

    def _semi_join_common(self, node, child):
        """Shared checks of both sidings; returns (vertex dtype, other
        dtype) or None."""
        self._check_graph_epoch(node)
        g = self._graph(node)
        if g is None or not isinstance(child, dict):
            if not isinstance(child, dict):
                self.err("V-COL", node,
                         f"input is {child!r}, expected a relation")
            return None
        vt = _vtable(g, node.label)
        if vt is None:
            self.err("V-COL", node,
                     f"vertex label {node.label!r} not in graph "
                     f"{node.graph!r}")
            return None
        if node.vcol not in vt.columns:
            self.err("V-COL", node,
                     f"vertex key {node.label}.{node.vcol} not a column of "
                     f"the {node.label!r} vertex table")
            return None
        if node.ocol not in child:
            self.err("V-COL", node,
                     f"table key {node.ocol!r} not in input schema "
                     f"{sorted(child)[:8]}")
            return None
        vdt = dtype_of(vt.columns[node.vcol])
        odt = child[node.ocol]
        self._check_join_key_types(node, "V-TYPE",
                                   f"{node.label}.{node.vcol}", vdt,
                                   node.ocol, odt)
        return vdt, odt

    def _infer_SemiJoinMask(self, node, child):
        self._semi_join_common(node, child)
        return MaskType(node.graph, node.label)

    def _infer_SemiJoinReduce(self, node, child):
        self._semi_join_common(node, child)
        return child if isinstance(child, dict) else {}

    # -- pattern matching --

    def _pattern_vars(self, pattern) -> dict:
        """Schema of a materialized graph-relation: one int64 id column per
        bound pattern var (vids for vertices, edge tids for edges)."""
        if pattern.edges:
            chain = [pattern.vertices[0].var] + [e.dst for e in pattern.edges]
            cols = dict.fromkeys(chain + [e.var for e in pattern.edges])
        else:
            cols = dict.fromkeys([pattern.vertices[0].var])
        return {v: _INT64 for v in cols}

    def _check_pattern_preds(self, node, g, pattern, pred_map, what):
        edge_vars = {e.var for e in pattern.edges}
        pat_vars = edge_vars | {v.var for v in pattern.vertices}
        for var, preds in sorted(pred_map.items()):
            if var not in pat_vars:
                self.err("V-COL", node,
                         f"{what} predicates bound to unknown pattern "
                         f"var {var!r}")
                continue
            tbl = (g.edges if var in edge_vars
                   else _vtable(g, pattern.vertex(var).label))
            if tbl is None:
                self.err("V-COL", node,
                         f"vertex label {pattern.vertex(var).label!r} "
                         f"not in graph {node.graph!r}")
                continue
            self._check_preds(node, preds, table_schema(tbl),
                              what=f"{what}[{var}]")

    def _infer_MatchPattern(self, node, *mask_schemas):
        self._check_graph_epoch(node)
        g = self._graph(node)
        if g is None or node.pplan is None:
            if node.pplan is None:
                self.err("V-COL", node, "has no pattern plan")
            return {}
        pattern = node.pplan.pattern
        if len(node.mask_vars) != len(node.children):
            self.err("V-COL", node,
                     f"{len(node.children)} mask child(ren) but "
                     f"{len(node.mask_vars)} mask var(s)")
        vset = {v.var for v in pattern.vertices}
        for var, ms in zip(node.mask_vars, mask_schemas):
            if var not in vset:
                self.err("V-COL", node,
                         f"mask var {var!r} is not a pattern vertex")
            if not isinstance(ms, MaskType):
                self.err("V-COL", node,
                         f"mask child for {var!r} yields {ms!r}, expected a "
                         f"vertex mask")
            elif var in vset and ms.label != pattern.vertex(var).label:
                self.err("V-COL", node,
                         f"mask for {var!r} is over label {ms.label!r} but "
                         f"the pattern binds {pattern.vertex(var).label!r}")
        self._check_pattern_preds(node, g, pattern, node.pplan.pushed, "pushed")
        self._check_pattern_preds(node, g, pattern, node.pplan.deferred,
                                  "deferred")
        return self._pattern_vars(pattern)

    def _infer_DeviceMatchPattern(self, node, *mask_schemas):
        self._check_graph_epoch(node)
        g = self._graph(node)
        if node.pplan is None:
            self.err("V-DEV", node, "has no pattern plan")
            return {}
        pattern = node.pplan.pattern
        if node.children:
            self.err("V-DEV", node,
                     f"has {len(node.children)} mask child(ren) — device "
                     f"lowering requires a mask-free pattern")
        if not pattern.edges:
            self.err("V-DEV", node,
                     "pattern has no edges (vertex scans never lower)")
        elif not pattern.is_chain:
            self.err("V-DEV", node, "pattern is not a chain")
        if g is not None:
            self._check_pattern_preds(node, g, pattern, node.pplan.pushed,
                                      "pushed")
            self._check_pattern_preds(node, g, pattern, node.pplan.deferred,
                                      "deferred")
            if g.delta.has_pending():
                self.warn("V-DEV", node,
                          "graph has pending deltas — runtime will fall "
                          "back to the host matcher")
            elif pattern.edges and pattern.is_chain and node.capacity is not None:
                peak = cost.device_frontier_peak(g, node.pplan)
                need = cost.padded_capacity(peak)
                if node.capacity < need:
                    self.err("V-DEV", node,
                             f"capacity {node.capacity} below the static "
                             f"frontier bound {need} (peak≈{peak:.3g})")
        return self._pattern_vars(pattern)

    def _infer_TableJoinMatch(self, node):
        self._check_graph_epoch(node)
        g = self._graph(node)
        if g is not None:
            self._check_pattern_preds(node, g, node.pattern, node.deferred,
                                      "deferred")
        return self._pattern_vars(node.pattern)

    def _infer_VertexScan(self, node):
        self._check_graph_epoch(node)
        g = self._graph(node)
        var = node.pattern.vertices[0].var
        if g is not None and node.pplan is not None:
            self._check_pattern_preds(node, g, node.pattern,
                                      {var: node.pplan.deferred.get(var, [])},
                                      "deferred")
        return {var: _INT64}

    def _infer_EdgeScan(self, node):
        self._check_graph_epoch(node)
        g = self._graph(node)
        if not node.pattern.edges:
            self.err("V-COL", node, "edge scan over an edge-free pattern")
            return {}
        evar = node.pattern.edges[0].var
        if g is not None and node.pplan is not None:
            self._check_pattern_preds(node, g, node.pattern,
                                      {evar: node.pplan.deferred.get(evar, [])},
                                      "deferred")
        return {evar: _INT64}

    def _infer_GraphProject(self, node, child):
        self._check_graph_epoch(node)
        g = self._graph(node)
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        if g is None:
            return {}
        edge_vars = {e.var for e in node.pattern.edges}
        out: dict = {}
        for var in node.keep:
            if var not in child:
                self.warn("V-COL", node,
                          f"keep var {var!r} not bound by the child match "
                          f"(silently skipped at runtime)")
                continue
            out[f"{var}.__id"] = child[var]
            tbl = (g.edges if var in edge_vars
                   else _vtable(g, node.pattern.vertex(var).label))
            if tbl is None:
                self.err("V-COL", node,
                         f"vertex label {node.pattern.vertex(var).label!r} "
                         f"not in graph {node.graph!r}")
                continue
            for attr in node.wanted.get(var, []):
                if attr not in tbl.columns:
                    self.err("V-COL", node,
                             f"projected attribute {var}.{attr} not a "
                             f"column of its backing table")
                    continue
                out[f"{var}.{attr}"] = dtype_of(tbl.columns[attr])
        return out if out else dict(child)

    # -- joins --

    def _infer_EquiJoin(self, node, left, right):
        if not isinstance(left, dict) or not isinstance(right, dict):
            self.err("V-COL", node, "join inputs must both be relations")
            return left if isinstance(left, dict) else (
                right if isinstance(right, dict) else {})
        lc = _resolve(left, node.jp.left)
        rc = _resolve(right, node.jp.right)
        if lc is None:
            self.err("V-COL", node,
                     f"left key {node.jp.left!r} not in left schema "
                     f"{sorted(left)[:8]}")
        if rc is None:
            self.err("V-COL", node,
                     f"right key {node.jp.right!r} not in right schema "
                     f"{sorted(right)[:8]}")
        if lc is not None and rc is not None:
            self._check_join_key_types(node, "V-TYPE", node.jp.left, left[lc],
                                       node.jp.right, right[rc])
        out = dict(left)
        for k, v in right.items():
            if k in out and out[k] != v:
                self.warn("V-COL", node,
                          f"column {k!r} ({out[k]}) overwritten by right "
                          f"side ({v})")
            out[k] = v
        return out

    def _infer_IntraFilter(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        lc = _resolve(child, node.jp.left)
        rc = _resolve(child, node.jp.right)
        for attr, res in ((node.jp.left, lc), (node.jp.right, rc)):
            if res is None:
                self.err("V-COL", node,
                         f"filter key {attr!r} not in input schema "
                         f"{sorted(child)[:8]}")
        if lc is not None and rc is not None:
            self._check_join_key_types(node, "V-TYPE", node.jp.left,
                                       child[lc], node.jp.right, child[rc])
        return child

    def _infer_Exchange(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        if _resolve(child, node.key) is None:
            self.err("V-SHARD", node,
                     f"partition key {node.key!r} not in input schema "
                     f"{sorted(child)[:8]}")
        return child

    def _infer_Residual(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        for pred in node.preds:
            if _resolve(child, pred.attr) is None:
                self.err("V-COL", node,
                         f"residual predicate column {pred.attr!r} not in "
                         f"input schema {sorted(child)[:8]}")
        return child

    def _infer_Project(self, node, child):
        if not isinstance(child, dict):
            self.err("V-COL", node, f"input is {child!r}, expected a relation")
            return {}
        out: dict = {}
        for a in node.select:
            res = _resolve(child, a)
            if res is None:
                self.err("V-COL", node,
                         f"projected attribute {a!r} not in input schema "
                         f"{sorted(child)[:10]}")
                continue
            out[a] = child[res]
        # the root's epoch vector must be current AND cover every collection
        # the subtree reads — it is the inter-buffer reuse key
        declared = dict(node.epochs)
        for name, ep in node.epochs:
            if name in self.db.tables or name in self.db.graphs:
                if ep != self.db.epoch_of(name):
                    self.err("V-EPOCH", node,
                             f"epoch vector pins {name!r}@{ep} but the "
                             f"catalog is at {self.db.epoch_of(name)}")
            else:
                self.err("V-EPOCH", node,
                         f"epoch vector names unknown collection {name!r}")
        uncovered = self._source_names(*node.children) - set(declared)
        if uncovered:
            self.err("V-EPOCH", node,
                     f"epoch vector misses source(s) {sorted(uncovered)} "
                     f"read by the subtree — cached results would survive "
                     f"their writes")
        return out

    # -- GCDA: relational → matrix boundary and analytical operators --

    def _infer_Rel2Matrix(self, node, child):
        if not isinstance(child, dict):
            self.err("V-GCDA", node,
                     f"input is {child!r}, expected a relation")
            return MatrixType("float32", len(node.columns))
        for c in node.columns:
            dt = child.get(c)
            if dt is None:
                self.err("V-COL", node,
                         f"feature column {c!r} not in input schema "
                         f"{sorted(child)[:10]} (matrix columns resolve "
                         f"exactly)")
            elif dt.startswith("ragged["):
                self.err("V-GCDA", node,
                         f"feature column {c!r} is multi-valued ({dt}) — "
                         f"ragged columns cannot densify; aggregate via "
                         f"RandomAccessMatrix instead")
            elif dt == "dict":
                self.warn("V-GCDA", node,
                          f"feature column {c!r} is dictionary-encoded — "
                          f"its integer codes become the feature values")
            elif dt not in ("float32",) and _key_kind(dt) in ("int", "float"):
                self.warn("V-GCDA", node,
                          f"feature column {c!r}:{dt} silently promotes to "
                          f"float32 at the matrix boundary")
        return MatrixType("float32", len(node.columns))

    def _infer_RandomAccessMatrix(self, node, child):
        out = MatrixType("float32", node.n_features)
        if not isinstance(child, dict):
            self.err("V-GCDA", node,
                     f"input is {child!r}, expected a relation")
            return out
        for what, c in (("group", node.group_col), ("value", node.value_col)):
            if c not in child:
                self.err("V-COL", node,
                         f"{what} column {c!r} not in input schema "
                         f"{sorted(child)[:10]}")
        gdt = child.get(node.group_col)
        if gdt is not None and _key_kind(gdt) not in ("int",):
            self.warn("V-GCDA", node,
                      f"group column {node.group_col!r}:{gdt} is not an "
                      f"integer id column")
        return out

    def _infer_Const(self, node):
        arr = np.asarray(node.value)
        width = (int(arr.shape[1]) if arr.ndim == 2
                 else (1 if arr.ndim == 1 else None))
        return MatrixType(str(arr.dtype), width)

    def _check_matrix_input(self, node, side, s) -> Optional[MatrixType]:
        if not isinstance(s, MatrixType):
            self.err("V-GCDA", node,
                     f"{side} input is {s!r}, expected a matrix")
            return None
        return s

    def _binary_matrix(self, node, schemas, out_width):
        xs = [self._check_matrix_input(node, side, s)
              for side, s in zip(("lhs", "rhs"), schemas)]
        good = [x for x in xs if x is not None]
        if len(good) == 2 and good[0].dtype != good[1].dtype:
            self.warn("V-GCDA", node,
                      f"operand dtypes differ ({good[0].dtype} vs "
                      f"{good[1].dtype}) — the device promotes silently")
        dtype = good[0].dtype if good else "float32"
        return MatrixType(dtype, out_width)

    def _infer_MatMul(self, node, *schemas):
        # gram (x @ x.T): n×n, width statically unknown; otherwise the rhs
        # width carries through
        if node.gram:
            return self._binary_matrix(node, schemas, None)
        rhs = schemas[1] if len(schemas) > 1 else None
        width = rhs.width if isinstance(rhs, MatrixType) else None
        return self._binary_matrix(node, schemas, width)

    def _infer_Similarity(self, node, *schemas):
        if not node.self_sim and len(schemas) == 2:
            both = [s for s in schemas if isinstance(s, MatrixType)]
            if len(both) == 2 and None not in (both[0].width, both[1].width) \
                    and both[0].width != both[1].width:
                self.err("V-GCDA", node,
                         f"similarity operands have different feature "
                         f"widths ({both[0].width} vs {both[1].width})")
        return self._binary_matrix(node, schemas, None)

    def _infer_Regression(self, node, x, y):
        xm = self._check_matrix_input(node, "feature", x)
        ym = self._check_matrix_input(node, "label", y)
        if ym is not None and ym.width not in (None, 1):
            self.err("V-GCDA", node,
                     f"label input is {ym.width} columns wide — "
                     f"reshape(-1) would silently flatten {ym.width} labels "
                     f"per row")
        if xm is not None and ym is not None and xm.dtype != ym.dtype:
            self.warn("V-GCDA", node,
                      f"feature/label dtypes differ ({xm.dtype} vs "
                      f"{ym.dtype})")
        return MatrixType(xm.dtype if xm else "float32", None)


# ---------------------------------------------------------------------------
# whole-plan passes
# ---------------------------------------------------------------------------


def _walk(root):
    seen, order, stack = set(), [], [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        order.append(n)
        stack.extend(n.children)
    return order


def _check_shard_invariants(root, report: VerifyReport, inf: _Inference):
    from . import shard as shard_mod    # runtime: shard imports physical

    nodes = _walk(root)
    parents: dict[int, list] = {}
    for n in nodes:
        for c in n.children:
            parents.setdefault(id(c), []).append(n)

    ks = set()
    for n in nodes:
        k = getattr(n, "shards", None)
        if not isinstance(k, int):
            continue
        ks.add(k)
        if n.kind not in shard_mod.SHARDABLE_KINDS:
            report.add("V-SHARD", ERROR, n,
                       f"stamped shards={k} but {n.kind} is not a "
                       f"shardable kind (the runtime would treat it as "
                       f"NOT_SHARDED)")
    if len(ks) > 1:
        report.add("V-SHARD", ERROR, root.describe(),
                   f"inconsistent shard counts across the plan: "
                   f"{sorted(ks)} (one Exchange layout per plan)")

    for n in nodes:
        if n.kind == "EquiJoin" and isinstance(getattr(n, "shards", None), int):
            build = n.children[1]
            if build.kind != "Exchange":
                report.add("V-SHARD", ERROR, n,
                           f"sharded join's build side is {build.kind}, "
                           f"not an Exchange — probes have no partitioned "
                           f"runs to bind to")
                continue
            if build.key != n.jp.right:
                report.add("V-SHARD", ERROR, n,
                           f"build-side Exchange partitions on "
                           f"{build.key!r} but the join probes "
                           f"{n.jp.right!r} — misaligned partition keys "
                           f"drop matches")
            if build.k != n.shards:
                report.add("V-SHARD", ERROR, n,
                           f"build-side Exchange has k={build.k} but the "
                           f"join runs {n.shards} shard(s)")
        if n.kind == "Exchange":
            ps = parents.get(id(n), [])
            bad = [p for p in ps
                   if not (p.kind == "EquiJoin" and len(p.children) > 1
                           and p.children[1] is n)]
            if bad or not ps:
                where = bad[0].describe() if bad else "the plan root"
                report.add("V-SHARD", ERROR, n,
                           f"Exchange must feed an EquiJoin build side, "
                           f"found under {where}")


def _check_signature_coherence(root, report: VerifyReport, inf: _Inference,
                               seen_sigs: Optional[dict] = None):
    """V-SIG: equal signatures must mean equal inferred schemas (CSE and
    the inter-buffer both substitute results across equal signatures)."""
    sigs = seen_sigs if seen_sigs is not None else {}
    for n in _walk(root):
        s = inf.memo.get(id(n))
        if s is None:
            continue
        key = n.signature()
        norm = tuple(sorted(s.items())) if isinstance(s, dict) else s
        prev = sigs.get(key)
        if prev is None:
            sigs[key] = (norm, n.describe())
        elif prev[0] != norm:
            report.add("V-SIG", ERROR, n,
                       f"signature collides with {prev[1]} but the schemas "
                       f"differ — cached results would cross-contaminate")
    return sigs


def verify_plan(root, db: Database,
                report: Optional[VerifyReport] = None,
                seen_sigs: Optional[dict] = None) -> VerifyReport:
    """Statically verify one physical DAG against the live catalog. Appends
    to ``report`` when given (so one report can span naive + rewritten +
    sharded passes); never executes an operator."""
    if report is None:
        report = VerifyReport()
    inf = _Inference(db, report)
    inf.schema(root)
    _check_shard_invariants(root, report, inf)
    _check_signature_coherence(root, report, inf, seen_sigs)
    return report


def _schema_repr(s) -> str:
    if isinstance(s, dict):
        return "{" + ", ".join(f"{k}:{v}" for k, v in s.items()) + "}"
    return repr(s)


def verify_equivalence(naive, rewritten, db: Database,
                       label: str = "rewrite",
                       report: Optional[VerifyReport] = None) -> VerifyReport:
    """V-EQ: the rewritten root must infer the same schema as the naive
    root — rewrites may reorder and re-side, never retype. Column *order*
    must also survive for relational roots (the result table the user sees)."""
    if report is None:
        report = VerifyReport()

    def _root_schema(n):
        # reuse a schema already inferred into this report by verify_plan
        # (deterministic per node object) instead of re-walking the DAG
        if id(n) in report.schemas:
            return report.schemas[id(n)]
        return _Inference(db, VerifyReport()).schema(n)   # silent pass

    ns, rs = _root_schema(naive), _root_schema(rewritten)
    same = (ns == rs if not isinstance(ns, dict)
            else (isinstance(rs, dict) and list(ns.items()) == list(rs.items())))
    if not same:
        report.add("V-EQ", ERROR, rewritten,
                   f"{label} retyped the plan root: naive "
                   f"{_schema_repr(ns)} vs rewritten {_schema_repr(rs)}")
    return report


def annotate_out_cols(root, db: Database) -> None:
    """Stamp the inferred output column set on every relational node as
    ``out_cols`` (full-coverage schema annotations; previously only cluster
    roots and aliases carried them). Mask/matrix nodes are skipped — the
    annotation is a column-name concept. Best-effort: inference collects
    violations instead of raising, so annotation never blocks plan build."""
    report = VerifyReport()
    inf = _Inference(db, report)
    inf.schema(root)
    for n in _walk(root):
        s = inf.memo.get(id(n))
        if isinstance(s, dict) and s:
            n.out_cols = frozenset(s)
