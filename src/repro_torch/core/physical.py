"""Unified physical operator DAG (paper §5/§6.4, operator-level execution).

One plan IR from GCDI scans to GCDA kernels. ``planner.plan`` still makes
the *logical* decisions (pushdown sets, semi-join choices, match trimming);
:func:`build_gcdi` / :func:`build_gcdia` turn a :class:`~.planner.GCDIPlan`
(plus an optional analytics spec) into a typed DAG of :class:`PhysicalOp`
nodes, and :func:`execute` walks it bottom-up.

Every node carries
  * ``children`` — input operators,
  * ``run(ctx, *inputs)`` — the vectorized implementation,
  * ``stats`` — per-operator rows / bytes / seconds / cache flags,
  * ``signature()`` — a canonical structural fingerprint that embeds the
    write epochs of every source collection the subtree reads.

The inter-buffer is keyed on node signatures (structural plan matching,
§6.4): a repeated GCDIA task with a *different* analytics operator reuses
the materialized GCDI relation and generated matrices mid-plan, because the
shared sub-DAG has the same signature; any write to a source collection
bumps its epoch and changes every dependent signature, so stale reuse is
impossible. This replaces both monkey-patch execution paths: semi-join
candidate masks are ordinary :class:`SemiJoinMask` input edges into
:class:`MatchPattern`, and the GredoDB-S ablation is a
:class:`TableJoinMatch` node over the relational join engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import analytics
from . import join as join_mod
from . import pattern as pattern_mod
from . import telemetry
from . import traversal
from .interbuffer import InterBuffer, fingerprint, value_nbytes
from .schema import JoinPred, Pattern, Query
from .storage import Database, Table


# ---------------------------------------------------------------------------
# Node infrastructure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeStats:
    rows: Optional[int] = None
    nbytes: int = 0
    seconds: float = 0.0
    executed: bool = False
    cached: bool = False        # satisfied from the inter-buffer
    memoized: bool = False      # satisfied from this execution's memo


class ExecContext:
    """One bottom-up DAG execution: per-run memo keyed by node signature
    (shared sub-plans run once) plus an optional persistent inter-buffer
    consulted at cacheable nodes (cross-task structural reuse)."""

    def __init__(self, db: Database, interbuffer: Optional[InterBuffer] = None,
                 ests: Optional[dict] = None,
                 trace: Optional["telemetry.QueryTrace"] = None,
                 fence_device: bool = False, shard=None,
                 device: "torch.device | str" = "cuda"):
        self.db = db
        self.device = torch.device(device)  # the engine's device: matrices,
                                            # kernels, the traversal CSR
        self.interbuffer = interbuffer
        self.ests = ests          # id(node) -> (est_rows, est_cost): feeds
                                  # the cost-aware inter-buffer admission
        self.trace = trace        # telemetry span sink; None = tracing off
        self.fence_device = fence_device  # synchronise on GCDA outputs
                                          # inside their span (tracing only)
        self.shard = shard        # shard.ShardRuntime; None = serial execution
        self.memo: dict = {}
        self.nodes_run = 0
        self.nodes_reused = 0     # inter-buffer hits during this execution


class PhysicalOp:
    kind = "op"
    cacheable = False   # eligible for inter-buffer persistence

    def __init__(self, *children: "PhysicalOp"):
        self.children = tuple(children)
        self.stats = NodeStats()
        self._sig = None

    # -- structural fingerprint (embeds source epochs via params) --
    def params(self) -> tuple:
        return ()

    def signature(self) -> tuple:
        if self._sig is None:
            self._sig = (self.kind, self.params(),
                         tuple(c.signature() for c in self.children))
        return self._sig

    def run(self, ctx: ExecContext, *inputs):
        raise NotImplementedError

    def describe(self) -> str:
        return self.kind

    def with_children(self, *children: "PhysicalOp") -> "PhysicalOp":
        """Shallow clone with replaced inputs — the rewrite primitive of the
        optimizer. Annotations (out_cols, key_src, logical) carry over; the
        signature cache and stats are reset."""
        import copy
        clone = copy.copy(self)
        clone.children = tuple(children)
        clone.stats = NodeStats()
        clone._sig = None
        return clone


def _preds_sig(preds) -> tuple:
    return tuple(repr(p) for p in preds)


def _pred_map_sig(m: dict) -> tuple:
    return tuple((v, _preds_sig(ps)) for v, ps in sorted(m.items()))


def _pattern_sig(pattern: Pattern) -> tuple:
    return pattern.canonical()


def _pplan_sig(pplan) -> tuple:
    if pplan is None:
        return ()
    return (bool(pplan.reverse), _pred_map_sig(pplan.pushed),
            _pred_map_sig(pplan.deferred), tuple(sorted(pplan.fetch_vars)))


def _result_rows(out) -> Optional[int]:
    if isinstance(out, Table):
        return out.nrows
    if hasattr(out, "shape"):
        return int(out.shape[0]) if getattr(out, "ndim", 0) else 1
    return None


# ---------------------------------------------------------------------------
# GCDI operators (plan steps 1-5 as node constructors)
# ---------------------------------------------------------------------------


class ScanTable(PhysicalOp):
    """Base relational/document collection scan (RecordAM full scan)."""
    kind = "ScanTable"

    def __init__(self, name: str, epoch: int):
        super().__init__()
        self.name = name
        self.epoch = epoch

    def params(self):
        return (self.name, self.epoch)

    def run(self, ctx, *inputs):
        return ctx.db.tables[self.name]

    def describe(self):
        return f"ScanTable[{self.name}]"


class Select(PhysicalOp):
    """σ with pushed-down predicates (mechanism 1: table-side pushdown)."""
    kind = "Select"

    def __init__(self, child: PhysicalOp, preds: list):
        super().__init__(child)
        self.preds = list(preds)

    def params(self):
        return _preds_sig(self.preds)

    def run(self, ctx, t: Table):
        for pred in self.preds:
            t = t.take(np.nonzero(t.eval_predicate(pred))[0])
        return t

    def describe(self):
        return f"Select[{', '.join(repr(p) for p in self.preds)}]"


class IndexScan(PhysicalOp):
    """Index-backed access path replacing a Select-over-ScanTable pair:
    postings of the most selective servable predicate seed the row set, the
    remaining predicates are point-evaluated on those rows only, and the
    table is gathered once via the tid-based RecordAM. Chosen by the
    optimizer's cost-based access-path selection; falls back to the full
    scan at runtime if the index was dropped since planning."""
    kind = "IndexScan"

    def __init__(self, name: str, epoch: int, preds: list, pick: int,
                 access: str):
        super().__init__()
        self.name = name
        self.epoch = epoch
        self.preds = list(preds)
        self.pick = int(pick)
        self.access = access        # "hash" | "sorted" (explain provenance)

    def params(self):
        return (self.name, self.epoch, _preds_sig(self.preds), self.pick,
                self.access)

    def run(self, ctx, *inputs):
        t = ctx.db.tables[self.name]
        im = getattr(ctx.db, "_index_manager", None)
        rows = im.lookup(self.name, self.preds[self.pick]) if im else None
        if rows is None:            # index gone: degrade, don't fail
            for pred in self.preds:
                t = t.take(np.nonzero(t.eval_predicate(pred))[0])
            return t
        rows = np.sort(rows)        # scan row order, deterministically
        for i, pred in enumerate(self.preds):
            if i != self.pick and len(rows):
                rows = rows[t.eval_predicate(pred, rows=rows)]
        traversal.COUNTERS.record_fetches += len(rows) * max(len(self.preds), 1)
        return t.take(rows)

    def describe(self):
        return (f"IndexScan[{self.name}: {self.preds[self.pick]!r} "
                f"via {self.access}]")


class IndexSelect(PhysicalOp):
    """Zone-map skip-scan access path: the picked predicate is evaluated
    chunk-wise through the column's zone maps (non-candidate chunks are
    never read), remaining predicates point-evaluate on the survivors.
    Effective when the column is clustered (e.g. monotone keys), where
    min/max pruning touches O(hits) chunks."""
    kind = "IndexSelect"

    def __init__(self, name: str, epoch: int, preds: list, pick: int):
        super().__init__()
        self.name = name
        self.epoch = epoch
        self.preds = list(preds)
        self.pick = int(pick)
        self.access = "zone"

    def params(self):
        return (self.name, self.epoch, _preds_sig(self.preds), self.pick)

    def run(self, ctx, *inputs):
        t = ctx.db.tables[self.name]
        im = getattr(ctx.db, "_index_manager", None)
        rows = im.zone_rows(self.name, self.preds[self.pick]) if im else None
        if rows is None:            # zones gone: degrade, don't fail
            for pred in self.preds:
                t = t.take(np.nonzero(t.eval_predicate(pred))[0])
            return t
        for i, pred in enumerate(self.preds):
            if i != self.pick and len(rows):
                rows = rows[t.eval_predicate(pred, rows=rows)]
        traversal.COUNTERS.record_fetches += len(rows) * max(len(self.preds), 1)
        return t.take(rows)

    def describe(self):
        return (f"IndexSelect[{self.name}: {self.preds[self.pick]!r} "
                f"via zone-skip]")


class Alias(PhysicalOp):
    """Qualify column names with the collection name before cluster joins."""
    kind = "Alias"

    def __init__(self, child: PhysicalOp, name: str):
        super().__init__(child)
        self.name = name

    def params(self):
        return (self.name,)

    def run(self, ctx, t: Table):
        return Table(t.name, {f"{self.name}.{k}": v for k, v in t.columns.items()})

    def describe(self):
        return f"Alias[{self.name}]"


class SemiJoinMask(PhysicalOp):
    """Join pushdown (Eq. 9/10): graph ⋈̂ table as a candidate vertex mask
    consumed by MatchPattern — an explicit plan edge, not a monkey-patch."""
    kind = "SemiJoinMask"

    def __init__(self, graph: str, epoch: int, label: str, vcol: str,
                 ocol: str, table_child: PhysicalOp):
        super().__init__(table_child)
        self.graph = graph
        self.epoch = epoch
        self.label = label
        self.vcol = vcol
        self.ocol = ocol

    def params(self):
        return (self.graph, self.epoch, self.label, self.vcol, self.ocol)

    def run(self, ctx, other: Table):
        g = ctx.db.graphs[self.graph]
        return join_mod.semi_join_graph(g, self.label, self.vcol, other, self.ocol)

    def describe(self):
        return f"SemiJoinMask[{self.label}.{self.vcol} ∈ {self.ocol}]"


class SemiJoinReduce(PhysicalOp):
    """The opposite siding of the Eq. 9/10 semi-join: keep the rows of a
    relational/document child whose join column appears among the graph's
    vertex keys. Chosen by the optimizer when the vertex key set is the
    smaller build input (the table side is what shrinks)."""
    kind = "SemiJoinReduce"

    def __init__(self, graph: str, epoch: int, label: str, vcol: str,
                 ocol: str, table_child: PhysicalOp):
        super().__init__(table_child)
        self.graph = graph
        self.epoch = epoch
        self.label = label
        self.vcol = vcol
        self.ocol = ocol

    def params(self):
        return (self.graph, self.epoch, self.label, self.vcol, self.ocol)

    def run(self, ctx, t: Table):
        g = ctx.db.graphs[self.graph]
        mask = join_mod.semi_join_table(t, self.ocol, g, self.label, self.vcol)
        return t.take(np.nonzero(mask)[0])

    def describe(self):
        return f"SemiJoinReduce[{self.ocol} ∈ {self.label}.{self.vcol}]"


class PruneCols(PhysicalOp):
    """Projection sink-down into the scan: drop base-table columns never
    referenced above (join keys, projection, residual predicates), so joins
    and record gathers move fewer bytes."""
    kind = "PruneCols"

    def __init__(self, child: PhysicalOp, cols: tuple):
        super().__init__(child)
        self.cols = tuple(cols)

    def params(self):
        return (self.cols,)

    def run(self, ctx, t: Table):
        return Table(t.name, {c: t.columns[c] for c in self.cols
                              if c in t.columns})

    def describe(self):
        return f"PruneCols[{', '.join(self.cols)}]"


class MatchPattern(PhysicalOp):
    """Hybrid topology+attribute pattern matching (Algorithm 2). Children
    are SemiJoinMask nodes whose masks shrink candidate sets before the
    traversal; ``mask_vars[i]`` names the pattern var mask ``i`` applies to."""
    kind = "MatchPattern"

    def __init__(self, graph: str, epoch: int, pplan, mask_vars: tuple,
                 *mask_children: PhysicalOp):
        super().__init__(*mask_children)
        self.graph = graph
        self.epoch = epoch
        self.pplan = pplan
        self.mask_vars = tuple(mask_vars)

    def params(self):
        return (self.graph, self.epoch, _pattern_sig(self.pplan.pattern),
                _pplan_sig(self.pplan), self.mask_vars)

    def run(self, ctx, *masks):
        g = ctx.db.graphs[self.graph]
        extra: dict = {}
        for var, m in zip(self.mask_vars, masks):
            extra[var] = m if var not in extra else (extra[var] & m)
        return pattern_mod.match(g, self.pplan, extra_masks=extra or None)

    def describe(self):
        p = self.pplan
        d = "rev" if p.reverse else "fwd"
        pushed = ",".join(f"{v}:{len(ps)}" for v, ps in sorted(p.pushed.items())) or "-"
        deferred = ",".join(f"{v}:{len(ps)}" for v, ps in sorted(p.deferred.items())) or "-"
        hops = len(p.pattern.edges)
        return (f"MatchPattern[{self.graph} dir={d} hops={hops} "
                f"pushed={pushed} deferred={deferred}]")


class DeviceMatchPattern(PhysicalOp):
    """Mask-free chain match executed on the accelerator — the third access
    path of the pattern operator, chosen by the optimizer off frontier-size
    and selectivity estimates. ``access`` selects the flavor:
    ``device-pallas`` runs the fused traversal kernel family (zone-filtered
    predicate tables, in-kernel compaction, one launch window per chain);
    ``device-jit`` runs the per-hop ``DevicePatternMatcher``. Falls back to
    the host matcher at runtime if the graph has grown pending deltas since
    planning (the device snapshot reads base CSRs only)."""
    kind = "DeviceMatchPattern"

    def __init__(self, graph: str, epoch: int, pplan,
                 access: str = "device-pallas",
                 capacity: Optional[int] = None):
        super().__init__()
        self.graph = graph
        self.epoch = epoch
        self.pplan = pplan
        self.access = access
        self.capacity = capacity
        # per-execution launch facts (hops, capacity, zone chunks, flavor);
        # merged into the telemetry span
        self.last_kernel_args: Optional[dict] = None

    def params(self):
        return (self.graph, self.epoch, _pattern_sig(self.pplan.pattern),
                _pplan_sig(self.pplan), self.access, self.capacity)

    def run(self, ctx, *inputs):
        from . import pattern_jit
        g = ctx.db.graphs[self.graph]
        if g.delta.has_pending():
            # planned against a compacted snapshot that has since grown
            # deltas: degrade to the host matcher, don't fail
            self.access = "host-fallback"
            return pattern_mod.match(g, self.pplan)
        flavor = "jit" if self.access == "device-jit" else "pallas"
        rel, kargs = pattern_jit.device_match(
            g, self.pplan, flavor=flavor, initial_capacity=self.capacity,
            device=ctx.device)
        self.last_kernel_args = kargs
        return rel

    def describe(self):
        p = self.pplan
        d = "rev" if p.reverse else "fwd"
        pushed = ",".join(f"{v}:{len(ps)}"
                          for v, ps in sorted(p.pushed.items())) or "-"
        cap = f" cap={self.capacity}" if self.capacity else ""
        return (f"DeviceMatchPattern[{self.graph} dir={d} "
                f"hops={len(p.pattern.edges)} pushed={pushed} "
                f"via {self.access}{cap}]")


class TableJoinMatch(PhysicalOp):
    """GredoDB-S ablation: the pattern as k-way edge-table equi-joins (the
    TBS strategy §2.2) with deferred predicates evaluated post-hoc."""
    kind = "TableJoinMatch"

    def __init__(self, graph: str, epoch: int, pattern: Pattern, deferred: dict):
        super().__init__()
        self.graph = graph
        self.epoch = epoch
        self.pattern = pattern
        self.deferred = dict(deferred)

    def params(self):
        return (self.graph, self.epoch, _pattern_sig(self.pattern),
                _pred_map_sig(self.deferred))

    def run(self, ctx, *inputs):
        g = ctx.db.graphs[self.graph]
        rel = join_mod.match_by_joins(g, self.pattern)
        return pattern_mod.apply_deferred(g, self.pattern, rel, self.deferred)

    def describe(self):
        return f"TableJoinMatch[{self.graph} hops={len(self.pattern.edges)}]"


class VertexScan(PhysicalOp):
    """Match trimming case 1 (§6.2): no topology constraint -> record scan."""
    kind = "VertexScan"

    def __init__(self, graph: str, epoch: int, pattern: Pattern, pplan):
        super().__init__()
        self.graph = graph
        self.epoch = epoch
        self.pattern = pattern
        self.pplan = pplan

    def params(self):
        return (self.graph, self.epoch, _pattern_sig(self.pattern),
                _pplan_sig(self.pplan))

    def run(self, ctx, *inputs):
        g = ctx.db.graphs[self.graph]
        var = self.pattern.vertices[0].var
        tbl = g.vertex_tables[self.pattern.vertex(var).label]
        mask = np.ones(tbl.nrows, dtype=bool)
        preds = self.pplan.deferred.get(var, []) if self.pplan else []
        for pred in preds:
            mask &= tbl.eval_predicate(pred)
        return Table(f"match:{self.pattern.graph}", {var: np.nonzero(mask)[0]})

    def describe(self):
        return f"VertexScan[{self.graph}.{self.pattern.vertices[0].var}]"


class EdgeScan(PhysicalOp):
    """Match trimming case 2 (§6.2): v-e-v, edge-only predicates -> edge scan."""
    kind = "EdgeScan"

    def __init__(self, graph: str, epoch: int, pattern: Pattern, pplan):
        super().__init__()
        self.graph = graph
        self.epoch = epoch
        self.pattern = pattern
        self.pplan = pplan

    def params(self):
        return (self.graph, self.epoch, _pattern_sig(self.pattern),
                _pplan_sig(self.pplan))

    def run(self, ctx, *inputs):
        g = ctx.db.graphs[self.graph]
        evar = self.pattern.edges[0].var
        mask = g.live_edge_mask()
        preds = self.pplan.deferred.get(evar, []) if self.pplan else []
        for pred in preds:
            mask &= g.edges.eval_predicate(pred)
        return Table(f"match:{self.pattern.graph}", {evar: np.nonzero(mask)[0]})

    def describe(self):
        return f"EdgeScan[{self.graph}.{self.pattern.edges[0].var}]"


class GraphProject(PhysicalOp):
    """Graph projection π̂_A' (projection trimming): fetch referenced record
    attributes for matched bindings via the tid-based RecordAM."""
    kind = "GraphProject"

    def __init__(self, graph: str, epoch: int, pattern: Pattern, keep: tuple,
                 wanted: dict, child: PhysicalOp):
        super().__init__(child)
        self.graph = graph
        self.epoch = epoch
        self.pattern = pattern
        self.keep = tuple(sorted(keep))
        self.wanted = {v: list(dict.fromkeys(attrs)) for v, attrs in wanted.items()}

    def params(self):
        return (self.graph, self.epoch, self.keep,
                tuple((v, tuple(a)) for v, a in sorted(self.wanted.items())))

    def run(self, ctx, rel: Table):
        g = ctx.db.graphs[self.graph]
        edge_vars = {e.var for e in self.pattern.edges}
        cols: dict[str, np.ndarray] = {}
        for var in self.keep:
            if var not in rel.columns:
                continue
            ids = np.asarray(rel.col(var))
            cols[f"{var}.__id"] = ids
            tbl = (g.edges if var in edge_vars
                   else g.vertex_tables[self.pattern.vertex(var).label])
            for attr in self.wanted.get(var, []):
                col = tbl.col(attr)
                cols[f"{var}.{attr}"] = (col.take(ids) if hasattr(col, "take")
                                         else np.asarray(col)[ids])
                traversal.COUNTERS.record_fetches += len(ids)
        return Table(rel.name, cols if cols else dict(rel.columns))

    def describe(self):
        return f"GraphProject[{self.graph} keep={','.join(self.keep) or '-'}]"


class EquiJoin(PhysicalOp):
    """Cross-model sort-merge equi-join ⋈̂ merging two plan clusters."""
    kind = "EquiJoin"

    def __init__(self, jp: JoinPred, left: PhysicalOp, right: PhysicalOp):
        super().__init__(left, right)
        self.jp = jp

    def params(self):
        return (self.jp.left, self.jp.right)

    def run(self, ctx, lc: Table, rc: Table):
        li, ri = join_mod.equi_join_indices(
            lc, _col_in(lc, self.jp.left), rc, _col_in(rc, self.jp.right))
        lt, rt = lc.take(li), rc.take(ri)
        cols = dict(lt.columns)
        cols.update(rt.columns)
        return Table(f"{lc.name}⋈{rc.name}", cols)

    def describe(self):
        return f"EquiJoin[{self.jp.left}={self.jp.right}]"


class Exchange(PhysicalOp):
    """Partition-exchange: hash-partitions the child's rows on a join key
    into k shards. Inserted under the build side of an EquiJoin by the shard
    planner; the serial executor runs it as the identity (the partition is a
    *view*, not a row shuffle), while the sharded executor materializes —
    or reuses, when a co-partitioned build from an earlier query at the same
    epoch is cached — the per-shard sorted key runs the join probes bind to."""
    kind = "Exchange"

    def __init__(self, child: PhysicalOp, key: str, k: int):
        super().__init__(child)
        self.key = key
        self.k = int(k)
        self.shards = int(k)

    def params(self):
        return (self.key, self.k)

    def run(self, ctx, t: Table):
        return t

    def describe(self):
        return f"Exchange[{self.key} -> {self.k}p]"


class IntraFilter(PhysicalOp):
    """Join predicate whose sides already live in one cluster: a row filter."""
    kind = "IntraFilter"

    def __init__(self, jp: JoinPred, child: PhysicalOp):
        super().__init__(child)
        self.jp = jp

    def params(self):
        return (self.jp.left, self.jp.right)

    def run(self, ctx, t: Table):
        lv = np.asarray(t.col(_col_in(t, self.jp.left)))
        rv = np.asarray(t.col(_col_in(t, self.jp.right)))
        return t.take(np.nonzero(lv == rv)[0])

    def describe(self):
        return f"IntraFilter[{self.jp.left}={self.jp.right}]"


class Residual(PhysicalOp):
    """σ_Ψ residue: predicates evaluated on the joined relation."""
    kind = "Residual"

    def __init__(self, preds: list, child: PhysicalOp):
        super().__init__(child)
        self.preds = list(preds)

    def params(self):
        return _preds_sig(self.preds)

    def run(self, ctx, t: Table):
        for pred in self.preds:
            col = _col_in(t, pred.attr)
            mask = t.eval_predicate(dataclasses.replace(pred, attr=f"x.{col}"))
            t = t.take(np.nonzero(mask)[0])
        return t

    def describe(self):
        return f"Residual[{', '.join(repr(p) for p in self.preds)}]"


class Project(PhysicalOp):
    """π_A final projection — the GCDI root. Its signature embeds the write
    epoch of *every* collection the task reads, so it is the structural-match
    reuse point for the materialized GCDI relation. Cacheable."""
    kind = "Project"
    cacheable = True

    def __init__(self, select: tuple, epochs: tuple, child: PhysicalOp):
        super().__init__(child)
        self.select = tuple(select)
        self.epochs = tuple(epochs)

    def params(self):
        return (self.select, self.epochs)

    def run(self, ctx, t: Table):
        cols = {}
        for a in self.select:
            cols[a] = t.col(_col_in(t, a))
        return Table("result", cols)

    def describe(self):
        return f"Project[{', '.join(self.select)}]"


# ---------------------------------------------------------------------------
# GCDA operators (matrix generation G + analytical operators A, Eq. 5)
# ---------------------------------------------------------------------------


class Rel2Matrix(PhysicalOp):
    """REL2MATRIX local access: columnar GCDI columns -> (n, k) device matrix."""
    kind = "Rel2Matrix"
    cacheable = True

    def __init__(self, columns, child: PhysicalOp):
        super().__init__(child)
        self.columns = tuple(columns)

    def params(self):
        return (self.columns,)

    def run(self, ctx, rel: Table):
        return analytics.rel2matrix(rel, self.columns, device=ctx.device)

    def describe(self):
        return f"Rel2Matrix[{', '.join(self.columns)}]"


class RandomAccessMatrix(PhysicalOp):
    """Random access: aggregate multi-valued attributes of qualifying records
    into per-group multi-hot / count feature rows."""
    kind = "RandomAccessMatrix"
    cacheable = True

    def __init__(self, group_col: str, value_col: str, n_features: int,
                 child: PhysicalOp):
        super().__init__(child)
        self.group_col = group_col
        self.value_col = value_col
        self.n_features = int(n_features)

    def params(self):
        return (self.group_col, self.value_col, self.n_features)

    def run(self, ctx, rel: Table):
        m, _ = analytics.random_access_matrix(
            rel, self.group_col, self.value_col, self.n_features,
            device=ctx.device)
        return m

    def describe(self):
        return (f"RandomAccessMatrix[{self.group_col} x {self.value_col} "
                f"-> {self.n_features}f]")


class Const(PhysicalOp):
    """Literal matrix input."""
    kind = "Const"

    def __init__(self, value):
        super().__init__()
        self.value = value
        arr = np.asarray(value)
        # content digest computed once — signatures stay O(1) per build
        self._digest = (str(arr.dtype), arr.shape, fingerprint(arr.tobytes()))

    def params(self):
        return self._digest

    def run(self, ctx, *inputs):
        return torch.as_tensor(np.asarray(self.value), device=ctx.device)

    def describe(self):
        return f"Const[{np.asarray(self.value).shape}]"


class MatMul(PhysicalOp):
    """MULTIPLY via the tiled matmul kernel; one child means the Gram
    product (``x.T`` is passed as a view; the kernel reads it in place)."""
    kind = "MatMul"
    cacheable = True

    def __init__(self, use_kernel, lhs: PhysicalOp, rhs: Optional[PhysicalOp] = None):
        super().__init__(*([lhs] if rhs is None else [lhs, rhs]))
        self.use_kernel = use_kernel
        self.gram = rhs is None

    def params(self):
        return (self.gram, self.use_kernel)

    def run(self, ctx, x, y=None):
        rhs = x.T if y is None else y
        return analytics.multiply(x, rhs, use_kernel=self.use_kernel)

    def describe(self):
        return "MatMul[gram]" if self.gram else "MatMul"


class Similarity(PhysicalOp):
    """SIMILARITY: pairwise cosine scores via the fused kernel."""
    kind = "Similarity"
    cacheable = True

    def __init__(self, use_kernel, lhs: PhysicalOp, rhs: Optional[PhysicalOp] = None):
        super().__init__(*([lhs] if rhs is None else [lhs, rhs]))
        self.use_kernel = use_kernel
        self.self_sim = rhs is None

    def params(self):
        return (self.self_sim, self.use_kernel)

    def run(self, ctx, x, y=None):
        return analytics.similarity(x, x if y is None else y,
                                    use_kernel=self.use_kernel)

    def describe(self):
        return "Similarity[self]" if self.self_sim else "Similarity"


class Regression(PhysicalOp):
    """REGRESSION: logistic regression with the fused gradient kernel."""
    kind = "Regression"
    cacheable = True

    def __init__(self, iters: int, use_kernel, x: PhysicalOp, y: PhysicalOp):
        super().__init__(x, y)
        self.iters = int(iters)
        self.use_kernel = use_kernel

    def params(self):
        return (self.iters, self.use_kernel)

    def run(self, ctx, x, y):
        return analytics.regression(x, y.reshape(-1), iters=self.iters,
                                    use_kernel=self.use_kernel)[0]

    def describe(self):
        return f"Regression[iters={self.iters}]"


# ---------------------------------------------------------------------------
# DAG construction: GCDIPlan -> operator DAG (planner steps 1-5)
# ---------------------------------------------------------------------------


def _col_in(t: Table, attr: str) -> str:
    if attr in t.columns:
        return attr
    if "." in attr:
        bare = attr.split(".", 1)[1]
        if bare in t.columns:
            return bare
    raise KeyError(f"{attr} not in {list(t.columns)[:12]}...")


def _static_has_col(cols: set, attr: str) -> bool:
    """Static mirror of ``_col_in`` over a predicted column-name set."""
    return attr in cols or ("." in attr and attr.split(".", 1)[1] in cols)


def _key_source(q: Query, pattern: Optional[Pattern], attr: str):
    """Resolve a join attribute to its backing base collection, for NDV
    lookup: ("table", name, col) | ("vertex", graph, label, col) |
    ("edge", graph, col) | None."""
    coll, _, col = attr.partition(".")
    if not col:
        return None
    if coll in q.froms:
        return ("table", coll, col)
    if pattern is not None:
        for v in pattern.vertices:
            if v.var == coll:
                return ("vertex", pattern.graph, v.label, col)
        for e in pattern.edges:
            if e.var == coll:
                return ("edge", pattern.graph, col)
    return None


def resolve_key_stats(db: Database, src):
    """ColumnStats of a ``_key_source`` result against the live catalog
    (merged base ⊕ delta views), or None."""
    try:
        if src is None:
            return None
        if src[0] == "table":
            return db.tables[src[1]].stats(src[2])
        if src[0] == "vertex":
            return db.graphs[src[1]].vertex_tables[src[2]].stats(src[3])
        if src[0] == "edge":
            return db.graphs[src[1]].edges.stats(src[2])
    except KeyError:
        return None
    return None


def catalog_epochs(db: Database) -> tuple:
    """Write-epoch snapshot of every collection in the catalog — the key
    that gates reuse of cached §6.3 estimates across planner invocations
    (a delta-store append bumps its source epoch and invalidates them)."""
    names = sorted(set(db.tables) | set(db.graphs))
    return tuple((n, db.epoch_of(n)) for n in names)


def pick_connected_cluster(clusters: list, needed: list):
    """Select the cluster (node, column-set pairs) covering every needed
    attribute when joins left more than one behind. Raises on a genuinely
    disconnected query — never silently drops result columns."""
    scored = sorted(
        ((sum(1 for a in needed if _static_has_col(cols, a)), i)
         for i, (_, cols) in enumerate(clusters)),
        key=lambda t: (-t[0], t[1]))
    if scored[0][0] < len(needed):
        raise ValueError("query is disconnected: projection attributes "
                         "span un-joined collections")
    return clusters[scored[0][1]][0]


# Distribution-aware join estimation toggle. True (default): per-key /
# per-bucket overlap of the two key distributions (ColumnStats.join_overlap)
# with NDV containment only as fallback. False: the pre-histogram NDV-only
# model — kept as the measurable baseline for q-error regressions
# (benchmarks/run.py --suite optimizer toggles it to report both).
HIST_JOIN_EST = True


def est_join_rows(nl: float, nr: float, ls, rs) -> float:
    return est_join_rows_detail(nl, nr, ls, rs)[0]


def est_join_rows_detail(nl: float, nr: float, ls, rs) -> tuple[float, str]:
    """|L ⋈ R| with estimate provenance, as ``(rows, how)``.

    Distribution-aware path: ``ls.join_overlap(rs)`` gives the expected
    matches between the two *base* key columns (exact per-value products for
    MCV/dict columns, per-equi-width-bucket-pair overlap otherwise); the
    filtered-input selectivities are threaded into those bucket counts by
    scaling with ``(nl / |L_base|) · (nr / |R_base|)`` — the fraction of
    each base side actually flowing into the join (uniform-filter
    assumption; fan-out of earlier joins scales the same way, > 1).

    Fallback (``how == "ndv"``): uniform-key containment nl·nr / max(ndv)
    with NDVs capped by the (possibly filtered) input cardinalities; when
    neither key resolves to base statistics, max(nl, nr)."""
    if (HIST_JOIN_EST and ls is not None and rs is not None
            and ls.n and rs.n):
        ov = ls.join_overlap(rs)
        if ov is not None:
            matches, how = ov
            return matches * (nl / ls.n) * (nr / rs.n), how
    ndvs = []
    if ls is not None and ls.ndv:
        ndvs.append(min(float(ls.ndv), max(nl, 1.0)))
    if rs is not None and rs.ndv:
        ndvs.append(min(float(rs.ndv), max(nr, 1.0)))
    if not ndvs:
        return float(max(nl, nr)), "no-stats"
    return nl * nr / max(max(ndvs), 1.0), "ndv"


def est_intra_filter_rows(rows: float, ls, rs) -> float:
    """Rows surviving an IntraFilter (a join predicate whose sides already
    live in one cluster): divide by the larger key NDV, clamped to the
    input cardinality; 3.0 default when neither key resolves. The single
    formula shared by :func:`estimate` and the optimizer's join enumerator
    — their costs must agree or the DP picks orders the final cost model
    contradicts."""
    ndv = max((float(s.ndv) for s in (ls, rs) if s is not None), default=3.0)
    return rows / max(min(ndv, max(rows, 1.0)), 1.0)


def build_gcdi(db: Database, p, mode: str = "gredo") -> PhysicalOp:
    """Emit the *naive* physical DAG for a logical GCDIPlan: clusters join
    in query order and graph↔table joins stay post-match equi-joins. The
    dynamic cluster merging of the old executor is simulated statically
    (each collection's output column set is known at plan time); cluster
    roots carry ``out_cols`` and joins carry resolved key sources, which is
    what :func:`repro_torch.core.optimizer.optimize` rewrites against."""
    q: Query = p.query
    pattern = q.match

    # step 1: base tables with pushed selections
    table_nodes: dict[str, PhysicalOp] = {}
    for name in q.froms:
        node: PhysicalOp = ScanTable(name, db.epoch_of(name))
        preds = p.table_pushdown.get(name, [])
        if preds:
            node = Select(node, preds)
        table_nodes[name] = node

    # step 2: graph side
    graph_node: Optional[PhysicalOp] = None
    vars_in_rel: set[str] = set()
    if pattern:
        gname = pattern.graph
        gep = db.epoch_of(gname)
        all_vars = ({v.var for v in pattern.vertices}
                    | {e.var for e in pattern.edges})
        if mode == "single":
            deferred = p.pattern_plan.deferred if p.pattern_plan else {}
            graph_node = TableJoinMatch(gname, gep, pattern, deferred)
            vars_in_rel = all_vars
        elif p.match_trim == "vertex_scan":
            graph_node = VertexScan(gname, gep, pattern, p.pattern_plan)
            vars_in_rel = {pattern.vertices[0].var}
        elif p.match_trim == "edge_scan":
            graph_node = EdgeScan(gname, gep, pattern, p.pattern_plan)
            vars_in_rel = {pattern.edges[0].var}
        else:
            # naive: no semi-join pushdown — Eq. 8 shape. The optimizer
            # makes the cost-based Eq. 9/10 siding decision per candidate.
            graph_node = MatchPattern(gname, gep, p.pattern_plan, ())
            vars_in_rel = all_vars

        # graph projection π̂_A' — static column prediction mirrors run()
        keep = set(p.graph_projection) & vars_in_rel
        wanted: dict[str, list[str]] = {}
        for a in (list(q.select) + [jp.left for jp in q.joins]
                  + [jp.right for jp in q.joins]):
            c = a.split(".", 1)[0]
            if c in keep and "." in a:
                wanted.setdefault(c, []).append(a.split(".", 1)[1])
        graph_node = GraphProject(gname, gep, pattern, tuple(sorted(keep)),
                                  wanted, graph_node)
        graph_cols: set[str] = set()
        for var in sorted(keep):
            graph_cols.add(f"{var}.__id")
            for attr in dict.fromkeys(wanted.get(var, [])):
                graph_cols.add(f"{var}.{attr}")
        if not graph_cols:
            graph_cols = set(vars_in_rel)
        graph_node.out_cols = frozenset(graph_cols)

    # step 3: multi-way joins — static cluster merging in query order
    clusters: list[tuple[PhysicalOp, set[str]]] = []
    if graph_node is not None:
        clusters.append((graph_node, graph_cols))
    for name in q.froms:
        t = db.tables[name]
        alias = Alias(table_nodes[name], name)
        alias.out_cols = frozenset(f"{name}.{k}" for k in t.columns)
        clusters.append((alias, set(alias.out_cols)))

    def _find(attr: str) -> int:
        for ci, (_, cols) in enumerate(clusters):
            if _static_has_col(cols, attr):
                return ci
        raise KeyError(f"join attr {attr} not found in any cluster")

    for jp in q.joins:
        li_c, ri_c = _find(jp.left), _find(jp.right)
        if li_c == ri_c:
            node, cols = clusters[li_c]
            intra = IntraFilter(jp, node)
            intra.key_src = (_key_source(q, pattern, jp.left),
                             _key_source(q, pattern, jp.right))
            clusters[li_c] = (intra, cols)
            continue
        ln, lc = clusters[li_c]
        rn, rc = clusters[ri_c]
        join = EquiJoin(jp, ln, rn)
        join.key_src = (_key_source(q, pattern, jp.left),
                        _key_source(q, pattern, jp.right))
        clusters[min(li_c, ri_c)] = (join, lc | rc)
        del clusters[max(li_c, ri_c)]

    if len(clusters) > 1:
        # disconnected query: keep the cluster holding the projection attrs
        current = pick_connected_cluster(
            clusters, list(q.select) + [pr.attr for pr in p.residual])
    else:
        current = clusters[0][0]

    # step 4: residual predicates
    if p.residual:
        current = Residual(p.residual, current)

    # step 5: final projection — root signature carries every source epoch
    epochs = tuple((n, db.epoch_of(n)) for n in q.source_names())
    root = Project(q.select, epochs, current)
    root.logical = p    # the optimizer rewrites against the logical plan

    # full-coverage schema annotations: every relational node carries the
    # statically inferred out_cols (not just cluster roots and aliases) —
    # what the optimizer's pruning and the plan verifier read
    from . import verify as verify_mod
    verify_mod.annotate_out_cols(root, db)
    return root


def build_gcdia(db: Database, p, task, mode: str = "gredo", *,
                use_kernel=None, iters: int = 100) -> PhysicalOp:
    """Full GCDIA DAG: GCDI root -> matrix generation -> analytical op."""
    gcdi_root = build_gcdi(db, p, mode=mode)
    mats: list[PhysicalOp] = []
    for spec in task.analytics.inputs:
        kind = spec[0]
        if kind == "rel2matrix":
            mats.append(Rel2Matrix(tuple(spec[1]), gcdi_root))
        elif kind == "random":
            mats.append(RandomAccessMatrix(spec[1], spec[2], spec[3], gcdi_root))
        elif kind == "const":
            mats.append(Const(spec[1]))
        else:
            raise ValueError(kind)
    op = task.analytics.op
    if op == "MULTIPLY":
        return MatMul(use_kernel, mats[0], mats[1] if len(mats) > 1 else None)
    if op == "SIMILARITY":
        return Similarity(use_kernel, mats[0], mats[1] if len(mats) > 1 else None)
    if op == "REGRESSION":
        if len(mats) < 2:
            raise ValueError("REGRESSION needs (features, labels)")
        return Regression(iters, use_kernel, mats[0], mats[1])
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Execution: bottom-up walk with signature memoization + inter-buffer reuse
# ---------------------------------------------------------------------------

# Per-operator result-footprint tracking (stats.nbytes / the bytes= explain
# bits). Kept on by default; benchmarks timing bare operator latency may
# disable it.
TRACK_NBYTES = True


def execute(node: PhysicalOp, ctx: ExecContext):
    # The disabled-telemetry path must stay within ~2% of the pre-telemetry
    # executor: every tracing addition below is gated on one local None check.
    trace = ctx.trace
    sig = node.signature()
    if sig in ctx.memo:
        node.stats.memoized = True
        if trace is not None:
            trace.instant(node.kind, detail=node.describe(), cache="memo",
                          rows=node.stats.rows)
        return ctx.memo[sig]
    if ctx.interbuffer is not None and node.cacheable:
        hit = ctx.interbuffer.get(fingerprint(sig))
        if hit is not None:
            node.stats.cached = True
            node.stats.rows = _result_rows(hit)
            node.stats.nbytes = value_nbytes(hit)
            ctx.nodes_reused += 1
            ctx.memo[sig] = hit
            if trace is not None:
                trace.instant(node.kind, detail=node.describe(),
                              cache="interbuffer-hit", rows=node.stats.rows,
                              nbytes=node.stats.nbytes)
            return hit
    if trace is not None:
        # spans open before the child recursion so the parent covers its
        # inputs and the trace nests exactly like the DAG
        gcda = node.kind in telemetry.GCDA_KINDS
        sid = trace.begin(node.kind, cat="gcda" if gcda else "gcdi",
                          detail=node.describe())
    inputs = [execute(c, ctx) for c in node.children]
    t0 = time.perf_counter()
    sh = ctx.shard
    if sh is not None:
        # morsel-parallel path: the runtime handles the kinds it shards and
        # returns its NOT_SHARDED sentinel for everything else (serial run)
        out = sh.run(node, ctx, inputs)
        if out is sh.NOT_SHARDED:
            out = node.run(ctx, *inputs)
    else:
        out = node.run(ctx, *inputs)
    node.stats.seconds += time.perf_counter() - t0
    node.stats.executed = True
    node.stats.rows = _result_rows(out)
    if ctx.interbuffer is not None or TRACK_NBYTES:
        # the footprint walk costs ~10µs/node: always on for the admission
        # policy and (by default) for explain diagnostics; latency
        # microbenchmarks flip TRACK_NBYTES off to time the bare operators
        node.stats.nbytes = value_nbytes(out)
    ctx.nodes_run += 1
    if trace is not None:
        args: dict = {}
        if gcda:
            args["dispatch_s"] = node.stats.seconds
            if ctx.fence_device:
                sync = telemetry.fence(out)
                args["sync_s"] = sync
                node.stats.seconds += sync  # device wait belongs to the op
            extra = getattr(node, "last_kernel_args", None)
            if extra:
                # the traversal's hops, capacity and zone chunks; a
                # born-sharded matrix's shard spec
                args.update(extra)
        if node.stats.rows is not None:
            args["rows"] = node.stats.rows
        if node.stats.nbytes:
            args["nbytes"] = node.stats.nbytes
        est = ctx.ests.get(id(node)) if ctx.ests is not None else None
        if est is not None:
            args["est_rows"] = est[0]
            if node.stats.rows is not None:
                args["q_error"] = telemetry.q_error(est[0], node.stats.rows)
        acc = getattr(node, "access", None)
        if acc is not None:
            args["access"] = acc
        trace.end(sid, **args)
    if ctx.interbuffer is not None and node.cacheable:
        est = ctx.ests.get(id(node)) if ctx.ests is not None else None
        out = ctx.interbuffer.put(fingerprint(sig), out,
                                  est_cost=None if est is None else est[1])
    ctx.memo[sig] = out
    return out


def estimate(root: PhysicalOp, db: Database,
             _cache: Optional[dict] = None) -> dict:
    """Static (est_rows, est_cost) per node, bottom-up, using the §6.3 cost
    model over the live column statistics (NDV, histograms, MCV counts) —
    the numbers the optimizer's DAG rewrites and the cost-aware inter-buffer
    admission key off. ``est_cost`` is *cumulative*: the operator's own cost
    plus that of every *distinct* node in its subtree (shared sub-plans are
    counted once, matching the executor's signature memoization) — i.e. the
    estimated price of recomputing the node from base collections.
    Returns ``{id(node): (est_rows, est_cost)}``.

    ``_cache`` (optional) memoizes per-node results across repeated calls,
    keyed by the node's *signature* — the canonical structural fingerprint
    that embeds every source collection's write epoch. A cached estimate is
    therefore valid for any structurally identical node (across the
    optimizer's candidate plans *and* across queries), and a delta-store
    append changes the source epoch, the signature, and hence the cache
    key — stale cardinalities can never be replayed. The optimizer
    additionally clears its shared cache on any catalog-epoch change
    (``optimizer.optimize``), which garbage-collects entries the new
    signatures would never hit."""
    from . import cost as cost_mod
    rows_of: dict[int, float] = {}     # est rows per node
    own: dict[int, float] = {}         # the operator's own (non-subtree) cost
    cum: dict[int, float] = {}         # dedup-summed subtree cost per node
    nodes: dict[int, PhysicalOp] = {}
    width: dict[int, float] = {}       # est columns of matrix-valued nodes

    def sel(tbl: Table, preds) -> float:
        s = 1.0
        for p in preds:
            s *= tbl.stats(p.column).selectivity(p)
        return s

    def pred_sel(pred) -> float:
        if pred.collection in db.tables:
            return db.tables[pred.collection].stats(pred.column).selectivity(pred)
        return 1.0 / 3.0

    def mask_rows(n: SemiJoinMask, child_rows: float) -> float:
        """Expected candidate vertices a semi-join mask keeps."""
        n_label = float(db.graphs[n.graph].vertex_tables[n.label].nrows)
        os = resolve_key_stats(db, getattr(n, "ocol_src", None))
        keys = min(float(os.ndv), child_rows) if os is not None else child_rows
        return min(n_label, max(keys, 0.0))

    def walk(n: PhysicalOp) -> float:
        if id(n) in rows_of:
            return rows_of[id(n)]
        nodes[id(n)] = n
        if _cache is not None:
            ent = _cache.get(n.signature())
            if ent is not None:
                rows_of[id(n)], own[id(n)], width[id(n)] = ent[0]
                if ent[1] is not None:
                    cum[id(n)] = ent[1]
                if ent[2] is not None:
                    n.est_src = ent[2]
                for c in n.children:    # register descendants for dedup sums
                    walk(c)
                return rows_of[id(n)]
        child_rows = [walk(c) for c in n.children]
        first = child_rows[0] if child_rows else 0.0
        if isinstance(n, ScanTable):
            rows = float(db.tables[n.name].nrows)
            cost = cost_mod.cost_scan(rows)
        elif isinstance(n, Select):
            s = sel(db.tables[n.preds[0].collection], n.preds) if n.preds else 1.0
            rows = first * s
            cost = cost_mod.cost_filter(first, len(n.preds))
        elif isinstance(n, IndexScan):
            tbl = db.tables[n.name]
            nt = float(tbl.nrows)
            sels = [tbl.stats(p.column).selectivity(p) for p in n.preds]
            hits = nt * sels[n.pick]
            rows = nt * float(np.prod(sels)) if sels else nt
            cost = cost_mod.cost_index_lookup(nt, hits)
            if len(n.preds) > 1:    # residual point-evaluation on the hits
                cost += cost_mod.cost_filter(hits, len(n.preds) - 1)
        elif isinstance(n, IndexSelect):
            tbl = db.tables[n.name]
            nt = float(tbl.nrows)
            sels = [tbl.stats(p.column).selectivity(p) for p in n.preds]
            rows = nt * float(np.prod(sels)) if sels else nt
            im = getattr(db, "_index_manager", None)
            idx = (im.get(n.name, n.preds[n.pick].column)
                   if im is not None else None)
            frac = idx.zone_fraction(n.preds[n.pick]) if idx is not None else None
            chunks = (idx.zones.n_chunks
                      if idx is not None and idx.zones is not None else 0.0)
            cost = cost_mod.cost_zone_scan(nt, 1.0 if frac is None else frac,
                                           chunks)
            if len(n.preds) > 1:    # residuals run on every picked-pred hit
                cost += cost_mod.cost_filter(nt * sels[n.pick],
                                             len(n.preds) - 1)
        elif isinstance(n, PruneCols):
            rows = first
            cost = len(n.cols) * cost_mod.COST_CPU
        elif isinstance(n, SemiJoinMask):
            n_label = float(db.graphs[n.graph].vertex_tables[n.label].nrows)
            rows = mask_rows(n, first)
            cost = cost_mod.cost_semijoin(first, n_label)
        elif isinstance(n, SemiJoinReduce):
            g = db.graphs[n.graph]
            n_label = float(g.vertex_tables[n.label].nrows)
            vs = g.vertex_tables[n.label].stats(n.vcol) \
                if n.vcol in g.vertex_tables[n.label].columns else None
            os = resolve_key_stats(db, getattr(n, "ocol_src", None))
            keys = min(float(vs.ndv), n_label) if vs is not None else n_label
            dom = float(os.ndv) if os is not None else max(first, 1.0)
            rows = first * min(1.0, keys / max(dom, 1.0))
            cost = cost_mod.cost_semijoin(first, n_label)
        elif isinstance(n, MatchPattern):
            g = db.graphs[n.graph]
            p = n.pplan
            chain = [p.pattern.vertices[0].var] + [e.dst for e in p.pattern.edges]
            start = chain[-1] if p.reverse else chain[0]
            stbl = g.vertex_tables[p.pattern.vertex(start).label]
            n_start = stbl.nrows * sel(stbl, p.pushed.get(start, []))
            # semi-join candidate masks shrink the start frontier (or filter
            # the result, when the masked var is not the traversal start)
            filter_frac = 1.0
            for var, mchild, crows in zip(n.mask_vars, n.children, child_rows):
                mnode = mchild if isinstance(mchild, SemiJoinMask) else None
                label = p.pattern.vertex(var).label
                n_label = float(g.vertex_tables[label].nrows)
                kept = crows if mnode is not None else n_label
                frac = min(1.0, kept / max(n_label, 1.0))
                if var == start:
                    n_start *= frac
                else:
                    filter_frac *= frac
            hops = len(p.pattern.edges)
            # per-hop, label-aware expansion: each hop's fan-out is the
            # live-edge count over *that hop's* source-label population (the
            # traversal-order chain, so reverse directions and mixed-label
            # paths stop compounding one global average)
            hop_order = chain[::-1] if p.reverse else chain
            fanouts = [g.hop_expansion(reverse=p.reverse,
                                       label=p.pattern.vertex(v).label)
                       for v in hop_order[:-1]]
            expansion = float(np.prod(fanouts)) if fanouts else 1.0
            # end/interior pushed predicates filter the expansion too
            end_sel = 1.0
            for var, ps in p.pushed.items():
                if var == start:
                    continue
                vtbl = (g.edges if any(e.var == var for e in p.pattern.edges)
                        else g.vertex_tables[p.pattern.vertex(var).label])
                end_sel *= sel(vtbl, ps)
            rows = n_start * expansion * filter_frac * end_sel
            # Eq. 11-13 charge per-hop traversal work off one fan-out
            # scalar; feed it the geometric mean of the per-hop values
            gm_fanout = expansion ** (1.0 / hops) if hops else 0.0
            cost = cost_mod.cost_pattern(
                sum(len(ps) for v, ps in p.pushed.items()
                    if not any(e.var == v for e in p.pattern.edges)),
                sum(len(ps) for v, ps in p.pushed.items()
                    if any(e.var == v for e in p.pattern.edges)),
                g.n_vertices, g.n_live_edges, n_start, hops,
                gm_fanout, rows,
                sum(len(ps) for ps in p.deferred.values()))
        elif isinstance(n, DeviceMatchPattern):
            # same cardinality math as MatchPattern (no mask children),
            # priced with the device cost model: vertex predicate tables are
            # columnar scans, edge tables read the zone-candidate fraction
            # only, frontier work runs at vector width, and each launch
            # window pays a fixed dispatch+sync charge (per hop on the jit
            # flavor, once on the fused flavor)
            g = db.graphs[n.graph]
            p = n.pplan
            chain = [p.pattern.vertices[0].var] + [e.dst for e in p.pattern.edges]
            start = chain[-1] if p.reverse else chain[0]
            stbl = g.vertex_tables[p.pattern.vertex(start).label]
            n_start = stbl.nrows * sel(stbl, p.pushed.get(start, []))
            hops = len(p.pattern.edges)
            hop_order = chain[::-1] if p.reverse else chain
            fanouts = [g.hop_expansion(reverse=p.reverse,
                                       label=p.pattern.vertex(v).label)
                       for v in hop_order[:-1]]
            expansion = float(np.prod(fanouts)) if fanouts else 1.0
            end_sel = 1.0
            edge_vset = {e.var for e in p.pattern.edges}
            for var, ps in p.pushed.items():
                if var == start:
                    continue
                vtbl = (g.edges if var in edge_vset
                        else g.vertex_tables[p.pattern.vertex(var).label])
                end_sel *= sel(vtbl, ps)
            rows = n_start * expansion * end_sel
            gm_fanout = expansion ** (1.0 / hops) if hops else 0.0
            zf = 1.0
            im = getattr(db, "_index_manager", None)
            if im is not None and n.access != "device-jit":
                for var, ps in p.pushed.items():
                    if var not in edge_vset:
                        continue
                    for pr in ps:
                        f = im.zone_fraction(n.graph, pr)
                        if f is not None:
                            zf = min(zf, f)
            cost = cost_mod.cost_device_match(
                sum(len(ps) for v, ps in p.pushed.items()
                    if v not in edge_vset),
                sum(len(ps) for v, ps in p.pushed.items()
                    if v in edge_vset),
                g.n_vertices, g.n_live_edges, n_start, hops,
                gm_fanout, rows,
                sum(len(ps) for ps in p.deferred.values()),
                zone_frac=zf, per_hop_sync=(n.access == "device-jit"))
        elif isinstance(n, TableJoinMatch):
            g = db.graphs[n.graph]
            hops = len(n.pattern.edges)
            e = g.n_live_edges
            if hops:
                # k-way edge-table joins: the first edge table contributes
                # |E| rows; every later hop multiplies by the fan-out of its
                # shared chain vertex, label-aware per hop (the pattern's
                # own direction — not the graph-global forward average,
                # which is wrong on reverse traversals of bipartite graphs)
                tchain = ([n.pattern.vertices[0].var]
                          + [ed.dst for ed in n.pattern.edges])
                rows = float(e)
                for v in tchain[1:-1]:
                    rows *= g.hop_expansion(label=n.pattern.vertex(v).label)
            else:
                rows = float(g.vertex_tables[n.pattern.vertices[0].label].nrows)
            cost = sum(cost_mod.cost_join(rows, e) for _ in range(max(hops, 1)))
        elif isinstance(n, VertexScan):
            g = db.graphs[n.graph]
            tbl = g.vertex_tables[n.pattern.vertex(n.pattern.vertices[0].var).label]
            preds = n.pplan.deferred.get(n.pattern.vertices[0].var, []) if n.pplan else []
            rows = tbl.nrows * sel(tbl, preds)
            cost = cost_mod.cost_scan(tbl.nrows)
        elif isinstance(n, EdgeScan):
            g = db.graphs[n.graph]
            preds = n.pplan.deferred.get(n.pattern.edges[0].var, []) if n.pplan else []
            rows = g.edges.nrows * sel(g.edges, preds)
            cost = cost_mod.cost_scan(g.edges.nrows)
        elif isinstance(n, GraphProject):
            rows = first
            cost = cost_mod.cost_project(first, sum(map(len, n.wanted.values())))
        elif isinstance(n, EquiJoin):
            ls, rs = (resolve_key_stats(db, s)
                      for s in getattr(n, "key_src", (None, None)))
            rows, n.est_src = est_join_rows_detail(
                child_rows[0], child_rows[1], ls, rs)
            cost = cost_mod.cost_join(child_rows[0], child_rows[1])
        elif isinstance(n, IntraFilter):
            ls, rs = (resolve_key_stats(db, s)
                      for s in getattr(n, "key_src", (None, None)))
            rows = est_intra_filter_rows(first, ls, rs)
            cost = cost_mod.cost_filter(first)
        elif isinstance(n, Residual):
            s = 1.0
            for pred in n.preds:
                s *= pred_sel(pred)
            rows = first * s
            cost = cost_mod.cost_filter(first, len(n.preds))
        elif isinstance(n, Exchange):
            rows = first
            cost = cost_mod.cost_exchange(first, n.k)
        elif isinstance(n, Rel2Matrix):
            rows = first
            width[id(n)] = float(len(n.columns))
            cost = cost_mod.cost_matrix_gen(first, len(n.columns))
        elif isinstance(n, RandomAccessMatrix):
            rows = first
            width[id(n)] = float(n.n_features)
            cost = cost_mod.cost_matrix_gen(first, n.n_features)
        elif isinstance(n, Const):
            shape = n._digest[1]
            rows = float(shape[0]) if shape else 1.0
            width[id(n)] = float(shape[1]) if len(shape) > 1 else 1.0
            cost = 0.0
        elif isinstance(n, MatMul):
            k = width.get(id(n.children[0]), 1.0)
            m = first if n.gram else width.get(id(n.children[1]), 1.0)
            rows = first
            width[id(n)] = m
            cost = cost_mod.cost_matmul(first, k, m)
        elif isinstance(n, Similarity):
            k = width.get(id(n.children[0]), 1.0)
            m = first if n.self_sim else child_rows[1]
            rows = first
            width[id(n)] = m
            cost = cost_mod.cost_similarity(first, k, m)
        elif isinstance(n, Regression):
            k = width.get(id(n.children[0]), 1.0)
            rows = k
            width[id(n)] = 1.0
            cost = cost_mod.cost_regression(first, k, n.iters)
        else:   # Alias / Project / remaining pass-throughs
            rows = first
            width[id(n)] = width.get(id(n.children[0]), 1.0) if n.children else 1.0
            cost = first * cost_mod.COST_CPU
        rows_of[id(n)] = rows
        own[id(n)] = cost
        if _cache is not None:
            _cache[n.signature()] = [(rows, cost, width.get(id(n), 1.0)),
                                     None, getattr(n, "est_src", None)]
        return rows

    walk(root)

    def cumulative(n: PhysicalOp) -> float:
        """Sum of own costs over the *distinct* nodes of n's subtree —
        shared sub-plans count once, like the executor runs them. Memoized
        per node (and persisted in ``_cache``: a node's subtree cost is
        context-independent)."""
        if id(n) in cum:
            return cum[id(n)]
        seen: set[int] = set()
        total = 0.0
        stack = [n]
        while stack:
            m = stack.pop()
            if id(m) in seen:
                continue
            seen.add(id(m))
            total += own[id(m)]
            stack.extend(m.children)
        cum[id(n)] = total
        if _cache is not None:
            ent = _cache.get(n.signature())
            if ent is not None:
                ent[1] = total
        return total

    return {nid: (rows_of[nid], cumulative(m)) for nid, m in nodes.items()}


def plan_fingerprint(root: PhysicalOp) -> str:
    """Stable 16-hex identity of a plan, derived from the root signature.
    Signatures embed source write-epochs, so the same template re-planned
    after a mutation fingerprints differently — exactly the identity the
    flight recorder wants (a record names *this* plan against *this* data
    version, not the query template)."""
    return fingerprint(root.signature())


def collect_stats(root: PhysicalOp) -> list[dict]:
    """Flatten per-operator stats (pre-order, shared nodes once)."""
    out: list[dict] = []
    seen: set[int] = set()

    def walk(n: PhysicalOp, depth: int):
        if id(n) in seen:
            return
        seen.add(id(n))
        s = n.stats
        out.append({"op": n.kind, "describe": n.describe(), "depth": depth,
                    "rows": s.rows, "nbytes": s.nbytes, "seconds": s.seconds,
                    "executed": s.executed, "cached": s.cached})
        for c in n.children:
            walk(c, depth + 1)

    walk(root, 0)
    return out


def total_seconds(root: PhysicalOp) -> float:
    """Summed per-operator wall seconds over distinct executed nodes —
    ``stats.seconds`` wraps only ``node.run``, so this is self-time and the
    denominator of the ``pct=`` explain bits."""
    return sum(r["seconds"] for r in collect_stats(root) if r["executed"])


def explain(root: PhysicalOp, stats: bool = False,
            db: Optional[Database] = None,
            ests: Optional[dict] = None, top: int = 0) -> str:
    """GCDIPlan.explain()-style rendering of the operator DAG. With
    ``stats=True`` (after execution) each row shows rows/bytes/seconds and
    the operator's share of total plan time, plus whether it was satisfied
    from the inter-buffer; with ``db`` (or a precomputed ``ests`` map) each
    row also shows the §6.3 cost-model estimates — so a post-execution
    rendering puts est_rows next to the actual rows per operator.
    ``top > 0`` appends the k hottest operators sorted by wall seconds."""
    lines: list[str] = []
    seen: dict[int, int] = {}
    if ests is None:
        ests = estimate(root, db) if db is not None else {}
    total = max(total_seconds(root), 1e-12) if stats else 1.0
    hot: list[PhysicalOp] = []

    def walk(n: PhysicalOp, depth: int):
        pad = "  " * depth
        if id(n) in seen:
            lines.append(f"{pad}^shared:{n.describe()}")
            return
        seen[id(n)] = len(lines)
        bits = []
        if stats:
            s = n.stats
            if s.cached:
                bits.append("interbuffer-hit")
            elif s.memoized and not s.executed:
                bits.append("memo")
            if s.rows is not None:
                bits.append(f"rows={s.rows}")
            if s.nbytes:
                bits.append(f"bytes={s.nbytes}")
            if s.executed:
                bits.append(f"ms={s.seconds * 1e3:.2f}")
                bits.append(f"pct={s.seconds / total * 100:.1f}%")
                hot.append(n)
        if id(n) in ests:
            er, ec = ests[id(n)]
            bits.append(f"est_rows={er:.3g}")
            bits.append(f"est_cost={ec:.3g}")
            src = getattr(n, "est_src", None)
            if src is not None:     # join-estimate provenance (per-bucket
                bits.append(f"est_via={src}")   # overlap vs NDV fallback)
        if stats or ests:           # access-path provenance (optimizer's
            acc = getattr(n, "access", None)    # index/zone/full decision)
            if acc is not None:
                bits.append(f"access={acc}")
            shards = getattr(n, "shards", None)  # shard-planner provenance
            if shards is not None:
                bits.append(f"shards={shards}")
        suffix = "  (" + ", ".join(bits) + ")" if bits else ""
        lines.append(f"{pad}{n.describe()}{suffix}")
        for c in n.children:
            walk(c, depth + 1)

    walk(root, 0)
    if stats and top > 0 and hot:
        hot.sort(key=lambda n: n.stats.seconds, reverse=True)
        lines.append(f"== top {min(top, len(hot))} operators by time ==")
        for n in hot[:top]:
            lines.append(f"  {n.describe()}: ms={n.stats.seconds * 1e3:.2f} "
                         f"({n.stats.seconds / total * 100:.1f}%)")
    return "\n".join(lines)
