"""Morsel-parallel sharded execution of the physical operator DAG.

The engine keeps ONE executor (``physical.execute``); sharding enters
through ``ExecContext.shard``. When a :class:`ShardRuntime` is attached, the
executor offers every node to :meth:`ShardRuntime.run`, which either executes
it morsel-parallel over hash/row shards or returns the ``NOT_SHARDED``
sentinel, at which point the serial ``node.run`` fires unchanged. All span /
inter-buffer / memo machinery therefore applies identically to both paths.

Every sharded operator is **bit-for-bit identical** to its serial twin:

* ``Select`` / ``Residual`` / ``IntraFilter`` — per-shard predicate masks are
  ANDed and the table gathered ONCE with the globally-ordered surviving row
  set (contiguous row blocks, so concatenated survivors are in serial order;
  a conjunction of masks selects the same rows as sequential takes).
* ``EquiJoin`` — the build (right) side is hash-partitioned on the join key
  by a stable counting sort, then each shard is stably key-sorted: all rows
  of one key land in one shard with their original relative order, so each
  per-key run is byte-identical to the serially sorted run. Probe morsels
  are contiguous probe-position blocks; the run-expansion formula is the
  serial one, so the (li, ri) pair stream is exactly the serial stream.
  Bounded-range integer keys additionally get a dense direct-address index
  over the partition (O(1) vectorized probes instead of per-shard binary
  search) — same runs, same stream.
* ``MatchPattern`` — ``pattern.prepare_match`` runs once; the hop loop
  (``pattern.expand_chain``) runs per contiguous block of start vertices.
  The serial output is start-major with order preserved across hops, so
  block outputs concatenate to the serial relation.
* ``TableJoinMatch`` — hop-0 edge-row blocks; the k-way join expansion is
  left-major, so blocks concatenate exactly.
* ``Rel2Matrix`` — born-sharded matrix generation: each row block is cast
  and staged to the device independently and the blocks are concatenated
  device-side (``analytics.rel2matrix_sharded``) — the GCDA kernels consume
  the result without a host gather. The sharding spec lands in the
  operator's trace span via ``last_kernel_args``.

The :class:`Exchange` operator (``physical.Exchange``) marks where the build
side of a join is repartitioned. The runtime caches built partitions keyed by
``(child signature fingerprint, key column, k)`` — signatures embed source
write epochs, so a cached partition is valid exactly until the source
mutates, and a repeated join over the same build side skips the shuffle
entirely (the co-partitioned fast path, counted in ``exchanges_reused``).

Worker-pool note: morsels run on a small thread pool (bounded by the host
core count). Correctness never depends on the worker count — results are
reassembled in morsel order — and the speedup on few-core hosts comes from
the *algorithmic* effects above (fused masks with one gather, per-shard sort
runs with shorter binary searches, block-wise device staging), not from
thread concurrency.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from . import analytics
from . import cost as cost_mod
from . import join as join_mod
from . import pattern as pattern_mod
from . import physical as physical_mod
from . import traversal
from .deltastore import expand_runs
from .interbuffer import fingerprint
from .storage import Database, Table, _col_slice, shard_bounds

NOT_SHARDED = object()   # sentinel: "runtime declined, run the serial path"

# node kinds the runtime can execute morsel-parallel (everything else —
# scans, index paths, projections, device kernels — stays serial)
SHARDABLE_KINDS = frozenset({
    "Select", "Residual", "IntraFilter", "EquiJoin", "Exchange",
    "MatchPattern", "TableJoinMatch", "Rel2Matrix",
})


# ---------------------------------------------------------------------------
# Hash partitioning of join build sides
# ---------------------------------------------------------------------------


def hash_shard_ids(keys: np.ndarray, k: int) -> np.ndarray:
    """Shard id per key. Equal keys always map to the same shard — the only
    property the join relies on. Numeric keys hash by value (mod k); string /
    object keys via the process-stable ``hash``."""
    keys = np.asarray(keys)
    if keys.dtype.kind in "iufb":
        return (keys.astype(np.int64) % k).astype(np.int64)
    return np.fromiter((hash(x) % k for x in keys),
                       dtype=np.int64, count=len(keys))


@dataclasses.dataclass
class BuildPartition:
    """Hash-partitioned, per-shard key-sorted build side of an equi-join.

    For bounded-range integer keys (the FK-join common case) the partition
    also carries a dense direct-address index over the key span:
    ``dense_lo[v - kmin]`` / ``dense_cnt[v - kmin]`` locate key ``v``'s run
    inside ``rows_cat`` in O(1) — the probe becomes two vectorized gathers
    instead of a per-shard binary search (a key lives in exactly one shard,
    so each key has exactly one contiguous run). Probing either access path
    yields the identical (li, ri) stream."""

    keys: list            # per-shard key runs, each stably key-sorted
    rows_cat: np.ndarray  # per-shard sorted row ids, concatenated
    base: np.ndarray      # shard s occupies rows_cat[base[s]:base[s+1]]
    k: int
    kmin: int = 0
    dense_lo: Optional[np.ndarray] = None   # global run start per key
    dense_cnt: Optional[np.ndarray] = None  # run length per key

    def rows_per_shard(self) -> np.ndarray:
        return np.diff(self.base)


# dense index budget: key span may exceed the build row count by at most
# this factor (beyond it the direct-address table stops paying for itself)
DENSE_SPAN_FACTOR = 8


def build_partition(tbl: Table, col: str, k: int) -> BuildPartition:
    """Partition ``tbl``'s join-key column into k hash shards. Stable
    counting sort into shard runs, then a stable key sort per shard: every
    key's rows keep their original relative order, so per-key runs match the
    global stable sort byte-for-byte."""
    rk, rrows = join_mod._key_arrays(tbl, col)
    traversal.COUNTERS.cpu_ops += len(rk)
    sh = hash_shard_ids(rk, k)
    perm = np.argsort(sh, kind="stable")        # stable counting sort
    counts = np.bincount(sh, minlength=k)
    base = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=base[1:])
    keys: list = []
    rows_cat = np.empty(len(rk), dtype=np.int64)
    for s in range(k):
        idx = perm[base[s]:base[s + 1]]
        rk_p, rr_p = rk[idx], rrows[idx]
        order = np.argsort(rk_p, kind="stable")
        keys.append(rk_p[order])
        rows_cat[base[s]:base[s + 1]] = rr_p[order]
    part = BuildPartition(keys=keys, rows_cat=rows_cat, base=base, k=k)
    if len(rk) and rk.dtype.kind in "iu":
        kmin, kmax = int(rk.min()), int(rk.max())
        span = kmax - kmin + 1
        if span <= max(DENSE_SPAN_FACTOR * len(rk), 65536):
            keys_cat = np.concatenate(keys)
            starts = np.flatnonzero(
                np.r_[True, keys_cat[1:] != keys_cat[:-1]])
            dense_lo = np.zeros(span, dtype=np.int64)
            dense_lo[(keys_cat[starts] - kmin).astype(np.int64)] = starts
            dense_cnt = np.bincount((rk - kmin).astype(np.int64),
                                    minlength=span)
            part.kmin, part.dense_lo, part.dense_cnt = \
                kmin, dense_lo, dense_cnt
    return part


# ---------------------------------------------------------------------------
# Plan preparation: shard-count choice, annotation, exchange insertion
# ---------------------------------------------------------------------------


def dominant_rows(root: "physical_mod.PhysicalOp", db: Database) -> float:
    """Largest base collection the DAG reads — the input the §6.3 sharded
    cost model weighs against per-shard setup overhead."""
    best, seen, stack = 0.0, set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        name = getattr(n, "name", None)
        if n.kind in ("ScanTable", "IndexScan", "IndexSelect") \
                and name in db.tables:
            best = max(best, float(db.tables[name].nrows))
        gname = getattr(n, "graph", None)
        if gname is not None and gname in db.graphs:
            best = max(best, float(db.graphs[gname].edges.nrows))
        stack.extend(n.children)
    return best


def prepare_plan(root: "physical_mod.PhysicalOp", db: Database, k: int
                 ) -> tuple["physical_mod.PhysicalOp", int]:
    """Cost-gate the shard count, then rewrite the DAG for sharded
    execution: clone every node (the input plan stays untouched), stamp
    ``shards=k`` on shardable kinds, and insert an :class:`Exchange` under
    the build (right) side of every EquiJoin. Returns ``(new_root, k)``;
    ``k == 1`` means serial execution was chosen and ``root`` is returned
    unchanged."""
    k_eff = cost_mod.choose_shard_count(dominant_rows(root, db), k)
    if k_eff <= 1:
        return root, 1
    memo: dict[int, physical_mod.PhysicalOp] = {}

    def rewrite(n: "physical_mod.PhysicalOp") -> "physical_mod.PhysicalOp":
        if id(n) in memo:
            return memo[id(n)]
        m = n.with_children(*[rewrite(c) for c in n.children])
        if m.kind == "EquiJoin":
            ex = physical_mod.Exchange(m.children[1], key=m.jp.right, k=k_eff)
            ex.shards = k_eff
            m = m.with_children(m.children[0], ex)
        if m.kind in SHARDABLE_KINDS:
            m.shards = k_eff
        memo[id(n)] = m
        return m

    new_root = rewrite(root)
    # re-stamp schema annotations on the rewritten DAG (the inserted
    # Exchange nodes carry none; with_children clones keep stale refs)
    from . import verify as verify_mod
    verify_mod.annotate_out_cols(new_root, db)
    return new_root, k_eff


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


class ShardRuntime:
    """Morsel-parallel execution backend attached to ``ExecContext.shard``.

    One instance per engine: the worker pool and the exchange-partition
    cache persist across queries, which is what makes repeated joins over an
    unchanged build side co-partitioned (shuffle-skip)."""

    NOT_SHARDED = NOT_SHARDED
    CACHE_SLOTS = 8     # cached build partitions (LRU)

    def __init__(self, k: int, max_workers: Optional[int] = None):
        self.k = max(int(k), 1)
        self._pool = None
        self._pool_lock = threading.Lock()
        self._max_workers = max_workers or min(self.k, os.cpu_count() or 1)
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._m = {"morsels": 0.0, "queue_wait_s": 0.0,
                   "exchanges_built": 0.0, "exchanges_reused": 0.0,
                   "sharded_ops": 0.0, "serial_fallbacks": 0.0,
                   "rows_shard_max": 0.0, "rows_shard_sum": 0.0,
                   "shard_partitions": 0.0}

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Registry-source snapshot (namespace ``shard.``): morsel counts,
        queue wait, exchange build/reuse, and rows-per-shard skew."""
        with self._lock:
            out = dict(self._m)
        parts = out["shard_partitions"]
        out["rows_shard_mean"] = out["rows_shard_sum"] / parts if parts else 0.0
        return out

    def _bump(self, **kw) -> None:
        with self._lock:
            for name, v in kw.items():
                self._m[name] += v

    def _note_skew(self, rows_per_shard) -> None:
        rows = np.asarray(rows_per_shard, dtype=np.float64)
        if not len(rows):
            return
        with self._lock:
            self._m["rows_shard_max"] = max(self._m["rows_shard_max"],
                                            float(rows.max()))
            self._m["rows_shard_sum"] += float(rows.sum())
            self._m["shard_partitions"] += len(rows)

    # ---------------------------------------------------------- worker pool
    def _ensure_pool(self):
        with self._pool_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="shard-morsel")
            return self._pool

    def _map(self, fn: Callable, items: list) -> list:
        """Run ``fn(*item)`` per item on the pool; results in item order.
        Queue wait (submit -> task start) feeds the ``shard.queue_wait_s``
        metric."""
        if len(items) <= 1:
            self._bump(morsels=float(len(items)))
            return [fn(*it) for it in items]
        pool = self._ensure_pool()

        def timed(item, t_submit):
            self._bump(morsels=1.0,
                       queue_wait_s=time.perf_counter() - t_submit)
            return fn(*item)

        t0 = time.perf_counter()
        futs = [pool.submit(timed, it, t0) for it in items]
        return [f.result() for f in futs]

    def shutdown(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    # ------------------------------------------------------------- dispatch
    def run(self, node, ctx, inputs: list):
        """Executor hook: run ``node`` sharded or return NOT_SHARDED."""
        k = getattr(node, "shards", None)
        if not k or k <= 1 or node.kind not in SHARDABLE_KINDS:
            return NOT_SHARDED
        fn = getattr(self, _DISPATCH[node.kind])
        out = fn(node, ctx, *inputs)
        if out is NOT_SHARDED:
            self._bump(serial_fallbacks=1.0)
        else:
            self._bump(sharded_ops=1.0)
        return out

    # --------------------------------------------------- fused row filters
    def _filter_rows(self, t: Table, k: int, mask_of: Callable) -> Table:
        """Shared core of Select/Residual/IntraFilter: per contiguous row
        block, AND all predicate masks (``mask_of(sub, lo, hi)``) and record
        local survivors; gather the full table ONCE with the concatenated
        (globally ordered) row set."""
        bounds = [b for b in shard_bounds(t.nrows, k) if b[0] < b[1]]

        def task(lo, hi):
            sub = Table(t.name, {c: _col_slice(v, lo, hi)
                                 for c, v in t.columns.items()})
            mask = mask_of(sub, lo, hi)
            return np.nonzero(mask)[0].astype(np.int64) + lo

        parts = self._map(task, bounds)
        self._note_skew([len(p) for p in parts])
        rows = (np.concatenate(parts) if parts
                else np.empty(0, dtype=np.int64))
        return t.take(rows)

    def _run_select(self, node, ctx, t: Table):
        if not node.preds or t.nrows == 0:
            return NOT_SHARDED

        def mask_of(sub: Table, lo, hi):
            mask = sub.eval_predicate(node.preds[0])
            for pred in node.preds[1:]:
                mask = mask & sub.eval_predicate(pred)
            return mask

        return self._filter_rows(t, node.shards, mask_of)

    def _run_residual(self, node, ctx, t: Table):
        if not node.preds or t.nrows == 0:
            return NOT_SHARDED
        # resolve prefixed attrs against the joined relation once
        preds = [dataclasses.replace(
            p, attr=f"x.{physical_mod._col_in(t, p.attr)}")
            for p in node.preds]

        def mask_of(sub: Table, lo, hi):
            mask = sub.eval_predicate(preds[0])
            for pred in preds[1:]:
                mask = mask & sub.eval_predicate(pred)
            return mask

        return self._filter_rows(t, node.shards, mask_of)

    def _run_intrafilter(self, node, ctx, t: Table):
        if t.nrows == 0:
            return NOT_SHARDED
        lv = np.asarray(t.col(physical_mod._col_in(t, node.jp.left)))
        rv = np.asarray(t.col(physical_mod._col_in(t, node.jp.right)))

        def mask_of(sub: Table, lo, hi):
            return lv[lo:hi] == rv[lo:hi]

        return self._filter_rows(t, node.shards, mask_of)

    # ------------------------------------------------------------ exchange
    def _partition_key(self, child_node, col: str, k: int) -> tuple:
        return (fingerprint(child_node.signature()), col, k)

    def _partition_for(self, key: tuple, tbl: Table, col: str, k: int,
                       count_reuse: bool = True) -> BuildPartition:
        with self._lock:
            part = self._cache.get(key)
            if part is not None:
                self._cache.move_to_end(key)
        if part is not None:
            if count_reuse:
                self._bump(exchanges_reused=1.0)
            return part
        part = build_partition(tbl, col, k)
        self._bump(exchanges_built=1.0)
        self._note_skew(part.rows_per_shard())
        with self._lock:
            self._cache[key] = part
            while len(self._cache) > self.CACHE_SLOTS:
                self._cache.popitem(last=False)
        return part

    def _run_exchange(self, node, ctx, t: Table):
        """Materialize (or reuse) the build partition; the operator's output
        is the unchanged child table — the partition is a side structure the
        parent EquiJoin binds to through the cache."""
        col = physical_mod._col_in(t, node.key)
        self._partition_for(self._partition_key(node.children[0], col, node.k),
                            t, col, node.k)
        return t

    # ------------------------------------------------------------ equi-join
    def _run_equijoin(self, node, ctx, lc: Table, rc: Table):
        k = node.shards
        lcol = physical_mod._col_in(lc, node.jp.left)
        rcol = physical_mod._col_in(rc, node.jp.right)
        rchild = node.children[1]
        if rchild.kind == "Exchange":
            key = self._partition_key(rchild.children[0], rcol, rchild.k)
        else:
            key = self._partition_key(rchild, rcol, k)
        # binding to the partition the Exchange child just built is not a
        # co-partition skip — only Exchange-level cache hits count as reuse
        part = self._partition_for(key, rc, rcol, k, count_reuse=False)

        lk, lrows = join_mod._key_arrays(lc, lcol)
        traversal.COUNTERS.cpu_ops += len(lk)
        morsel = max(int(cost_mod.MORSEL_ROWS), 1)
        bounds = [(m0, min(m0 + morsel, len(lk)))
                  for m0 in range(0, len(lk), morsel)]

        use_dense = part.dense_lo is not None and lk.dtype.kind in "iu"

        def probe(m0, m1):
            lk_m = lk[m0:m1]
            if use_dense:
                # direct-address fast path: two gathers locate each probe
                # key's (global) run in rows_cat — no hashing, no search
                idx = lk_m.astype(np.int64) - part.kmin
                valid = (idx >= 0) & (idx < len(part.dense_lo))
                idx = np.where(valid, idx, 0)
                lo_m = part.dense_lo[idx]
                cnt_m = np.where(valid, part.dense_cnt[idx], 0)
                l_rep, slots = expand_runs(lo_m, cnt_m)
                return lrows[m0 + l_rep], part.rows_cat[slots]
            sh_m = hash_shard_ids(lk_m, k)
            lo_m = np.zeros(len(lk_m), dtype=np.int64)
            cnt_m = np.zeros(len(lk_m), dtype=np.int64)
            for s in range(k):
                sel = sh_m == s
                if not sel.any():
                    continue
                ks = part.keys[s]
                lo = np.searchsorted(ks, lk_m[sel], side="left")
                hi = np.searchsorted(ks, lk_m[sel], side="right")
                lo_m[sel] = lo
                cnt_m[sel] = hi - lo
            # serial run-expansion formula: probe-position-major, run order
            l_rep, pos = expand_runs(lo_m, cnt_m)
            li = lrows[m0 + l_rep]
            ri = part.rows_cat[part.base[sh_m[l_rep]] + pos]
            return li, ri

        parts = self._map(probe, bounds) if bounds else []
        if parts:
            li = np.concatenate([p[0] for p in parts])
            ri = np.concatenate([p[1] for p in parts])
        else:
            li = ri = np.empty(0, dtype=np.int64)
        traversal.COUNTERS.cpu_ops += len(li)
        lt, rt = lc.take(li), rc.take(ri)
        cols = dict(lt.columns)
        cols.update(rt.columns)
        return Table(f"{lc.name}⋈{rc.name}", cols)

    # ------------------------------------------------------- pattern match
    def _run_match(self, node, ctx, *masks):
        g = ctx.db.graphs[node.graph]
        extra: dict = {}
        for var, m in zip(node.mask_vars, masks):
            extra[var] = m if var not in extra else (extra[var] & m)
        st = pattern_mod.prepare_match(g, node.pplan,
                                       extra_masks=extra or None)
        starts = np.asarray(st.start_nids)
        if len(starts) == 0:
            return NOT_SHARDED
        st.materialize_members()    # force lazy masks before worker fan-out
        bounds = [b for b in shard_bounds(len(starts), node.shards)
                  if b[0] < b[1]]

        def task(lo, hi):
            return pattern_mod.expand_chain(g, st, starts[lo:hi])

        parts = self._map(task, bounds)
        self._note_skew([len(next(iter(p.values()))) if p else 0
                         for p in parts])
        cols = {var: np.concatenate([p[var] for p in parts])
                for var in parts[0]}
        rel = Table(f"match:{node.pplan.pattern.graph}", cols)
        return pattern_mod.apply_deferred(g, node.pplan.pattern, rel,
                                          node.pplan.deferred)

    # ------------------------------------------------- table-join ablation
    def _run_tablejoinmatch(self, node, ctx):
        g = ctx.db.graphs[node.graph]
        pat = node.pattern
        chain = [pat.vertices[0].var] + [e.dst for e in pat.edges]
        evars = [e.var for e in pat.edges]
        if not evars:
            return NOT_SHARDED
        live = g.live_edge_ids()
        svid = np.asarray(g.edges.col("svid"))
        tvid = np.asarray(g.edges.col("tvid"))
        if g.delta.n_tombstones:
            svid, tvid = svid[live], tvid[live]
        if len(svid) == 0:
            return NOT_SHARDED
        traversal.COUNTERS.record_fetches += 2 * len(svid) * len(evars)
        order = np.argsort(svid, kind="stable")
        svid_s = svid[order]
        bounds = [b for b in shard_bounds(len(svid), node.shards)
                  if b[0] < b[1]]

        def task(lo, hi):
            cols = {chain[0]: svid[lo:hi], evars[0]: live[lo:hi],
                    chain[1]: tvid[lo:hi]}
            cur = Table("join0", cols)
            work = 0
            for h in range(1, len(evars)):
                tail = np.asarray(cur.col(chain[h]))
                lo_ = np.searchsorted(svid_s, tail, side="left")
                hi_ = np.searchsorted(svid_s, tail, side="right")
                l_rep, pos = expand_runs(lo_, hi_ - lo_)
                work += len(pos)
                rows = order[pos]
                ncols = {c: np.asarray(v)[l_rep]
                         for c, v in cur.columns.items()}
                ncols[evars[h]] = live[rows]
                ncols[chain[h + 1]] = tvid[rows]
                cur = Table(f"join{h}", ncols)
            return cur, work

        parts = self._map(task, bounds)
        work = sum(w for _, w in parts)
        traversal.COUNTERS.cpu_ops += work
        traversal.COUNTERS.record_fetches += work
        self._note_skew([p.nrows for p, _ in parts])
        cols = {c: np.concatenate([np.asarray(p.columns[c])
                                   for p, _ in parts])
                for c in parts[0][0].columns}
        rel = Table(f"join{len(evars) - 1}", cols)
        return pattern_mod.apply_deferred(g, pat, rel, node.deferred)

    # -------------------------------------------------- born-sharded GCDA
    def _run_rel2matrix(self, node, ctx, rel: Table):
        if rel.nrows == 0:
            return NOT_SHARDED
        mat, spec = analytics.rel2matrix_sharded(rel, node.columns,
                                                 node.shards,
                                                 device=ctx.device)
        self._note_skew(spec.pop("rows_per_block", []))
        node.last_kernel_args = spec    # -> merged into the GCDA trace span
        return mat


_DISPATCH = {
    "Select": "_run_select",
    "Residual": "_run_residual",
    "IntraFilter": "_run_intrafilter",
    "EquiJoin": "_run_equijoin",
    "Exchange": "_run_exchange",
    "MatchPattern": "_run_match",
    "TableJoinMatch": "_run_tablejoinmatch",
    "Rel2Matrix": "_run_rel2matrix",
}
