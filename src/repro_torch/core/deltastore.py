"""LSM-style delta store for graph mutations (write-path subsystem).

The paper's staged insertion protocol (§4.4) keeps record and topology
storage consistent, but a naive implementation pays a full O(V+E) topology
rebuild per write batch. This module absorbs mutations in side structures so
that every write is O(batch):

* pending vertex rows are buffered per label (columnar run lists);
* pending edges become immutable :class:`EdgeSegment` sorted runs — small
  delta-CSR segments, one per insert batch, queried by binary search
  (forward and reverse);
* deleted edges are tombstoned in a bitmap over the edge-tid space.

Reads are *base ⊕ delta*: the owning :class:`~repro_torch.core.storage.Graph`
consults its base CSRs plus every delta segment, minus tombstones
(``Graph.expand``), and merges pending record runs into its tables lazily
(cached until the next write). A size/cost-triggered :meth:`Graph.compact`
folds the delta into a fresh base — the only place a full rebuild remains,
now amortized over many batches (the memtable/sorted-run design of LSM
engines, adapted to CSR topology storage).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from .storage import Graph


# ---------------------------------------------------------------------------
# Write-path cost accounting (consumed by benchmarks/update_bench.py)
# ---------------------------------------------------------------------------


WRITE_COUNTER_FIELDS = ("write_batches", "write_rows", "write_ops",
                        "compactions", "compact_ops")


class WriteCounters:
    """Elementary-op counters separating the O(batch) write path from the
    amortized O(V+E) compaction work, so benchmarks/tests can assert that the
    hot path never performs rebuild-scale work. Each :class:`~repro_torch.core.
    storage.Graph` owns one (``graph.write_counters``); the engine registers
    them into its telemetry registry as pull sources via :meth:`metrics`."""

    def __init__(self):
        self.write_batches = 0
        self.write_rows = 0
        self.write_ops = 0      # ops charged on insert/delete (O(batch log batch))
        self.compactions = 0
        self.compact_ops = 0    # ops charged by compaction (O(V+E))

    def bump(self, **ops) -> None:
        for k, v in ops.items():
            setattr(self, k, getattr(self, k) + v)

    def metrics(self) -> dict:
        return {f: getattr(self, f) for f in WRITE_COUNTER_FIELDS}

    def reset(self):
        self.__init__()


# Write counters live per graph (``Graph.write_counters``); engines expose
# them through the registry as ``deltastore.<graph>.<field>``. The former
# process-global ``WRITE_COUNTERS`` alias is gone — it leaked state across
# Database instances and tests.


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeltaConfig:
    """Compaction policy knobs. A compaction triggers when any bound is
    exceeded after a write (checked in O(1))."""

    min_delta_edges: int = 4096       # floor before the ratio trigger applies
    max_delta_ratio: float = 0.25     # delta edges vs base edges
    max_segments: int = 64            # sorted runs before forced merge
    max_tombstone_frac: float = 0.25  # dead fraction of the edge-tid space
    max_delta_vertices: int = 8192
    auto_compact: bool = True


# ---------------------------------------------------------------------------
# Growable arrays (amortized O(1) append; views are O(1))
# ---------------------------------------------------------------------------


class Growable:
    """Capacity-doubling 1-D array. ``view()`` returns the live prefix; views
    are invalidated by the next reallocating ``append`` (callers re-fetch)."""

    __slots__ = ("_arr", "n")

    def __init__(self, arr: np.ndarray):
        self._arr = np.asarray(arr)
        self.n = len(self._arr)

    def append(self, vals) -> None:
        vals = np.asarray(vals, dtype=self._arr.dtype)
        need = self.n + len(vals)
        if need > len(self._arr):
            cap = max(need, 2 * len(self._arr), 16)
            grown = np.empty(cap, dtype=self._arr.dtype)
            grown[:self.n] = self._arr[:self.n]
            self._arr = grown
        self._arr[self.n:need] = vals
        self.n = need

    def view(self) -> np.ndarray:
        return self._arr[:self.n]

    def __len__(self):
        return self.n


def expand_runs(starts, counts) -> tuple[np.ndarray, np.ndarray]:
    """Expand per-row runs ``[starts[i], starts[i]+counts[i])`` into flat
    slot indices. Returns ``(pos, slots)``: ``pos[j]`` is the row the j-th
    output belongs to, ``slots[j]`` its global slot. The shared core of CSR
    frontier expansion, segment probes, and sort-merge join run expansion."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    pos = np.repeat(np.arange(len(counts)), counts)
    out_off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    slots = np.repeat(np.asarray(starts), counts) + (
        np.arange(total) - np.repeat(out_off[:-1], counts))
    return pos, slots


# ---------------------------------------------------------------------------
# Edge segments: immutable sorted runs (the delta-CSR building block)
# ---------------------------------------------------------------------------


class EdgeSegment:
    """One insert batch as an immutable run, sorted twice: by source nid
    (forward adjacency) and by target nid (reverse). ``neighbors`` answers a
    whole-frontier expansion with two binary searches + a run expansion —
    O(|frontier| log |segment| + output)."""

    __slots__ = ("src_key", "src_dst", "src_eid", "dst_key", "dst_src", "dst_eid")

    def __init__(self, src_nid: np.ndarray, dst_nid: np.ndarray, eid: np.ndarray):
        src_nid = np.asarray(src_nid, dtype=np.int64)
        dst_nid = np.asarray(dst_nid, dtype=np.int64)
        eid = np.asarray(eid, dtype=np.int64)
        order = np.argsort(src_nid, kind="stable")
        self.src_key = src_nid[order]
        self.src_dst = dst_nid[order]
        self.src_eid = eid[order]
        rorder = np.argsort(dst_nid, kind="stable")
        self.dst_key = dst_nid[rorder]
        self.dst_src = src_nid[rorder]
        self.dst_eid = eid[rorder]

    def __len__(self):
        return len(self.src_key)

    def neighbors(self, frontier: np.ndarray, reverse: bool = False
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (pos, dst, eid) where ``pos`` indexes into ``frontier``."""
        if reverse:
            key, val, eid = self.dst_key, self.dst_src, self.dst_eid
        else:
            key, val, eid = self.src_key, self.src_dst, self.src_eid
        lo = np.searchsorted(key, frontier, side="left")
        hi = np.searchsorted(key, frontier, side="right")
        pos, slots = expand_runs(lo, hi - lo)
        return pos, val[slots], eid[slots]

    def range_view(self, lo: int, hi: int, reverse: bool = False
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Zero-copy sub-run of edges whose (source, or target when
        ``reverse``) nid lies in ``[lo, hi)`` — the per-partition view of
        this delta segment. Both sort orders are precomputed, so a
        partition's slice is two binary searches; returns
        ``(key, other_endpoint, eid)`` views into the sorted run."""
        if reverse:
            key, val, eid = self.dst_key, self.dst_src, self.dst_eid
        else:
            key, val, eid = self.src_key, self.src_dst, self.src_eid
        a = int(np.searchsorted(key, lo, side="left"))
        b = int(np.searchsorted(key, hi, side="left"))
        return key[a:b], val[a:b], eid[a:b]


# ---------------------------------------------------------------------------
# The per-graph delta store
# ---------------------------------------------------------------------------


class GraphDelta:
    """Pending mutations of one :class:`Graph` since its last compaction.

    Record side: per-label vertex runs + edge-row runs (merged lazily into
    the graph's table views). Topology side: :class:`EdgeSegment` runs plus a
    tombstone bitmap over the edge-tid space. New vertices receive nids
    appended after the base nid space (the base label-block layout is only
    restored by compaction, which re-sorts labels into contiguous blocks).
    """

    def __init__(self, n_base_edges: int):
        self.vertex_rows: dict[str, dict[str, list]] = {}  # label -> col -> [runs]
        self.n_new_vertices: dict[str, int] = {}
        self.new_nids: dict[str, Growable] = {}            # label -> nids of new vertices
        self.segments: list[EdgeSegment] = []
        self.edge_rows: dict[str, list] = {}               # col -> [runs]
        self.n_new_edges = 0
        self.tombstone = Growable(np.zeros(n_base_edges, dtype=bool))
        self.n_tombstones = 0

    # ---- vertex side ----
    def buffer_vertices(self, label: str, columns: dict[str, np.ndarray],
                        nids: np.ndarray) -> None:
        runs = self.vertex_rows.setdefault(label, {})
        for k, v in columns.items():
            runs.setdefault(k, []).append(v)
        self.n_new_vertices[label] = self.n_new_vertices.get(label, 0) + len(nids)
        if label not in self.new_nids:
            self.new_nids[label] = Growable(np.zeros(0, dtype=np.int64))
        self.new_nids[label].append(nids)

    def label_new_nids(self, label: str) -> Optional[np.ndarray]:
        g = self.new_nids.get(label)
        return g.view() if g is not None and g.n else None

    @property
    def n_new_vertices_total(self) -> int:
        return sum(self.n_new_vertices.values())

    # ---- edge side ----
    def buffer_edges(self, columns: dict[str, np.ndarray],
                     segment: EdgeSegment) -> None:
        for k, v in columns.items():
            self.edge_rows.setdefault(k, []).append(v)
        self.segments.append(segment)
        self.n_new_edges += len(segment)
        self.tombstone.append(np.zeros(len(segment), dtype=bool))

    def tombstone_edges(self, edge_tids: np.ndarray) -> int:
        tids = np.unique(np.asarray(edge_tids))  # dedupe: count each tid once
        t = self.tombstone.view()
        fresh = int((~t[tids]).sum())
        t[tids] = True
        self.n_tombstones += fresh
        return fresh

    def live_mask_for(self, eids: np.ndarray) -> np.ndarray:
        return ~self.tombstone.view()[eids]

    def live_edge_mask(self) -> np.ndarray:
        return ~self.tombstone.view()

    # ---- bookkeeping ----
    def has_pending(self) -> bool:
        return bool(self.segments or self.n_tombstones
                    or any(self.n_new_vertices.values()))

    def stats(self) -> dict:
        return {
            "segments": len(self.segments),
            "delta_edges": self.n_new_edges,
            "delta_vertices": self.n_new_vertices_total,
            "tombstones": self.n_tombstones,
        }


def should_compact(cfg: DeltaConfig, delta: GraphDelta, n_base_edges: int) -> bool:
    if not cfg.auto_compact:
        return False
    if len(delta.segments) > cfg.max_segments:
        return True
    if delta.n_new_edges > max(cfg.min_delta_edges,
                               cfg.max_delta_ratio * max(n_base_edges, 1)):
        return True
    total_e = n_base_edges + delta.n_new_edges
    if total_e and delta.n_tombstones > cfg.max_tombstone_frac * total_e:
        return True
    if delta.n_new_vertices_total > cfg.max_delta_vertices:
        return True
    return False


# ---------------------------------------------------------------------------
# Incremental merged record views: capacity-doubling column buffers
# ---------------------------------------------------------------------------


def _promote(buf: Growable, run_dtype) -> Growable:
    """Dtype promotion (e.g. a float batch into an int column): one O(n)
    re-seed, matching np.concatenate semantics — Growable.append alone would
    silently cast/truncate to the buffer dtype."""
    promoted = np.result_type(buf.view().dtype, run_dtype)
    if promoted != buf.view().dtype:
        return Growable(buf.view().astype(promoted))
    return buf


class ColumnMerger:
    """Incremental base ⊕ runs merge for one column. The base is wrapped
    (O(1)); the first append pays one O(base) copy into a capacity-doubling
    buffer; every later write/read cycle appends only the unseen run tail —
    the merge is O(delta), not O(base), per cycle."""

    def __init__(self, base):
        from .storage import DictColumn, RaggedColumn, compute_stats
        self.n_runs = 0
        if isinstance(base, DictColumn):
            self.kind = "dict"
            self.codes = Growable(base.codes)
            self.vocab = Growable(np.asarray(list(base.vocab), dtype=object))
            self.index = {v: i for i, v in enumerate(base.vocab)}
            self.counts = Growable(np.bincount(
                base.codes, minlength=len(base.vocab)).astype(np.int64))
        elif isinstance(base, RaggedColumn):
            self.kind = "ragged"
            self.values = Growable(np.asarray(base.values))
            self.offsets = Growable(np.asarray(base.offsets, dtype=np.int64))
        else:
            self.kind = "array"
            self.buf = Growable(np.asarray(base))
            arr = np.asarray(base)
            # incremental §6.3 stats ride along for numeric columns: each
            # absorbed run extends min/max/histogram/MCV counts/NDV in
            # O(batch), so the optimizer sees fresh statistics — including
            # the histogram-overlap join model (ColumnStats.join_overlap),
            # whose bucket/MCV inputs these are — without an O(base)
            # recompute
            self.stats = compute_stats(arr) if arr.dtype.kind in "ifu" else None

    def absorb(self, runs: list) -> None:
        """Fold runs[n_absorbed:] into the buffers (the delta tail only)."""
        from .storage import encode_batch
        for r in runs[self.n_runs:]:
            if self.kind == "dict":
                vals = np.asarray(r, dtype=object).tolist()
                new_codes, fresh = encode_batch(vals, self.index, self.vocab.n)
                if fresh:
                    self.vocab.append(np.asarray(fresh, dtype=object))
                    self.counts.append(np.zeros(len(fresh), dtype=np.int64))
                np.add.at(self.counts.view(), new_codes, 1)
                self.codes.append(new_codes)
            elif self.kind == "ragged":
                rows = [np.asarray(row) for row in r]
                last = int(self.offsets.view()[-1])
                lens = np.asarray([len(row) for row in rows], dtype=np.int64)
                self.offsets.append(last + np.cumsum(lens))
                if len(rows):
                    tail = np.concatenate(rows) if len(rows) > 1 else rows[0]
                    self.values = _promote(self.values, tail.dtype)
                    self.values.append(tail)
            else:
                run = np.asarray(r)
                self.buf = _promote(self.buf, run.dtype)
                self.buf.append(run)
                if self.stats is not None and run.dtype.kind in "ifu":
                    self.stats.extend_numeric(run)
                else:
                    self.stats = None   # non-numeric append: fall back to lazy
        self.n_runs = len(runs)

    def stats_view(self):
        """Current ColumnStats maintained across absorbs (dict columns
        rebuild exact MCV counts from the incrementally-kept per-code
        totals; numeric columns carry the extended histogram/MCV object),
        or None when the column kind falls back to lazy recomputation
        (ragged columns). These are the distributions the optimizer's
        ``join_overlap`` estimates read, so merged base ⊕ delta views keep
        distribution-aware join cardinalities current per append."""
        from .storage import dict_stats
        if self.kind == "dict":
            return dict_stats(self.codes.n, self.vocab.view(),
                              self.counts.view())
        if self.kind == "array":
            return self.stats
        return None

    def view(self):
        from .storage import DictColumn, RaggedColumn
        if self.kind == "dict":
            return DictColumn(codes=self.codes.view(), vocab=self.vocab.view())
        if self.kind == "ragged":
            return RaggedColumn(values=self.values.view(),
                                offsets=self.offsets.view())
        return self.buf.view()


class TableMerger:
    """Incremental base ⊕ delta view of one record table. ``table(runs)``
    absorbs only runs appended since the last call and returns a (cached)
    merged Table — alternating single-batch writes with record reads no
    longer re-pay an O(base) concat per cycle."""

    def __init__(self, base_table):
        self.name = base_table.name
        self.mergers = {k: ColumnMerger(c) for k, c in base_table.columns.items()}
        self._cached = None
        self._cached_runs = -1

    def table(self, runs: dict[str, list]):
        from .storage import Table
        n_runs = max((len(r) for r in runs.values()), default=0)
        if self._cached is not None and n_runs == self._cached_runs:
            return self._cached
        for k, m in self.mergers.items():
            m.absorb(runs.get(k, []))
        self._cached = Table(self.name,
                             {k: m.view() for k, m in self.mergers.items()})
        # hand the incrementally-maintained stats to the merged view, so
        # Table.stats() on a base ⊕ delta table is O(1) instead of O(rows)
        for k, m in self.mergers.items():
            s = m.stats_view()
            if s is not None:
                self._cached._stats[k] = s
        self._cached_runs = n_runs
        return self._cached


# ---------------------------------------------------------------------------
# Column-run merging (shared by the lazy table views and compaction)
# ---------------------------------------------------------------------------


def concat_column(base, runs: list):
    """Merge a base column with pending runs of the same column. Dictionary
    columns extend their vocabulary incrementally (no decode + re-unique of
    existing rows); ragged runs are lists-of-lists; plain arrays concatenate."""
    from .storage import DictColumn, RaggedColumn  # local import (cycle)

    if isinstance(base, DictColumn):
        new_vals: list = []
        for r in runs:
            new_vals.extend(np.asarray(r, dtype=object).tolist())
        return base.append(new_vals)
    if isinstance(base, RaggedColumn):
        tail = RaggedColumn(lists=[np.asarray(row) for r in runs for row in r])
        values = (np.concatenate([base.values, tail.values])
                  if len(tail.values) else base.values)
        offsets = np.concatenate([base.offsets, base.offsets[-1] + tail.offsets[1:]])
        return RaggedColumn(values=values, offsets=offsets)
    # plain arrays: let numpy promote dtypes (int64 base + float run ->
    # float64), matching what the pre-delta insert path did — casting runs
    # to the base dtype would silently truncate inserted values
    return np.concatenate([np.asarray(base)] + [np.asarray(r) for r in runs])
