"""Delta-aware secondary indexes + access-path infrastructure (paper §4/§6).

The paper's predicate-aware traversal (pillar 1) assumes selective
predicates cost less than full scans, but the scan-based RecordAM pays
O(n) per predicate regardless of selectivity. This module supplies the
missing access paths, per ``Database`` via one :class:`IndexManager`:

* **hash/dict equality indexes** — value -> sorted row-id postings. Dict
  columns reuse their int32 codes (postings grouped by code, O(1) point
  lookup through the existing vocabulary index);
* **sorted indexes** — an argsort permutation over the base rows plus
  ``searchsorted`` range probes (equality is a zero-width range);
* **zone maps** — per-chunk min/max/non-null counts over numeric columns
  (base chunks and appended delta runs alike) powering skip-scans: chunks
  whose [min, max] cannot satisfy a predicate are never read;
* **composite (label, attr) vertex indexes** — the same structures over a
  graph's per-label vertex tables, keyed ``(graph, label, column)``, so
  ``pattern.match`` seeds candidate sets from postings instead of
  full-label masks (the graph side of topology+attribute traversal).

Every index is **delta-aware**: reads over LSM-buffered collections
(:mod:`repro_torch.core.deltastore`) see base ⊕ delta, so an index must too.
The base structures are immutable; rows appended since the last refresh
land in a small re-sorted *tail* (postings = base ⊕ sorted delta tail),
tombstoned edges are filtered at lookup time, and a compaction — the only
event that can reorder or renumber rows — forces a rebuild. Staleness is
detected, never guessed: each index carries the write **epoch** and a base
snapshot token of its source collection; a lookup against a bumped epoch
refreshes (or rebuilds) first.

The optimizer (:func:`repro_torch.core.optimizer.optimize`) makes the cost-based
access-path choice per scan — postings lookup vs. zone skip-scan vs. full
scan — using the existing :class:`~repro_torch.core.storage.ColumnStats`
selectivities, and ``explain``/``explain_last`` report the decision as
``access=`` per operator.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .cost import ZONE_CHUNK
from .storage import Database, DictColumn, Graph, Table, _scalar_cmp

EQ_OPS = ("==", "in")
RANGE_OPS = ("==", "in", "<", "<=", ">", ">=", "range")


# ---------------------------------------------------------------------------
# Zone maps: per-chunk min/max/non-null for skip-scans
# ---------------------------------------------------------------------------


def _chunk_stats(vals: np.ndarray) -> tuple[float, float, int]:
    """(min, max, non-null count) of one chunk; all-null chunks get the
    (+inf, -inf) sentinel so no predicate ever selects them."""
    if vals.dtype.kind == "f":
        vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return np.inf, -np.inf, 0
    return float(vals.min()), float(vals.max()), int(vals.size)


class ZoneMap:
    """Chunked min/max/non-null summaries of one numeric column. The row
    space is the merged (base ⊕ delta) row order: ``extend`` absorbs
    appended delta runs by completing the trailing partial chunk (min/max
    combine associatively — no re-read of old values) and chunking the
    rest. ``masked_eval`` is the skip-scan: the predicate is evaluated only
    on candidate chunks, everything else stays False without being read."""

    def __init__(self, values: np.ndarray, chunk: int = ZONE_CHUNK):
        self.chunk = int(chunk)
        self.n = 0
        self._mins: list[float] = []
        self._maxs: list[float] = []
        self._nonnull: list[int] = []
        self._arrays = None     # cached (mins, maxs, nonnull) ndarrays
        self.extend(values)

    def _chunk_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._arrays is None:
            self._arrays = (np.asarray(self._mins), np.asarray(self._maxs),
                            np.asarray(self._nonnull))
        return self._arrays

    @property
    def n_chunks(self) -> int:
        return len(self._mins)

    def extend(self, values: np.ndarray) -> None:
        vals = np.asarray(values)
        if vals.size == 0:
            return
        i = 0
        part = self.n % self.chunk
        if part:
            fill = min(self.chunk - part, len(vals))
            mn, mx, nn = _chunk_stats(vals[:fill])
            self._mins[-1] = min(self._mins[-1], mn)
            self._maxs[-1] = max(self._maxs[-1], mx)
            self._nonnull[-1] += nn
            i = fill
        for start in range(i, len(vals), self.chunk):
            mn, mx, nn = _chunk_stats(vals[start:start + self.chunk])
            self._mins.append(mn)
            self._maxs.append(mx)
            self._nonnull.append(nn)
        self.n += len(vals)
        self._arrays = None

    def candidate_chunks(self, pred) -> np.ndarray:
        """Boolean per chunk: can any row of the chunk satisfy ``pred``?"""
        mins, maxs, nonnull = self._chunk_arrays()
        op, v = pred.op, pred.value
        if op == "==":
            cand = (mins <= v) & (maxs >= v)
        elif op == "in":
            cand = np.zeros(len(mins), dtype=bool)
            for val in pred.value:
                cand |= (mins <= val) & (maxs >= val)
        elif op == "<":
            cand = mins < v
        elif op == "<=":
            cand = mins <= v
        elif op == ">":
            cand = maxs > v
        elif op == ">=":
            cand = maxs >= v
        elif op == "range":
            cand = (maxs >= v) & (mins <= pred.value2)
        else:   # "!=" and friends: zones cannot prune
            cand = np.ones(len(mins), dtype=bool)
        return cand & (nonnull > 0)

    def fraction(self, pred) -> float:
        """Fraction of rows living in candidate chunks — the exact price of
        the skip-scan, fed to the optimizer's access-path costing."""
        if self.n == 0:
            return 0.0
        cand = self.candidate_chunks(pred)
        rows = 0
        for ci in np.nonzero(cand)[0]:
            rows += min(self.chunk, self.n - ci * self.chunk)
        return rows / self.n

    def _candidate_runs(self, pred) -> list[tuple[int, int]]:
        """Row ranges of candidate chunks, consecutive chunks coalesced."""
        cand = np.nonzero(self.candidate_chunks(pred))[0]
        runs: list[tuple[int, int]] = []
        i = 0
        while i < len(cand):
            j = i
            while j + 1 < len(cand) and cand[j + 1] == cand[j] + 1:
                j += 1
            runs.append((int(cand[i]) * self.chunk,
                         min((int(cand[j]) + 1) * self.chunk, self.n)))
            i = j + 1
        return runs

    def masked_eval(self, values: np.ndarray, pred) -> np.ndarray:
        """Exact predicate mask over all rows, reading candidate chunks
        only (consecutive candidates are evaluated as one slice)."""
        mask = np.zeros(self.n, dtype=bool)
        for a, b in self._candidate_runs(pred):
            mask[a:b] = _scalar_cmp(np.asarray(values[a:b]), pred)
        return mask

    def matching_rows(self, values: np.ndarray, pred) -> np.ndarray:
        """Row ids satisfying ``pred`` — the skip-scan without the O(n)
        output mask: only candidate chunks are read or written."""
        hits = [a + np.nonzero(_scalar_cmp(np.asarray(values[a:b]), pred))[0]
                for a, b in self._candidate_runs(pred)]
        return (np.concatenate(hits) if hits else np.zeros(0, dtype=np.int64))


# ---------------------------------------------------------------------------
# Posting structures: base (immutable) ⊕ sorted delta tail
# ---------------------------------------------------------------------------


class _SortedPostings:
    """Sorted index over a numeric column: base = one argsort permutation
    over the build-time rows, tail = delta rows. Absorbing a run is an O(b)
    buffer append (the write path never sorts); the tail settles — one
    argsort over the accumulated delta — lazily on the next lookup, so a
    write burst pays a single amortized sort instead of one per batch."""

    def __init__(self, values: np.ndarray):
        vals = np.asarray(values)
        self.perm = np.argsort(vals, kind="stable")
        self.keys = vals[self.perm]
        self.tail_rows = np.zeros(0, dtype=np.int64)
        self.tail_keys = np.zeros(0, dtype=vals.dtype if vals.size else np.float64)
        self._pending: list[tuple[np.ndarray, int]] = []

    def absorb(self, values: np.ndarray, row0: int) -> None:
        # copy: the run is often a view into a growable merged-column
        # buffer, and the tail must stay valid across later reallocations
        self._pending.append((np.array(values), row0))

    def _settle(self) -> None:
        if not self._pending:
            return
        vals = np.concatenate([self.tail_keys]
                              + [np.asarray(v) for v, _ in self._pending])
        rows = np.concatenate([self.tail_rows]
                              + [np.arange(r0, r0 + len(v), dtype=np.int64)
                                 for v, r0 in self._pending])
        self._pending = []
        order = np.argsort(vals, kind="stable")
        self.tail_keys = vals[order]
        self.tail_rows = rows[order]

    def _slice(self, lo_val, hi_val, lo_side: str, hi_side: str) -> np.ndarray:
        self._settle()
        lo = 0 if lo_val is None else int(np.searchsorted(self.keys, lo_val, lo_side))
        hi = len(self.keys) if hi_val is None \
            else int(np.searchsorted(self.keys, hi_val, hi_side))
        base = self.perm[lo:hi]
        if not len(self.tail_keys):     # the common no-pending-delta case
            return base
        tlo = 0 if lo_val is None \
            else int(np.searchsorted(self.tail_keys, lo_val, lo_side))
        thi = len(self.tail_keys) if hi_val is None \
            else int(np.searchsorted(self.tail_keys, hi_val, hi_side))
        return np.concatenate([base, self.tail_rows[tlo:thi]])

    def lookup(self, pred) -> Optional[np.ndarray]:
        op, v = pred.op, pred.value
        if op == "==":
            return self._slice(v, v, "left", "right")
        if op == "in":
            hits = [self._slice(val, val, "left", "right") for val in pred.value]
            return (np.unique(np.concatenate(hits)) if hits
                    else np.zeros(0, dtype=np.int64))
        if op == "range":
            return self._slice(v, pred.value2, "left", "right")
        if op == "<":
            return self._slice(None, v, "left", "left")
        if op == "<=":
            return self._slice(None, v, "left", "right")
        if op == ">":
            return self._slice(v, None, "right", "right")
        if op == ">=":
            return self._slice(v, None, "left", "right")
        return None


class _HashPostings:
    """Equality index over a dictionary-encoded column: base postings are
    row ids grouped by code (counting sort), the delta tail is kept sorted
    by code — settled lazily, like :class:`_SortedPostings`. Point lookups
    reuse ``DictColumn.encode`` — O(1) through the vocabulary hash, then
    two binary searches."""

    def __init__(self, col: DictColumn):
        codes = np.asarray(col.codes)
        self.n_codes = len(col.vocab)
        self.order = np.argsort(codes, kind="stable")
        sorted_codes = codes[self.order]
        self.starts = np.searchsorted(sorted_codes, np.arange(self.n_codes + 1))
        self.tail_codes = np.zeros(0, dtype=np.int64)
        self.tail_rows = np.zeros(0, dtype=np.int64)
        self._pending: list[tuple[np.ndarray, int]] = []

    def absorb(self, codes: np.ndarray, row0: int) -> None:
        self._pending.append((np.array(codes, dtype=np.int64), row0))

    def _settle(self) -> None:
        if not self._pending:
            return
        codes = np.concatenate([self.tail_codes]
                               + [c for c, _ in self._pending])
        rows = np.concatenate([self.tail_rows]
                              + [np.arange(r0, r0 + len(c), dtype=np.int64)
                                 for c, r0 in self._pending])
        self._pending = []
        order = np.argsort(codes, kind="stable")
        self.tail_codes = codes[order]
        self.tail_rows = rows[order]

    def _rows_of_code(self, code: int) -> np.ndarray:
        self._settle()
        base = (self.order[self.starts[code]:self.starts[code + 1]]
                if 0 <= code < self.n_codes else np.zeros(0, dtype=np.int64))
        if not len(self.tail_codes):    # the common no-pending-delta case
            return base
        lo = int(np.searchsorted(self.tail_codes, code, "left"))
        hi = int(np.searchsorted(self.tail_codes, code, "right"))
        return np.concatenate([base, self.tail_rows[lo:hi]])

    def lookup(self, pred, col: DictColumn) -> Optional[np.ndarray]:
        if pred.op == "==":
            return self._rows_of_code(col.encode(pred.value))
        if pred.op == "in":
            hits = [self._rows_of_code(col.encode(v)) for v in pred.value]
            return (np.unique(np.concatenate(hits)) if hits
                    else np.zeros(0, dtype=np.int64))
        return None


# ---------------------------------------------------------------------------
# Index sources: where the rows come from, and when they moved
# ---------------------------------------------------------------------------


class _TableSource:
    """A relational/document collection. Tables mutate by wholesale
    replacement (``add_table``) or opaque in-place edits (``touch_table``),
    so any epoch change forces a rebuild — there is no delta tail to
    absorb."""

    incremental = False

    def __init__(self, db: Database, name: str):
        self.db = db
        self.name = name

    def table(self) -> Table:
        return self.db.tables[self.name]

    def epoch(self) -> int:
        return self.db.epoch_of(self.name)

    def token(self):
        return id(self.db.tables[self.name])

    def live_filter(self, rows: np.ndarray) -> np.ndarray:
        return rows


class _VertexSource:
    """One label's vertex table of a graph: merged base ⊕ delta rows in
    stable order, so appends absorb incrementally; a compaction (the only
    row reorder) is detected via the compaction counter and rebuilds."""

    incremental = True

    def __init__(self, db: Database, gname: str, label: str):
        self.db = db
        self.gname = gname
        self.label = label

    @property
    def g(self) -> Graph:
        return self.db.graphs[self.gname]

    def table(self) -> Table:
        return self.g.vertex_tables[self.label]

    def epoch(self) -> int:
        return self.db.epoch_of(self.gname)

    def token(self):
        # graph identity + compaction count: a compaction reorders rows,
        # and a whole-graph replacement under the same name swaps the
        # object — both invalidate the base snapshot
        return (id(self.g), self.g.compactions)

    def live_filter(self, rows: np.ndarray) -> np.ndarray:
        return rows      # vertices are never tombstoned


class _EdgeSource(_VertexSource):
    """A graph's edge record table. Edge tids are stable between
    compactions (tombstoned rows stay in place), so postings remain valid
    across deletes — lookups filter through the live-edge bitmap instead."""

    def __init__(self, db: Database, gname: str):
        super().__init__(db, gname, "__edges__")

    def table(self) -> Table:
        return self.g.edges

    def live_filter(self, rows: np.ndarray) -> np.ndarray:
        g = self.g
        if not g.delta.n_tombstones or rows.size == 0:
            return rows
        return rows[g.live_edge_mask()[rows]]


# ---------------------------------------------------------------------------
# ColumnIndex: one (collection, column) with epoch-stamped maintenance
# ---------------------------------------------------------------------------


class ColumnIndex:
    """Secondary index over one column: kind-specific postings + zone maps
    (numeric columns), epoch-stamped against the source collection.

    ``refresh`` is the single maintenance entry point, called before every
    lookup: same epoch -> nothing; epoch bumped with the base snapshot
    intact -> absorb the appended tail rows in O(delta); base snapshot
    changed (compaction / table replacement) -> rebuild. A stale index is
    therefore *impossible to read* — the stamp is checked, not trusted."""

    def __init__(self, source, column: str, kind: str = "auto"):
        self.source = source
        self.column = column
        self.kind = kind
        self.lookups = 0
        self.refreshes = 0
        self.rebuilds = -1      # the initial _build is not a rebuild
        self._build()

    # ---- construction / maintenance ----
    def _build(self) -> None:
        tbl = self.source.table()
        col = tbl.columns[self.column]
        if self.kind == "auto":
            self.kind = "hash" if isinstance(col, DictColumn) else "sorted"
        self.postings = None
        self.zones = None
        if isinstance(col, DictColumn):
            if self.kind != "hash":
                raise ValueError(f"{self.kind} index needs a numeric column; "
                                 f"{self.column} is dictionary-encoded")
            self.postings = _HashPostings(col)
        else:
            vals = np.asarray(col)
            if vals.dtype.kind not in "ifub":
                raise ValueError(f"cannot index non-scalar column {self.column}")
            if self.kind == "sorted":
                self.postings = _SortedPostings(vals)
            self.zones = ZoneMap(vals.astype(np.float64, copy=False))
        self._col = col
        self.n_rows = tbl.nrows
        self.epoch = self.source.epoch()
        self.token = self.source.token()
        self.rebuilds += 1

    def refresh(self) -> None:
        ep = self.source.epoch()
        if ep == self.epoch:
            return
        tbl = self.source.table()
        if (self.source.token() != self.token or not self.source.incremental
                or tbl.nrows < self.n_rows):
            self._build()
            return
        if tbl.nrows > self.n_rows:
            col = tbl.columns[self.column]
            if isinstance(col, DictColumn):
                if self.postings is not None:
                    self.postings.absorb(np.asarray(col.codes)[self.n_rows:],
                                         self.n_rows)
            else:
                run = np.asarray(col)[self.n_rows:]
                if self.postings is not None:
                    self.postings.absorb(run, self.n_rows)
                if self.zones is not None:
                    self.zones.extend(run.astype(np.float64, copy=False))
            self._col = col
            self.n_rows = tbl.nrows
        self.epoch = ep
        self.refreshes += 1

    # ---- reads ----
    def serves(self, op: str) -> bool:
        if self.postings is None:
            return False
        return op in (EQ_OPS if self.kind == "hash" else RANGE_OPS)

    def lookup(self, pred) -> Optional[np.ndarray]:
        """Row ids matching ``pred`` (tombstone-filtered), or None when the
        predicate is not servable from the postings."""
        self.refresh()
        if not self.serves(pred.op):
            return None
        self.lookups += 1
        if self.kind == "hash":
            rows = self.postings.lookup(pred, self._col)
        else:
            rows = self.postings.lookup(pred)
        if rows is None:
            return None
        return self.source.live_filter(np.asarray(rows, dtype=np.int64))

    def zone_fraction(self, pred) -> Optional[float]:
        """Candidate-row fraction a zone skip-scan would read, or None when
        the column has no zone maps / the op cannot be pruned."""
        self.refresh()
        if self.zones is None or pred.op not in RANGE_OPS:
            return None
        return self.zones.fraction(pred)

    def zone_mask(self, pred) -> Optional[np.ndarray]:
        """Exact predicate mask over all rows via the chunk skip-scan
        (tombstones are *not* applied — the mask mirrors eval_predicate)."""
        self.refresh()
        if self.zones is None or pred.op not in RANGE_OPS:
            return None
        self.lookups += 1
        return self.zones.masked_eval(np.asarray(self._col), pred)

    def zone_rows(self, pred) -> Optional[np.ndarray]:
        """Matching row ids via the chunk skip-scan (tombstone-filtered)."""
        self.refresh()
        if self.zones is None or pred.op not in RANGE_OPS:
            return None
        self.lookups += 1
        rows = self.zones.matching_rows(np.asarray(self._col), pred)
        return self.source.live_filter(rows)

    def describe(self) -> str:
        z = f"+zones[{self.zones.n_chunks}]" if self.zones is not None else ""
        return (f"{self.kind}{z} rows={self.n_rows} epoch={self.epoch} "
                f"refreshes={self.refreshes} rebuilds={self.rebuilds}")


# ---------------------------------------------------------------------------
# IndexManager: the per-Database catalog of secondary indexes
# ---------------------------------------------------------------------------


class IndexManager:
    """All secondary indexes of one :class:`Database`. Keys are
    ``(collection, label, column)`` — ``label`` names a graph vertex table
    (the composite (label, attr) index), ``label=None`` on a graph indexes
    the edge record table, and tables ignore it. Graphs carrying indexes
    get a backref (``graph._index_manager``) so the traversal layer can
    seed candidate sets without threading the Database through."""

    def __init__(self, db: Database):
        self.db = db
        self._indexes: dict[tuple, ColumnIndex] = {}

    def _key(self, name: str, column: str, label: Optional[str]) -> tuple:
        return (name, label if name in self.db.graphs else None, column)

    def create(self, name: str, column: str, kind: str = "auto",
               label: Optional[str] = None) -> ColumnIndex:
        if name in self.db.tables:
            source = _TableSource(self.db, name)
        elif name in self.db.graphs:
            source = (_VertexSource(self.db, name, label) if label is not None
                      else _EdgeSource(self.db, name))
            self.db.graphs[name]._index_manager = self
        else:
            raise KeyError(name)
        idx = ColumnIndex(source, column, kind)
        self._indexes[self._key(name, column, label)] = idx
        return idx

    def drop(self, name: str, column: str, label: Optional[str] = None) -> None:
        self._indexes.pop(self._key(name, column, label), None)

    def get(self, name: str, column: str,
            label: Optional[str] = None) -> Optional[ColumnIndex]:
        return self._indexes.get(self._key(name, column, label))

    def lookup(self, name: str, pred,
               label: Optional[str] = None) -> Optional[np.ndarray]:
        """Matching row ids of ``pred.column`` in the named collection, or
        None when no index serves it (caller falls back to the scan)."""
        idx = self.get(name, pred.column, label)
        return None if idx is None else idx.lookup(pred)

    def zone_fraction(self, name: str, pred,
                      label: Optional[str] = None) -> Optional[float]:
        idx = self.get(name, pred.column, label)
        return None if idx is None else idx.zone_fraction(pred)

    def zone_mask(self, name: str, pred,
                  label: Optional[str] = None) -> Optional[np.ndarray]:
        idx = self.get(name, pred.column, label)
        return None if idx is None else idx.zone_mask(pred)

    def zone_rows(self, name: str, pred,
                  label: Optional[str] = None) -> Optional[np.ndarray]:
        idx = self.get(name, pred.column, label)
        return None if idx is None else idx.zone_rows(pred)

    def refresh_all(self) -> None:
        """Force maintenance of every index now (normally lazy-on-lookup);
        the update-suite benchmark charges maintenance per write batch."""
        for idx in self._indexes.values():
            idx.refresh()

    def stats(self) -> dict:
        return {"/".join(str(p) for p in k if p is not None): idx.describe()
                for k, idx in sorted(self._indexes.items(),
                                     key=lambda kv: str(kv[0]))}

    def metrics(self) -> dict:
        """Flat numeric counters per index (telemetry registry source):
        ``<collection>[/<label>]/<column>.{lookups,refreshes,rebuilds}``.
        Maintenance stays lazy — this reads stamps, it never refreshes."""
        out: dict[str, int] = {}
        for k, idx in sorted(self._indexes.items(), key=lambda kv: str(kv[0])):
            base = "/".join(str(p) for p in k if p is not None)
            out[f"{base}.lookups"] = idx.lookups
            out[f"{base}.refreshes"] = idx.refreshes
            out[f"{base}.rebuilds"] = idx.rebuilds
        return out

    def __len__(self):
        return len(self._indexes)
