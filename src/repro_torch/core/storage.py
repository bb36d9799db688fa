"""Dual storage engine (paper §4), adapted to dense-array execution.

* Unified record storage: columnar struct-of-arrays tables (NF² via ragged
  (values, offsets) pairs for multi-valued attributes). Strings are
  dictionary-encoded (int32 codes + vocabulary) so every column the execution
  engine touches is a dense numeric array — the array analogue of JSONB fields.
* Document shredding: each JSON path used by queries becomes a column
  ("a.b.c"); arrays become ragged columns. This replaces per-record JSONB
  parsing with one-time columnarization (same spirit as JSON tiles).
* Topology storage: CSR adjacency (forward + reverse) replacing the paper's
  singly-linked adjacency graph; nidMap/vertexMap/edgeMap are dense index
  arrays (O(1) ``take`` — the tid-based RecordAM).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------


def encode_batch(values: list, index: dict, n_vocab: int
                 ) -> tuple[np.ndarray, list]:
    """Encode a batch of values against an existing vocab ``index``, giving
    fresh codes (from ``n_vocab`` up) to unseen values. Mutates ``index``;
    returns (int32 codes, newly-seen values in first-appearance order). The
    single encoding loop shared by ``DictColumn.append`` and the
    delta store's incremental merged views (``deltastore.ColumnMerger``)."""
    codes = np.empty(len(values), dtype=np.int32)
    fresh: list = []
    for i, v in enumerate(values):
        c = index.get(v)
        if c is None:
            c = n_vocab + len(fresh)
            index[v] = c
            fresh.append(v)
        codes[i] = c
    return codes, fresh


class DictColumn:
    """Dictionary-encoded string column: int32 codes into ``vocab``."""

    __slots__ = ("codes", "vocab", "_index")

    def __init__(self, values: Iterable[str] | None = None, codes=None, vocab=None):
        if values is not None:
            vocab, codes = np.unique(np.asarray(list(values), dtype=object), return_inverse=True)
            self.vocab = vocab
            self.codes = codes.astype(np.int32)
        else:
            self.codes = np.asarray(codes, dtype=np.int32)
            self.vocab = np.asarray(vocab, dtype=object)
        self._index: Optional[dict] = None

    def encode(self, value: str) -> int:
        """Map a string to its code (-1 if absent)."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.vocab)}
        return self._index.get(value, -1)

    def decode(self, codes) -> np.ndarray:
        return self.vocab[np.asarray(codes)]

    def append(self, values) -> "DictColumn":
        """Extend with new rows, growing the vocabulary incrementally: only
        unseen values get new codes and only the new rows are encoded — no
        decode + re-unique round trip over the existing column."""
        values = list(values)
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.vocab)}
        index = dict(self._index)   # this column stays unaffected
        new_codes, vocab_ext = encode_batch(values, index, len(self.vocab))
        vocab = (np.concatenate([self.vocab, np.asarray(vocab_ext, dtype=object)])
                 if vocab_ext else self.vocab)
        out = DictColumn(codes=np.concatenate([self.codes, new_codes]), vocab=vocab)
        out._index = index
        return out

    def take(self, idx) -> "DictColumn":
        return DictColumn(codes=self.codes[idx], vocab=self.vocab)

    def __len__(self):
        return len(self.codes)

    @property
    def dtype(self):
        return np.dtype(object)


class RaggedColumn:
    """Multi-valued (NF²) column: flat ``values`` + ``offsets`` (len n+1)."""

    __slots__ = ("values", "offsets")

    def __init__(self, lists: Iterable[Iterable] | None = None, values=None, offsets=None):
        if lists is not None:
            lists = [np.asarray(l) for l in lists]
            self.offsets = np.zeros(len(lists) + 1, dtype=np.int64)
            np.cumsum([len(l) for l in lists], out=self.offsets[1:])
            self.values = (np.concatenate(lists) if lists else np.zeros(0))
        else:
            self.values = np.asarray(values)
            self.offsets = np.asarray(offsets, dtype=np.int64)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def take(self, idx) -> "RaggedColumn":
        idx = np.asarray(idx)
        # per-row lengths of the selected rows only — O(|idx|), not O(n)
        lens = self.offsets[idx + 1] - self.offsets[idx]
        out_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        # gather: for each row, slice values[offsets[i]:offsets[i+1]]
        starts = np.repeat(self.offsets[idx], lens)
        within = np.arange(out_off[-1]) - np.repeat(out_off[:-1], lens)
        return RaggedColumn(values=self.values[starts + within], offsets=out_off)

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i]:self.offsets[i + 1]]

    def __len__(self):
        return len(self.offsets) - 1


Column = Any  # np.ndarray | DictColumn | RaggedColumn


def _col_len(c: Column) -> int:
    return len(c)


def _col_take(c: Column, idx) -> Column:
    if isinstance(c, (DictColumn, RaggedColumn)):
        return c.take(idx)
    return np.asarray(c)[idx]


# ---------------------------------------------------------------------------
# Column statistics for the cost model (§6.3: selectivity estimation)
# ---------------------------------------------------------------------------

N_HIST_BUCKETS = 32     # equi-width histogram resolution for numeric columns
MCV_CAP = 4096          # keep exact per-value counts up to this many distincts


@dataclasses.dataclass
class ColumnStats:
    """Per-column statistics: row count, NDV, min/max, an equi-width
    histogram for numeric columns, and exact per-value counts for
    dictionary-encoded columns (most-common-value statistics). The optimizer
    keys join ordering and semi-join siding off ``ndv``; ``selectivity`` is
    value-aware when the per-value counts are present."""

    n: int
    ndv: int                              # number of distinct values
    vmin: Any = None
    vmax: Any = None
    hist: Optional[np.ndarray] = None     # bucket counts (equi-width)
    edges: Optional[np.ndarray] = None    # len(hist)+1 bucket boundaries
    value_counts: Optional[dict] = None   # value -> exact row count

    def _has_hist(self) -> bool:
        return (self.hist is not None and self.edges is not None
                and len(self.edges) > 1 and float(self.hist.sum()) > 0)

    def _bucket_ndvs(self) -> np.ndarray:
        """Estimated distinct values per histogram bucket: NDV distributed
        proportionally to bucket mass (and capped by the bucket count)."""
        total = float(self.hist.sum())
        nd = self.ndv * self.hist / total
        return np.minimum(np.maximum(nd, 0.0), np.maximum(self.hist, 0.0))

    def join_overlap(self, other: "ColumnStats"
                     ) -> Optional[tuple[float, str]]:
        """Expected equi-join matches |L ⋈ R| between the two *base* columns
        (every row on both sides): Σ_k count_L(k) · count_R(k) over the join
        keys k. Returns ``(matches, provenance)`` or ``None`` when neither
        side carries a key distribution (caller falls back to NDV
        containment).

        * exact when both sides keep per-value MCV counts;
        * point-mass × per-bucket density when one side has numeric MCV
          counts and the other an equi-width histogram;
        * per-bucket-pair overlap under a uniform-within-bucket containment
          assumption when only histograms are available.

        Memoized per partner: the optimizer's join enumerator probes the
        same key pair once per candidate split, and an MCV sum is O(ndv).
        The memo key embeds both row/NDV counts, so in-place stat extension
        (delta appends) can never serve a stale overlap.
        """
        memo = self.__dict__.setdefault("_overlap_memo", {})
        key = (id(other), self.n, self.ndv, other.n, other.ndv)
        ent = memo.get(key)
        if ent is not None and ent[0] is other:
            return ent[1]
        out = self._join_overlap(other)
        if len(memo) > 8:
            memo.clear()
        memo[key] = (other, out)    # holding ``other`` pins its id
        return out

    def _join_overlap(self, other: "ColumnStats"
                      ) -> Optional[tuple[float, str]]:
        if self.n == 0 or other.n == 0:
            return 0.0, "empty"
        a_mcv, b_mcv = self.value_counts is not None, other.value_counts is not None
        if a_mcv and b_mcv:
            small, big = ((self.value_counts, other.value_counts)
                          if len(self.value_counts) <= len(other.value_counts)
                          else (other.value_counts, self.value_counts))
            m = float(sum(c * big.get(v, 0) for v, c in small.items()))
            return m, (f"mcv×mcv[{len(self.value_counts)}"
                       f"×{len(other.value_counts)}]")
        # numeric MCV point masses against the other side's histogram
        if a_mcv and self.vmin is not None and other._has_hist():
            return _points_vs_hist(self.value_counts, other), "mcv×hist"
        if b_mcv and other.vmin is not None and self._has_hist():
            return _points_vs_hist(other.value_counts, self), "hist×mcv"
        if self._has_hist() and other._has_hist():
            return (_hist_overlap(self, other),
                    f"hist[{len(self.hist)}×{len(other.hist)}]")
        return None

    def eq_fraction(self, value) -> float:
        """Fraction of rows equal to ``value`` (exact when MCV counts are
        kept, System-R 1/ndv otherwise)."""
        if self.n == 0:
            return 0.0
        if self.value_counts is not None:
            return self.value_counts.get(value, 0) / self.n
        return 1.0 / max(self.ndv, 1)

    def _cdf(self, x: float) -> float:
        """P(col <= x) from the histogram (linear within a bucket)."""
        e, h = self.edges, self.hist
        total = h.sum()
        if total == 0:
            return 0.0
        if x <= e[0]:
            return 0.0
        if x >= e[-1]:
            return 1.0
        i = int(np.searchsorted(e, x, side="right")) - 1
        i = min(i, len(h) - 1)
        width = e[i + 1] - e[i]
        frac_in = (x - e[i]) / width if width > 0 else 1.0
        return float(h[:i].sum() + h[i] * frac_in) / float(total)

    def range_fraction(self, lo, hi) -> float:
        """Fraction of rows in [lo, hi], histogram-backed when available."""
        if self.hist is not None and self.edges is not None and len(self.edges) > 1:
            return max(0.0, self._cdf(float(hi)) - self._cdf(float(lo)))
        if self.vmin is None or self.vmax is None or self.vmax == self.vmin:
            return 1.0 / 3.0
        span = float(self.vmax) - float(self.vmin)
        return min(1.0, max(0.0, (float(hi) - float(lo)) / span))

    def selectivity(self, pred) -> float:
        """System-R style estimates, upgraded with MCV counts (equality on
        dictionary columns is exact) and equi-width histograms (range).
        Always clamped to [0, 1]."""
        return min(1.0, max(0.0, self._selectivity(pred)))

    def _selectivity(self, pred) -> float:
        if self.n == 0:
            return 0.0
        if pred.op == "==":
            return self.eq_fraction(pred.value)
        if pred.op == "!=":
            return 1.0 - self.eq_fraction(pred.value)
        if pred.op == "in":
            if self.value_counts is not None:
                return sum(self.value_counts.get(v, 0)
                           for v in pred.value) / self.n
            return len(pred.value) / max(self.ndv, 1)
        try:
            if pred.op == "range":
                return self.range_fraction(pred.value, pred.value2)
            if pred.op in ("<", "<="):
                lo = self.vmin if self.vmin is not None else pred.value
                return self.range_fraction(lo, pred.value)
            hi = self.vmax if self.vmax is not None else pred.value
            return self.range_fraction(pred.value, hi)
        except (TypeError, ValueError):
            return 1.0 / 3.0

    # ---- incremental maintenance (delta-store appends) ----
    def extend_numeric(self, run: np.ndarray) -> None:
        """Absorb appended numeric values in O(|run| + buckets): min/max and
        histogram update exactly (re-binning old counts proportionally when
        the value range grows); NDV extrapolates with the observed
        distinctness ratio, so key-like columns keep growing while
        low-cardinality columns stay put."""
        run = np.asarray(run, dtype=np.float64)
        n_add = len(run)                 # n counts rows, like compute_stats
        if n_add == 0:
            return
        run = run[np.isfinite(run)]      # values feed min/max/hist/MCV only
        if run.size == 0:
            self.n += n_add
            return
        if self.n == 0 or self.ndv == 0:
            # empty/all-NaN base: seed from the run (a 0 distinctness ratio
            # would otherwise freeze ndv at 0 forever)
            n_rows = self.n + n_add
            fresh = _numeric_stats(run, n_rows)
            self.n, self.ndv = n_rows, fresh.ndv
            self.vmin, self.vmax = fresh.vmin, fresh.vmax
            self.hist, self.edges = fresh.hist, fresh.edges
            self.value_counts = fresh.value_counts
            return
        self.n += n_add
        if self.value_counts is not None:
            # exact per-value counts (and therefore exact NDV) survive the
            # append; drop to estimates only past the MCV cap
            u, c = np.unique(run, return_counts=True)
            for v, k in zip(u.tolist(), c.tolist()):
                self.value_counts[v] = self.value_counts.get(v, 0) + k
            if len(self.value_counts) > MCV_CAP:
                self.value_counts = None
            else:
                self.ndv = len(self.value_counts)
        if self.value_counts is None:
            n_old = self.n - n_add
            ratio = min(1.0, self.ndv / max(n_old, 1))
            self.ndv = min(self.n,
                           self.ndv + max(int(round(len(run) * ratio)), 0))
        rmin, rmax = float(run.min()), float(run.max())
        vmin = rmin if self.vmin is None else min(float(self.vmin), rmin)
        vmax = rmax if self.vmax is None else max(float(self.vmax), rmax)
        if self.hist is None or self.edges is None:
            self.vmin, self.vmax = vmin, vmax
            return
        if vmin < self.edges[0] or vmax > self.edges[-1]:
            new_edges = np.linspace(vmin, vmax if vmax > vmin else vmin + 1.0,
                                    len(self.hist) + 1)
            self.hist = _rebin(self.hist, self.edges, new_edges)
            self.edges = new_edges
        self.hist = self.hist + np.histogram(run, bins=self.edges)[0]
        self.vmin, self.vmax = vmin, vmax


def _rebin(counts: np.ndarray, old_edges: np.ndarray,
           new_edges: np.ndarray) -> np.ndarray:
    """Redistribute equi-width histogram counts onto new bucket boundaries,
    assigning each old bucket's mass proportionally to its overlap."""
    out = np.zeros(len(new_edges) - 1, dtype=np.float64)
    for i in range(len(counts)):
        lo, hi = old_edges[i], old_edges[i + 1]
        width = hi - lo
        if counts[i] == 0:
            continue
        if width <= 0:
            j = min(int(np.searchsorted(new_edges, lo, "right")) - 1, len(out) - 1)
            out[max(j, 0)] += counts[i]
            continue
        for j in range(len(out)):
            ov = min(hi, new_edges[j + 1]) - max(lo, new_edges[j])
            if ov > 0:
                out[j] += counts[i] * (ov / width)
    return out


def _points_vs_hist(vc: dict, hstats: ColumnStats) -> float:
    """Expected matches of exact point masses against a histogram side: each
    key lands in one bucket and matches ``bucket_rows / bucket_ndv`` rows
    (uniform key distribution within the bucket)."""
    e, h = hstats.edges, hstats.hist
    nd = hstats._bucket_ndvs()
    m = 0.0
    for v, c in vc.items():
        try:
            x = float(v)
        except (TypeError, ValueError):
            continue            # non-numeric key cannot hit a numeric bucket
        if x < e[0] or x > e[-1]:
            continue
        j = min(max(int(np.searchsorted(e, x, "right")) - 1, 0), len(h) - 1)
        m += c * h[j] / max(nd[j], 1.0)
    return float(m)


def _hist_overlap(a: ColumnStats, b: ColumnStats) -> float:
    """Expected matches per overlapping equi-width bucket pair: within each
    overlap region both sides are assumed uniform over their in-region
    distincts, and the side with more distincts defines the key domain
    (System-R containment, applied per region instead of globally)."""
    nda, ndb = a._bucket_ndvs(), b._bucket_ndvs()
    m = 0.0
    for i in range(len(a.hist)):
        lo_a, hi_a = float(a.edges[i]), float(a.edges[i + 1])
        wa = hi_a - lo_a
        if a.hist[i] <= 0 or wa <= 0:
            continue
        j = max(int(np.searchsorted(b.edges, lo_a, "right")) - 1, 0)
        for j in range(j, len(b.hist)):
            lo_b, hi_b = float(b.edges[j]), float(b.edges[j + 1])
            if lo_b >= hi_a:
                break
            wb = hi_b - lo_b
            ov = min(hi_a, hi_b) - max(lo_a, lo_b)
            if b.hist[j] <= 0 or wb <= 0 or ov <= 0:
                continue
            ca = a.hist[i] * ov / wa          # rows of each side in region
            cb = b.hist[j] * ov / wb
            da = nda[i] * ov / wa             # distincts of each side there
            db = ndb[j] * ov / wb
            m += ca * cb / max(da, db, 1.0)
    return float(m)


def _numeric_stats(vals: np.ndarray, n_rows: int) -> ColumnStats:
    finite = vals[np.isfinite(vals)] if vals.dtype.kind == "f" else vals
    if finite.size == 0:
        return ColumnStats(n_rows, 0)
    u, c = np.unique(finite, return_counts=True)
    vmin, vmax = float(u[0]), float(u[-1])
    hist, edges = np.histogram(
        finite, bins=N_HIST_BUCKETS,
        range=(vmin, vmax if vmax > vmin else vmin + 1.0))
    vc = None
    if len(u) <= MCV_CAP:
        vc = {u[i].item(): int(c[i]) for i in range(len(u))}
    return ColumnStats(n_rows, int(len(u)), vmin, vmax,
                       hist.astype(np.float64), edges, vc)


def dict_stats(n: int, vocab: np.ndarray, counts: np.ndarray) -> ColumnStats:
    """ColumnStats of a dictionary-encoded column from its (vocab, per-code
    counts) — the single MCV construction shared by cold ``compute_stats``
    and the delta store's incrementally-maintained merged-view stats."""
    vc = None
    if len(vocab) <= MCV_CAP:
        vc = {vocab[i]: int(counts[i]) for i in range(len(vocab))}
    return ColumnStats(n=n, ndv=int((counts > 0).sum()), value_counts=vc)


def compute_stats(col: Column) -> ColumnStats:
    if isinstance(col, DictColumn):
        counts = np.bincount(col.codes, minlength=len(col.vocab))
        return dict_stats(len(col), col.vocab, counts)
    if isinstance(col, RaggedColumn):
        vals = np.asarray(col.values)
        if vals.size and vals.dtype.kind in "ifu":
            # value-level stats: n counts flat values, so predicate fractions
            # stay in [0, 1] (a lower-bound proxy for ANY-row selectivity)
            return _numeric_stats(vals, len(vals))
        ndv = len(np.unique(vals)) if len(vals) else 0
        return ColumnStats(n=len(col), ndv=ndv)
    col = np.asarray(col)
    if col.size == 0:
        return ColumnStats(0, 0)
    if col.dtype.kind in "ifu":
        return _numeric_stats(col, len(col))
    uniq = np.unique(col)
    return ColumnStats(len(col), int(len(uniq)))


def merge_stats(parts: list[ColumnStats]) -> ColumnStats:
    """Additive rollup of per-shard :class:`ColumnStats` into one global
    object — the cardinality model the optimizer consumes when a table is
    partitioned. Row counts and min/max always combine exactly. While every
    shard keeps exact per-value counts (ndv <= MCV_CAP after the merge),
    the rollup is *bit-exact* against ``compute_stats`` on the unpartitioned
    column: value counts sum, NDV is recounted from the merged map, and the
    numeric histogram is rebuilt from the merged keys weighted by their
    counts — the same binning ``_numeric_stats`` applies to the raw values.
    Past the MCV cap the NDV falls back to a containment bound and
    histograms re-bin onto union edges (approximate, like ``extend_numeric``)."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return ColumnStats(0, 0)
    n = int(sum(p.n for p in parts))
    mins = [p.vmin for p in parts if p.vmin is not None]
    maxs = [p.vmax for p in parts if p.vmax is not None]
    vmin = min(mins) if mins else None
    vmax = max(maxs) if maxs else None
    if all(p.value_counts is not None or p.ndv == 0 for p in parts):
        vc: dict = {}
        for p in parts:
            for v, c in (p.value_counts or {}).items():
                vc[v] = vc.get(v, 0) + c
        if len(vc) <= MCV_CAP:
            ndv = sum(1 for c in vc.values() if c > 0)
            hist = edges = None
            if vmin is not None and vc:
                try:
                    keys = np.array([float(v) for v in vc])
                    weights = np.array([vc[v] for v in vc], dtype=np.float64)
                    hist, edges = np.histogram(
                        keys, bins=N_HIST_BUCKETS, weights=weights,
                        range=(vmin, vmax if vmax > vmin else vmin + 1.0))
                    hist = hist.astype(np.float64)
                except (TypeError, ValueError):
                    hist = edges = None
            return ColumnStats(n, ndv, vmin, vmax, hist, edges, vc)
    # some shard overflowed the MCV cap: approximate rollup
    ndv = int(min(n, sum(p.ndv for p in parts)))
    hparts = [p for p in parts if p._has_hist()]
    hist = edges = None
    if hparts and vmin is not None:
        edges = np.linspace(vmin, vmax if vmax > vmin else vmin + 1.0,
                            N_HIST_BUCKETS + 1)
        hist = np.zeros(N_HIST_BUCKETS, dtype=np.float64)
        for p in hparts:
            hist += _rebin(p.hist, p.edges, edges)
    return ColumnStats(n, ndv, vmin, vmax, hist, edges, None)


# ---------------------------------------------------------------------------
# Tables (unified record storage)
# ---------------------------------------------------------------------------


class Table:
    """Columnar table. Row index == tid (paper: tuple identifier; tid-based
    RecordAM == ``take`` on row indices)."""

    def __init__(self, name: str, columns: dict[str, Column]):
        self.name = name
        self.columns = dict(columns)
        lens = {k: _col_len(v) for k, v in self.columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged table {name}: {lens}")
        self.nrows = next(iter(lens.values())) if lens else 0
        self._stats: dict[str, ColumnStats] = {}

    def col(self, name: str) -> Column:
        return self.columns[name]

    def stats(self, name: str) -> ColumnStats:
        if name not in self._stats:
            self._stats[name] = compute_stats(self.columns[name])
        return self._stats[name]

    def take(self, idx) -> "Table":
        return Table(self.name, {k: _col_take(v, idx) for k, v in self.columns.items()})

    def eval_predicate(self, pred, rows=None) -> np.ndarray:
        """Vectorized predicate mask (the scan-based RecordAM's filter).
        With ``rows`` the predicate is evaluated on that row subset only
        (mask aligns with ``rows``) — the point-evaluation path index
        lookups and deferred predicates use to avoid O(n) column scans."""
        col = self.columns[pred.column]
        if rows is not None:
            col = _col_take(col, np.asarray(rows))
        if isinstance(col, DictColumn):
            if pred.op == "==":
                return col.codes == col.encode(pred.value)
            if pred.op == "!=":
                return col.codes != col.encode(pred.value)
            if pred.op == "in":
                codes = np.array([col.encode(v) for v in pred.value])
                return np.isin(col.codes, codes)
            # range predicates on strings: decode-free compare via vocab order
            vals = col.vocab[col.codes]
        elif isinstance(col, RaggedColumn):
            # predicate over a multi-valued attribute: ANY semantics
            hit = _scalar_cmp(col.values, pred)
            seg = np.repeat(np.arange(len(col)), col.lengths())
            out = np.zeros(len(col), dtype=bool)
            np.logical_or.at(out, seg, hit)
            return out
        else:
            vals = np.asarray(col)
        return _scalar_cmp(vals, pred)

    def __repr__(self):
        return f"Table({self.name}, rows={self.nrows}, cols={list(self.columns)})"


def _scalar_cmp(vals: np.ndarray, pred) -> np.ndarray:
    op, v = pred.op, pred.value
    if op == "==":
        return vals == v
    if op == "!=":
        return vals != v
    if op == "<":
        return vals < v
    if op == "<=":
        return vals <= v
    if op == ">":
        return vals > v
    if op == ">=":
        return vals >= v
    if op == "range":
        return (vals >= v) & (vals <= pred.value2)
    if op == "in":
        return np.isin(vals, np.asarray(list(v)))
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Document collections: JSON shredding
# ---------------------------------------------------------------------------


def shred_documents(name: str, docs: list[dict]) -> Table:
    """Shred a JSON document collection into a columnar Table. Every leaf
    path becomes a column named "a.b"; lists of scalars become RaggedColumns;
    missing values are filled with NaN / "" (absent-path semantics)."""
    paths: dict[str, list] = {}

    def walk(prefix: str, obj, row: dict):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}" if prefix else k, v, row)
        else:
            row[prefix] = obj

    rows = []
    for d in docs:
        row: dict = {}
        walk("", d, row)
        rows.append(row)
        for k in row:
            paths.setdefault(k, None)

    columns: dict[str, Column] = {}
    for path in paths:
        vals = [r.get(path) for r in rows]
        sample = next((v for v in vals if v is not None), None)
        if isinstance(sample, list):
            columns[path] = RaggedColumn(lists=[v if v is not None else [] for v in vals])
        elif isinstance(sample, str):
            columns[path] = DictColumn(values=[v if v is not None else "" for v in vals])
        elif isinstance(sample, bool):
            columns[path] = np.array([bool(v) for v in vals])
        elif isinstance(sample, int) and all(v is not None for v in vals):
            columns[path] = np.array(vals, dtype=np.int64)
        else:
            columns[path] = np.array(
                [np.nan if v is None else float(v) for v in vals], dtype=np.float64)
    return Table(name, columns)


# ---------------------------------------------------------------------------
# Graph model + topology storage (paper Definitions 3-4, adapted to CSR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Compressed sparse row adjacency: for source nid ``s``, its out-
    neighbors are ``col_idx[row_ptr[s]:row_ptr[s+1]]`` and the corresponding
    edge tids are ``edge_id[row_ptr[s]:row_ptr[s+1]]``."""

    row_ptr: np.ndarray   # (n_vertices+1,) int64
    col_idx: np.ndarray   # (n_edges,) int32 target nids
    edge_id: np.ndarray   # (n_edges,) int32 edge tids

    @property
    def n_vertices(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.col_idx)

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def neighbors(self, frontier: np.ndarray):
        """Vectorized whole-frontier expansion (the CSR analogue of walking
        the paper's linked adjacency lists). Returns (src_rep, dst, eid)."""
        from .deltastore import expand_runs
        frontier = np.asarray(frontier)
        deg = self.row_ptr[frontier + 1] - self.row_ptr[frontier]
        pos, slots = expand_runs(self.row_ptr[frontier], deg)
        return frontier[pos], self.col_idx[slots], self.edge_id[slots]


def build_csr(n_vertices: int, src: np.ndarray, dst: np.ndarray) -> CSR:
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n_vertices)
    row_ptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(row_ptr=row_ptr,
               col_idx=dst_s.astype(np.int32),
               edge_id=order.astype(np.int32))


class _VertexTableView:
    """Mapping view over a graph's vertex tables: ``g.vertex_tables[label]``
    returns the base table when the label has no pending delta rows, else a
    lazily merged (and cached) base ⊕ delta table."""

    def __init__(self, g: "Graph"):
        self._g = g

    def __getitem__(self, label: str) -> Table:
        return self._g.vertex_table(label)

    def __iter__(self):
        return iter(self._g.labels)

    def __len__(self):
        return len(self._g.labels)

    def __contains__(self, label):
        return label in self._g.labels

    def keys(self):
        return list(self._g.labels)

    def items(self):
        return [(lbl, self[lbl]) for lbl in self._g.labels]

    def values(self):
        return [self[lbl] for lbl in self._g.labels]


class Graph:
    """Property graph G = (Omega, V, E, L) with uniform edge label.

    * ``vertex_tables``: label -> Table (records; row index == vid)
    * ``edges``: Table with structural keys ``svid``,``tvid`` (+ labels
      ``slabel``,``tlabel`` as table names) and property columns.
    * Topology (Omega): global nid space = concatenation of vertex tables in
      ``labels`` order. ``fwd``/``rev`` CSRs; mappers are dense arrays:
        - nid_base[label] + vid == nid          (nidMap)
        - vertex_label_of[nid], vertex_vid_of[nid]  (vertexMap)
        - CSR.edge_id == edgeMap (edge tid per adjacency slot)

    Mutations are O(batch): they land in ``self.delta`` (an LSM-style
    write-ahead layer — see :mod:`repro_torch.core.deltastore`), reads consult
    base ⊕ delta (``expand``/lazy table views), and ``compact`` folds the
    delta into a fresh base. ``epoch`` increments on every logical mutation
    and keys the inter-buffer so cached GCDA results never go stale.
    Between compactions, delta vertices occupy nids appended after the base
    label blocks; compaction restores the contiguous label-block layout.
    """

    def __init__(self, name: str, vertex_tables: dict[str, Table], edges: Table,
                 src_label: str, dst_label: str,
                 delta_config: Optional["deltastore.DeltaConfig"] = None):
        from . import deltastore
        self.name = name
        self.src_label = src_label
        self.dst_label = dst_label
        self.epoch = 0
        self.compactions = 0
        self.last_compact_seconds = 0.0
        self.write_counters = deltastore.WriteCounters()
        # mutation listeners: fn(graph, op, payload) called after each
        # successful write (workload capture — see repro_torch.core.observe)
        self.listeners: list = []
        self.delta_config = delta_config or deltastore.DeltaConfig()
        self._set_base(dict(vertex_tables), edges)

    def _set_base(self, vertex_tables: dict[str, Table], edges: Table) -> None:
        """Install a fresh base snapshot (initial build and compaction).
        The only O(V+E) path: builds CSRs, mappers, and resets the delta."""
        from . import deltastore
        self._base_vertex_tables = vertex_tables
        self._base_edges = edges
        self.labels = list(vertex_tables)
        self._label_code = {lbl: i for i, lbl in enumerate(self.labels)}

        self.nid_base: dict[str, int] = {}
        base = 0
        for lbl in self.labels:
            self.nid_base[lbl] = base
            base += vertex_tables[lbl].nrows
        self._n_base_vertices = base
        self._base_label_rows = {lbl: vertex_tables[lbl].nrows for lbl in self.labels}

        vlc = np.zeros(base, dtype=np.int8)
        vvo = np.zeros(base, dtype=np.int64)
        for i, lbl in enumerate(self.labels):
            b, n = self.nid_base[lbl], vertex_tables[lbl].nrows
            vlc[b:b + n] = i
            vvo[b:b + n] = np.arange(n)
        self._vlc = deltastore.Growable(vlc)
        self._vvo = deltastore.Growable(vvo)

        src_nid = self.nid_base[self.src_label] + np.asarray(edges.col("svid"))
        dst_nid = self.nid_base[self.dst_label] + np.asarray(edges.col("tvid"))
        self._src_nid = deltastore.Growable(src_nid.astype(np.int64))
        self._dst_nid = deltastore.Growable(dst_nid.astype(np.int64))
        self.fwd = build_csr(base, src_nid, dst_nid)
        self.rev = build_csr(base, dst_nid, src_nid)
        self._n_base_edges = edges.nrows

        self.delta = deltastore.GraphDelta(edges.nrows)
        self._edge_merger = None
        self._vt_mergers: dict[str, "deltastore.TableMerger"] = {}
        self.vertex_tables = _VertexTableView(self)

    # ---- merged (base ⊕ delta) record views ----
    # Backed by capacity-doubling column buffers (deltastore.TableMerger):
    # the first merge after a compaction pays one O(base) copy, every later
    # write/read cycle appends only the delta tail — O(batch), not O(base).
    def vertex_table(self, label: str) -> Table:
        runs = self.delta.vertex_rows.get(label)
        if not runs:
            return self._base_vertex_tables[label]
        from . import deltastore
        merger = self._vt_mergers.get(label)
        if merger is None:
            merger = self._vt_mergers[label] = deltastore.TableMerger(
                self._base_vertex_tables[label])
        return merger.table(runs)

    @property
    def edges(self) -> Table:
        """Edge record table including pending delta rows (row index == edge
        tid; tombstoned rows stay in place until compaction)."""
        if not self.delta.n_new_edges:
            return self._base_edges
        from . import deltastore
        if self._edge_merger is None:
            self._edge_merger = deltastore.TableMerger(self._base_edges)
        return self._edge_merger.table(self.delta.edge_rows)

    # ---- mapping structures (paper §4.2) ----
    @property
    def n_vertices(self) -> int:
        return self._n_base_vertices + self.delta.n_new_vertices_total

    @property
    def vertex_label_code(self) -> np.ndarray:
        return self._vlc.view()

    @property
    def vertex_vid_of(self) -> np.ndarray:
        return self._vvo.view()

    @property
    def src_nid(self) -> np.ndarray:
        return self._src_nid.view()

    @property
    def dst_nid(self) -> np.ndarray:
        return self._dst_nid.view()

    def nid_of(self, label: str, vids) -> np.ndarray:
        vids = np.asarray(vids)
        base_rows = self._base_label_rows[label]
        if self.delta.n_new_vertices.get(label, 0) == 0 or vids.size == 0 \
                or int(np.max(vids)) < base_rows:
            return self.nid_base[label] + vids
        flat = np.atleast_1d(vids).astype(np.int64)
        out = np.empty(len(flat), dtype=np.int64)
        in_base = flat < base_rows
        out[in_base] = self.nid_base[label] + flat[in_base]
        new_nids = self.delta.label_new_nids(label)
        out[~in_base] = new_nids[flat[~in_base] - base_rows]
        return out.reshape(vids.shape) if vids.ndim else out[0]

    def vids_of(self, nids: np.ndarray) -> np.ndarray:
        return self.vertex_vid_of[np.asarray(nids)]

    def label_range(self, label: str) -> tuple[int, int]:
        """Contiguous nid range of the label's BASE block (delta vertices of
        the label, if any, live past ``_n_base_vertices`` — use
        ``label_nids`` for the full set)."""
        b = self.nid_base[label]
        return b, b + self._base_label_rows[label]

    def label_nids(self, label: str) -> np.ndarray:
        """All nids of a label, base block first then delta vertices in
        insertion order (matches the merged vertex table's row order)."""
        lo, hi = self.label_range(label)
        new = self.delta.label_new_nids(label)
        base = np.arange(lo, hi, dtype=np.int64)
        return base if new is None else np.concatenate([base, new])

    def label_code_of(self, label: str) -> int:
        return self._label_code[label]

    @property
    def n_live_edges(self) -> int:
        return self._n_base_edges + self.delta.n_new_edges - self.delta.n_tombstones

    def live_edge_mask(self) -> np.ndarray:
        """Boolean mask over the edge-tid space (== ``edges.nrows``) that is
        False for tombstoned edges."""
        return self.delta.live_edge_mask()

    def live_edge_ids(self) -> np.ndarray:
        if not self.delta.n_tombstones:
            return np.arange(self._n_base_edges + self.delta.n_new_edges)
        return np.nonzero(self.delta.live_edge_mask())[0]

    @property
    def avg_out_degree(self) -> float:
        return self.n_live_edges / max(self.n_vertices, 1)

    def hop_expansion(self, reverse: bool = False,
                      label: Optional[str] = None) -> float:
        """Label-aware per-hop fan-out: live edges per vertex of the label a
        traversal expands *from* (src label forward, dst label reverse, or an
        explicit ``label`` override for per-hop estimates on mixed-label
        chains). On bipartite graphs this differs from ``avg_out_degree`` by
        the label size ratio, which is exactly the error the global average
        makes on reverse traversals. Consistent with pending delta segments:
        both the live-edge count and the merged vertex tables include the
        delta."""
        if label is None:
            label = self.dst_label if reverse else self.src_label
        return self.n_live_edges / max(self.vertex_tables[label].nrows, 1)

    # ---- base ⊕ delta topology reads ----
    def expand(self, frontier: np.ndarray, reverse: bool = False
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Whole-frontier adjacency expansion over base CSR ⊕ delta segments
        minus tombstones. Returns (pos, dst_nid, edge_tid) with ``pos``
        indexing into ``frontier``; output is grouped by frontier position."""
        frontier = np.asarray(frontier, dtype=np.int64)
        csr = self.rev if reverse else self.fwd
        d = self.delta
        delta_free = not d.segments and not d.n_tombstones
        in_base = frontier < self._n_base_vertices
        if delta_free and (frontier.size == 0 or in_base.all()):
            return _csr_expand(csr, frontier)

        parts = []
        if in_base.all():
            parts.append(_csr_expand(csr, frontier))
        else:
            idx = np.nonzero(in_base)[0]
            pos, dst, eid = _csr_expand(csr, frontier[idx])
            parts.append((idx[pos], dst, eid))
        for seg in d.segments:
            parts.append(seg.neighbors(frontier, reverse=reverse))
        if len(parts) == 1:
            pos, dst, eid = parts[0]  # already grouped by frontier position
            if d.n_tombstones:
                keep = d.live_mask_for(eid)
                pos, dst, eid = pos[keep], dst[keep], eid[keep]
            return pos, dst, eid
        pos = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        eid = np.concatenate([p[2] for p in parts])
        if d.n_tombstones:
            keep = d.live_mask_for(eid)
            pos, dst, eid = pos[keep], dst[keep], eid[keep]
        order = np.argsort(pos, kind="stable")
        return pos[order], dst[order], eid[order]

    # ---- updates (paper §4.4 staged insertion, LSM-buffered) ----
    def _charge_write(self, **ops) -> None:
        """Charge write/compaction cost to this graph's counters (surfaced
        through the registry as ``deltastore.<graph>.<field>``)."""
        self.write_counters.bump(**ops)

    def _notify(self, op: str, payload: dict) -> None:
        for fn in self.listeners:
            fn(self, op, payload)

    def insert_vertices(self, label: str, rows: dict[str, np.ndarray]) -> None:
        """Vertex-only batch insertion: records buffered (RecordAM deferred
        to the lazy merge), fresh nids appended after the base nid space;
        adjacency untouched (the paper's vertex-only fast path). O(batch)."""
        base = self._base_vertex_tables[label]
        cols = {k: np.asarray(rows[k]) if not isinstance(base.columns[k], RaggedColumn)
                else rows[k] for k in base.columns}
        lens = {len(v) for v in cols.values()}
        if len(lens) != 1:
            raise ValueError(f"ragged insert batch for {label}: "
                             f"{ {k: len(v) for k, v in cols.items()} }")
        n_new = lens.pop()
        if n_new == 0:
            return
        start = self._n_base_vertices + self.delta.n_new_vertices_total
        nids = np.arange(start, start + n_new, dtype=np.int64)
        vid0 = self._base_label_rows[label] + self.delta.n_new_vertices.get(label, 0)
        self.delta.buffer_vertices(label, cols, nids)
        self._vlc.append(np.full(n_new, self._label_code[label], dtype=np.int8))
        self._vvo.append(np.arange(vid0, vid0 + n_new, dtype=np.int64))
        self.epoch += 1
        self._charge_write(write_batches=1, write_rows=n_new, write_ops=n_new)
        self._notify("insert_vertices", {"label": label, "rows": cols})
        self._maybe_compact()

    def insert_edges(self, rows: dict[str, np.ndarray]) -> None:
        """Edge batch insertion: records buffered, topology absorbed as one
        immutable delta-CSR segment (forward + reverse). O(batch log batch)."""
        from . import deltastore
        cols = {k: rows[k] for k in self._base_edges.columns}
        svid = np.asarray(cols["svid"])
        tvid = np.asarray(cols["tvid"])
        n_new = len(svid)
        if n_new == 0:
            return
        src_nid = np.atleast_1d(self.nid_of(self.src_label, svid)).astype(np.int64)
        dst_nid = np.atleast_1d(self.nid_of(self.dst_label, tvid)).astype(np.int64)
        eid0 = self._n_base_edges + self.delta.n_new_edges
        eids = np.arange(eid0, eid0 + n_new, dtype=np.int64)
        seg = deltastore.EdgeSegment(src_nid, dst_nid, eids)
        self.delta.buffer_edges(cols, seg)
        self._src_nid.append(src_nid)
        self._dst_nid.append(dst_nid)
        self.epoch += 1
        self._charge_write(
            write_batches=1, write_rows=n_new,
            write_ops=n_new * max(int(np.ceil(np.log2(max(n_new, 2)))), 1))
        self._notify("insert_edges", {"rows": cols})
        self._maybe_compact()

    def delete_edges(self, edge_tids: np.ndarray) -> None:
        """Edge deletion: tombstone bitmap only — edge tids stay stable and
        the record rows remain in place until compaction. O(batch)."""
        tids = np.asarray(edge_tids)
        if len(tids) == 0:
            return
        fresh = self.delta.tombstone_edges(tids)
        if fresh == 0:
            return  # idempotent re-delete: content (and epoch) unchanged
        self.epoch += 1
        self._charge_write(write_batches=1, write_rows=fresh,
                           write_ops=len(tids))
        self._notify("delete_edges", {"edge_tids": tids})
        self._maybe_compact()

    # ---- compaction (the amortized rebuild) ----
    def _maybe_compact(self) -> None:
        from . import deltastore
        if deltastore.should_compact(self.delta_config, self.delta,
                                     self._n_base_edges):
            self.compact()

    def compact(self) -> None:
        """Fold the delta into a fresh base: merge record runs, drop
        tombstoned edge rows (renumbering edge tids), rebuild CSRs and
        mappers. Restores contiguous label-block nid layout. Pure merges
        leave the epoch alone (content and tids unchanged), but dropping
        tombstones renumbers edge tids, which IS observable through
        tid-projecting queries — so that case advances the epoch."""
        import time
        if not self.delta.has_pending():
            return
        t0 = time.perf_counter()
        renumbered = self.delta.n_tombstones > 0
        vt = {lbl: self.vertex_table(lbl) for lbl in self.labels}
        edges = self.edges
        if renumbered:
            edges = edges.take(np.nonzero(self.delta.live_edge_mask())[0])
        self._set_base(vt, edges)
        if renumbered:
            self.epoch += 1
        self.compactions += 1
        self.last_compact_seconds = time.perf_counter() - t0
        self._charge_write(
            compactions=1,
            compact_ops=self._n_base_vertices + self._n_base_edges)

    def _rebuild_topology(self):
        """Deprecated alias kept for API compatibility: the full rebuild now
        only happens inside ``compact``."""
        self.compact()


def _csr_expand(csr: CSR, frontier: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR.neighbors variant returning frontier *positions* instead of
    repeated source nids (callers join path prefixes through positions)."""
    from .deltastore import expand_runs
    deg = csr.row_ptr[frontier + 1] - csr.row_ptr[frontier]
    pos, slots = expand_runs(csr.row_ptr[frontier], deg)
    return pos, csr.col_idx[slots].astype(np.int64), csr.edge_id[slots].astype(np.int64)


# ---------------------------------------------------------------------------
# Partitioned views (sharded execution; see docs/architecture.md)
# ---------------------------------------------------------------------------


def _col_slice(c: Column, lo: int, hi: int) -> Column:
    """Zero-copy contiguous row slice of a column (shards never re-gather)."""
    if isinstance(c, DictColumn):
        return DictColumn(codes=c.codes[lo:hi], vocab=c.vocab)
    if isinstance(c, RaggedColumn):
        off = c.offsets
        return RaggedColumn(values=c.values[off[lo]:off[hi]],
                            offsets=off[lo:hi + 1] - off[lo])
    return np.asarray(c)[lo:hi]


def shard_bounds(n: int, k: int, align: int = 1) -> list[tuple[int, int]]:
    """K contiguous [lo, hi) row blocks covering ``n`` rows, with block
    boundaries rounded up to multiples of ``align`` (zone-chunk alignment:
    a zone-map chunk never straddles two shards, so per-shard zone pruning
    stays exact). Trailing shards may be empty when n < k*align."""
    k = max(int(k), 1)
    step = -(-n // k)                       # ceil
    if align > 1:
        step = -(-step // align) * align    # round up to the alignment
    bounds = []
    for i in range(k):
        lo = min(i * step, n)
        hi = min(lo + step, n)
        bounds.append((lo, hi))
    return bounds


class TableShards:
    """Contiguous row-block partitioning of one :class:`Table`: per-shard
    column slices (zero-copy), per-shard :class:`ColumnStats`, and the
    additive :func:`merge_stats` rollup. ``install_stats`` places the merged
    rollup into the table's stats cache, so the optimizer's cardinality
    model reads shard-rolled statistics through the unchanged
    ``Table.stats`` API. Boundaries are zone-chunk aligned (``align``)."""

    def __init__(self, table: Table, k: int, align: int = 2048):
        self.table = table
        self.k = max(int(k), 1)
        self.bounds = shard_bounds(table.nrows, self.k, align)

    def shard(self, i: int) -> Table:
        lo, hi = self.bounds[i]
        return Table(f"{self.table.name}#{i}",
                     {n: _col_slice(c, lo, hi)
                      for n, c in self.table.columns.items()})

    def shard_stats(self, col: str) -> list[ColumnStats]:
        return [compute_stats(_col_slice(self.table.columns[col], lo, hi))
                for lo, hi in self.bounds]

    def merged_stats(self, col: str) -> ColumnStats:
        return merge_stats(self.shard_stats(col))

    def install_stats(self, col: str) -> ColumnStats:
        s = self.merged_stats(col)
        self.table._stats[col] = s
        return s

    def rows_per_shard(self) -> list[int]:
        return [hi - lo for lo, hi in self.bounds]


class GraphPartitions:
    """Contiguous nid-block partitioning of one :class:`Graph`'s topology.
    Each partition sees a zero-copy CSR window (``csr_block``), the
    per-partition sub-runs of every pending delta segment
    (``delta_views`` — two binary searches per segment, no copies), and its
    share of the tombstone bitmap — so O(batch) writes and epoch stamping
    are preserved per partition: the partitioning is a *view*, rebuilt lazily
    (``fresh``) when the graph's epoch moves past the stamped one."""

    def __init__(self, g: Graph, k: int):
        self.graph = g
        self.k = max(int(k), 1)
        self.epoch = g.epoch
        self.bounds = shard_bounds(g.n_vertices, self.k)

    def fresh(self) -> bool:
        return self.epoch == self.graph.epoch

    def csr_block(self, i: int, reverse: bool = False
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Partition i's window of the base CSR: ``(row_ptr, col_idx,
        edge_id, nid_lo)`` where ``row_ptr`` spans the block's vertices
        (absolute slot offsets — slice ``col_idx``/``edge_id`` with them)."""
        csr = self.graph.rev if reverse else self.graph.fwd
        lo, hi = self.bounds[i]
        lo = min(lo, csr.n_vertices)
        hi = min(hi, csr.n_vertices)
        rp = csr.row_ptr[lo:hi + 1]
        s0, s1 = (int(rp[0]), int(rp[-1])) if len(rp) else (0, 0)
        return rp, csr.col_idx[s0:s1], csr.edge_id[s0:s1], lo

    def delta_views(self, i: int, reverse: bool = False) -> list:
        lo, hi = self.bounds[i]
        return [seg.range_view(lo, hi, reverse=reverse)
                for seg in self.graph.delta.segments]

    def edges_per_partition(self) -> list[int]:
        """Live base+delta edge counts per partition (skew diagnostics)."""
        out = []
        live = self.graph.delta.live_edge_mask()
        for i in range(self.k):
            rp, _, eid, _ = self.csr_block(i)
            n = int(live[eid].sum()) if len(eid) else 0
            for _, _, deid in self.delta_views(i):
                if len(deid):
                    n += int(live[deid].sum())
            out.append(n)
        return out

    def tombstones_per_partition(self) -> list[int]:
        out = []
        live = self.graph.delta.live_edge_mask()
        for i in range(self.k):
            _, _, eid, _ = self.csr_block(i)
            n = int((~live[eid]).sum()) if len(eid) else 0
            for _, _, deid in self.delta_views(i):
                if len(deid):
                    n += int((~live[deid]).sum())
            out.append(n)
        return out


# ---------------------------------------------------------------------------
# Database catalog
# ---------------------------------------------------------------------------


class Database:
    """The unified store: relational tables, shredded document collections,
    and graphs, one namespace (paper Fig. 2(a))."""

    def __init__(self):
        self.tables: dict[str, Table] = {}
        self.graphs: dict[str, Graph] = {}
        self._table_epochs: dict[str, int] = {}
        self._index_manager = None      # created lazily by ``indexes``
        # mutation listeners: fn(op, name) called on touch_table (workload
        # capture — see repro_torch.core.observe)
        self.listeners: list = []

    @property
    def indexes(self):
        """The database's secondary-index catalog (one
        :class:`repro_torch.core.index.IndexManager`, created on first access)."""
        if self._index_manager is None:
            from .index import IndexManager
            self._index_manager = IndexManager(self)
        return self._index_manager

    def add_table(self, t: Table):
        if t.name in self.tables:
            self._table_epochs[t.name] = self._table_epochs.get(t.name, 0) + 1
        self.tables[t.name] = t

    def add_documents(self, name: str, docs: list[dict]):
        self.add_table(shred_documents(name, docs))

    def add_graph(self, g: Graph):
        if g.name in self.graphs:
            # replacing a graph resets its own epoch counter: carry the old
            # lineage forward so cached GCDA results are invalidated
            self._table_epochs[g.name] = self.epoch_of(g.name) + 1
        self.graphs[g.name] = g

    def touch_table(self, name: str) -> None:
        """Signal an in-place mutation of a relational/document collection
        (bumps its epoch so dependent cached GCDA results are invalidated)."""
        self._table_epochs[name] = self._table_epochs.get(name, 0) + 1
        for fn in self.listeners:
            fn("touch_table", name)

    def epoch_of(self, name: str) -> int:
        """Write epoch of a collection. Graphs track their own epoch; the
        epoch-base entry accounts for whole-graph replacement."""
        if name in self.graphs:
            return self._table_epochs.get(name, 0) + self.graphs[name].epoch
        return self._table_epochs.get(name, 0)

    def collection(self, name: str):
        if name in self.tables:
            return self.tables[name]
        if name in self.graphs:
            return self.graphs[name]
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Carrying a database across from plain arrays
# ---------------------------------------------------------------------------


def _column_from_spec(spec) -> Column:
    """A column from its plain-array form: an array, ``{"codes", "vocab"}``
    (a :class:`DictColumn`) or ``{"values", "offsets"}`` (a
    :class:`RaggedColumn`)."""
    if isinstance(spec, dict):
        if "codes" in spec:
            return DictColumn(codes=spec["codes"], vocab=spec["vocab"])
        return RaggedColumn(values=spec["values"], offsets=spec["offsets"])
    return np.asarray(spec)


def _table_from_spec(name: str, cols: dict) -> Table:
    return Table(name, {c: _column_from_spec(v) for c, v in cols.items()})


def database_from_arrays(spec: dict) -> Database:
    """Build a :class:`Database` from plain numpy arrays — the way a
    database state is carried into this package (the system's "weights"
    are its data). ``spec`` holds:

      * ``tables``: name -> {column -> array | {"codes", "vocab"} |
        {"values", "offsets"}};
      * ``graphs``: name -> {"vertex_tables": {label: (table name,
        columns)}, "edges": (table name, columns), "src_label",
        "dst_label", "epoch", "compactions", "pending_writes"};
      * ``epochs``: collection name -> its catalog epoch counter.

    Graphs are carried as settled bases: a graph whose ``pending_writes``
    (delta rows and tombstones not yet compacted) is not 0 is refused —
    compact it first."""
    db = Database()
    for name, cols in spec.get("tables", {}).items():
        db.add_table(_table_from_spec(name, cols))
    for name, gs in spec.get("graphs", {}).items():
        pending = int(gs.get("pending_writes", 0))
        if pending:
            raise ValueError(f"graph {name!r} has {pending} pending delta "
                             "writes; compact() it before carrying it "
                             "across")
        vts = {lbl: _table_from_spec(tname, cols)
               for lbl, (tname, cols) in gs["vertex_tables"].items()}
        ename, ecols = gs["edges"]
        g = Graph(name, vts, _table_from_spec(ename, ecols),
                  gs["src_label"], gs["dst_label"])
        g.epoch = int(gs.get("epoch", 0))
        g.compactions = int(gs.get("compactions", 0))
        db.add_graph(g)
    db._table_epochs.update({k: int(v)
                             for k, v in spec.get("epochs", {}).items()})
    return db
