"""In-memory inter-buffer for matrix storage (paper §4.2, §6.4).

Materializes GCDI results as device-resident matrices that analytical
operators consume directly (no tuple-at-a-time production). Entries are
keyed by a *structural fingerprint* of the producing GCDI plan + matrix
generation spec, so semantically-equivalent GCDIA tasks reuse materialized
outputs without re-execution (paper: "intermediate results in the
inter-buffer are reused across analytical tasks via structural matching of
GCDI plans").
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch


def fingerprint(*parts: Any) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
    return h.hexdigest()[:16]


def _column_nbytes(col) -> int:
    if hasattr(col, "codes"):       # DictColumn: codes + a vocab estimate
        return int(col.codes.nbytes) + 16 * len(col.vocab)
    if hasattr(col, "offsets"):     # RaggedColumn
        return int(np.asarray(col.values).nbytes) + int(col.offsets.nbytes)
    return int(np.asarray(col).nbytes)


def value_nbytes(val) -> int:
    """Resident size of an inter-buffer entry: a device matrix or a
    materialized GCDI relation (columnar Table)."""
    if hasattr(val, "columns"):     # Table duck type
        return sum(_column_nbytes(c) for c in val.columns.values())
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if hasattr(val, "size") and hasattr(val, "dtype"):
        return int(val.size) * val.dtype.itemsize
    return int(np.asarray(val).nbytes)


class InterBuffer:
    """LRU over an :class:`OrderedDict` (MRU at the end). Re-putting an
    existing key replaces it in place (no duplicate order entries), and
    eviction may drop every entry — a single matrix larger than the capacity
    is not retained.

    Admission is cost-aware: a put carrying an ``est_cost`` (the §6.3
    estimated recompute cost of the producing sub-plan) is only admitted
    when that cost exceeds a footprint-scaled threshold
    (``admit_cost_per_byte`` cost units per resident byte) — cheap-to-
    recompute bulky intermediates bypass the cache instead of evicting
    expensive ones. Puts without an estimate are always admitted.

    Thread-safe: morsel workers of the sharded executor hit ``get``/``put``
    concurrently, so the store, byte accounting, and hit/miss counters are
    guarded by one lock (LRU reordering under concurrency must not corrupt
    the OrderedDict)."""

    def __init__(self, capacity_bytes: int = 2 << 30,
                 admit_cost_per_byte: float = 0.0, *,
                 device: "torch.device | str"):
        self.capacity_bytes = capacity_bytes
        self.admit_cost_per_byte = admit_cost_per_byte
        self.device = device          # where host matrices are staged
        self._store: OrderedDict[str, torch.Tensor] = OrderedDict()
        self._lock = threading.Lock()
        self._nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bypasses = 0

    def get(self, key: str):
        with self._lock:
            mat = self._store.get(key)
            if mat is not None:
                self.hits += 1
                self._store.move_to_end(key)
                return mat
            self.misses += 1
            return None

    def admits(self, nbytes: int, est_cost: Optional[float]) -> bool:
        if est_cost is None or self.admit_cost_per_byte <= 0:
            return True
        return est_cost >= self.admit_cost_per_byte * max(nbytes, 1)

    def put(self, key: str, mat, est_cost: Optional[float] = None):
        if not hasattr(mat, "columns"):   # matrices live on device; Tables as-is
            mat = torch.as_tensor(mat, device=self.device)
        with self._lock:
            if not self.admits(value_nbytes(mat), est_cost):
                self.bypasses += 1
                return mat
            old = self._store.pop(key, None)
            if old is not None:
                self._nbytes -= value_nbytes(old)
            self._store[key] = mat
            self._nbytes += value_nbytes(mat)
            self._evict()
            return mat

    def counters(self) -> str:
        """One-line hit/bypass accounting for explain output."""
        return (f"hits={self.hits} misses={self.misses} "
                f"bypasses={self.bypasses} evictions={self.evictions} "
                f"entries={len(self)} bytes={self._nbytes}")

    def metrics(self) -> dict:
        """Numeric counter snapshot — the telemetry registry source. hits/
        misses/bypasses/evictions are cumulative (delta-able); entries/bytes
        are point-in-time gauges."""
        return {"hits": self.hits, "misses": self.misses,
                "bypasses": self.bypasses, "evictions": self.evictions,
                "entries": len(self), "bytes": self._nbytes}

    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self):
        return len(self._store)

    def _evict(self):
        # caller holds self._lock
        while self._nbytes > self.capacity_bytes and self._store:
            _, victim = self._store.popitem(last=False)
            self._nbytes -= value_nbytes(victim)
            self.evictions += 1

    def clear(self):
        with self._lock:
            self._store.clear()
            self._nbytes = 0
