"""Wrapper of the random-access matrix generation CUDA kernel
(``csrc/matgen.cu``) — the RandomAccessMatrix GCDA operator.

The (group id, value) pairs come from host operators, so they arrive on the
host: the host ranks the group ids (``rank``: the order ``np.unique``
gives), stages each pair's row and value to the card in one page-locked
buffer with a copy that does not block, and the card zeroes the (N, d)
output and scatters the pairs into it. The host never holds the matrix and
reads nothing back."""
from __future__ import annotations

import numpy as np
import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper

# Id slots per pair up to which ``rank`` counts instead of sorting: its
# flags and running count (9 bytes a slot) then take at most 36 bytes a
# pair.
SPAN_PER_PAIR = 4


def rank(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct ids of ``rows`` (integers) in ascending order and each
    pair's index among them: ``np.unique(rows, return_inverse=True)``.
    Where the ids span at most ``SPAN_PER_PAIR`` slots a pair, a flag per
    slot and a running count give them without a sort."""
    if not len(rows) or not np.can_cast(rows.dtype, np.int64):
        return np.unique(rows, return_inverse=True)
    lo, hi = int(rows.min()), int(rows.max())
    if hi - lo + 1 > SPAN_PER_PAIR * len(rows):
        return np.unique(rows, return_inverse=True)
    slot = np.subtract(rows, lo, dtype=np.int64)
    flags = np.zeros(hi - lo + 1, dtype=bool)
    flags[slot] = True
    ids = (np.flatnonzero(flags) + lo).astype(rows.dtype)
    return ids, (np.cumsum(flags, dtype=np.intp) - 1)[slot]


def _values(vals: np.ndarray, n_features: int) -> np.ndarray:
    """The values as the kernel reads them: integers as they are (the int64
    buffer wraps what it cannot hold to a value the range test drops);
    other numbers outside [0, n_features) or NaN as -1, so that the
    truncation to an index comes after the range test, as on the host."""
    if vals.dtype.kind in "biu":
        return vals
    if vals.dtype.kind != "f":
        raise TypeError(f"matgen: numeric values, got {vals.dtype}")
    return np.where((vals >= 0) & (vals < n_features), vals, -1)


def matgen(rows, vals, n_features: int, mode: str = "multi_hot", *,
           device) -> tuple[torch.Tensor, torch.Tensor]:
    """rows, vals: (P,) integer group ids and numeric values on the host
    (arrays or CPU tensors). Returns the (N, n_features) float32 matrix on
    the CUDA ``device`` (one row per distinct id in ascending order; each
    pair with 0 <= value < n_features sets its column to 1 for
    ``multi_hot``, adds 1 to it for any other mode) and the N group ids, on
    the host, in the ids' dtype. The same bits as ``ref.matgen_ref``."""
    global launches
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"matgen: the CUDA kernel needs a CUDA device, "
                         f"got {device}")
    rows, vals = np.asarray(rows), np.asarray(vals)
    if rows.ndim != 1 or vals.shape != rows.shape:
        raise ValueError(f"matgen: shapes {rows.shape} and {vals.shape}")
    if rows.dtype.kind not in "iu":
        raise TypeError(f"matgen: integer group ids, got {rows.dtype}")
    if n_features < 0:
        raise ValueError(f"matgen: {n_features} features")
    vals = _values(vals, n_features)
    n = len(rows)
    uniq, row_idx = rank(rows)
    out = torch.empty((len(uniq), n_features), dtype=torch.float32,
                      device=device)
    if n and n_features:
        buf = torch.empty((2 * n,), dtype=torch.int64, pin_memory=True)
        host = buf.numpy()
        host[:n], host[n:] = row_idx, vals
        staged = buf.to(device, non_blocking=True)
        with _lib.on_device(staged.device):
            _lib.launch("gredo_matgen_scatter", staged.data_ptr(),
                        staged[n:].data_ptr(), n, out.data_ptr(), len(uniq),
                        n_features, int(mode != "multi_hot"),
                        _lib.stream_of(staged))
        launches += 1
    return out, torch.from_numpy(uniq)
