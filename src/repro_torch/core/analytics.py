"""Parallel GCDA operators (paper §5.4, Table 3) + matrix generation.

* Matrix generation: ``rel2matrix`` (local access — columnar reads, no
  tuple-at-a-time scan) and ``random_access_matrix`` (aggregate multi-valued
  attributes from qualifying records into multi-hot / count features). Both
  return float32 tensors on the requested device; on the card, random
  access stages only its pairs and the ``matgen`` kernel builds the matrix.
* Analytical operators: MULTIPLY / SIMILARITY / REGRESSION, block-tiled
  CUDA kernels on the card (their plain PyTorch versions on the CPU). With
  a mesh (a ``DeviceMesh`` with axes 'data' and 'model' over the current
  process group) each rank runs the same kernel on its own block and the
  ranks meet in ``torch.distributed`` collectives — the distributed form
  of the paper's block scheduler.
* ``volcano``: a literal tuple-at-a-time volcano implementation of the same
  operators on host numpy arrays — the ablation baseline (GredoDB-S /
  GredoDB-D rely on volcano-model execution for GCDA in §7.2).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.cosine_sim.ops import cosine_sim as _cosine_op
from ..kernels.logreg.ops import logreg_grad as _logreg_op
from ..kernels.matgen.ops import matgen as _matgen_op
from ..kernels.matmul.ops import matmul as _matmul_op
from .storage import DictColumn, RaggedColumn, Table

# ---------------------------------------------------------------------------
# Matrix generation (G in Eq. 5)
# ---------------------------------------------------------------------------


def rel2matrix(table: Table, columns: Sequence[str],
               device: "torch.device | str" = "cuda") -> torch.Tensor:
    """REL2MATRIX: local access — assemble numeric columns into an (n, k)
    float32 matrix on ``device`` straight from columnar storage (bypasses
    row iteration)."""
    cols = []
    for c in columns:
        col = table.col(c)
        if isinstance(col, DictColumn):
            cols.append(col.codes.astype(np.float32))
        else:
            cols.append(np.asarray(col, dtype=np.float32))
    return torch.as_tensor(np.stack(cols, axis=1), device=device)


def rel2matrix_sharded(table: Table, columns: Sequence[str], k: int,
                       device: "torch.device | str" = "cuda"
                       ) -> tuple[torch.Tensor, dict]:
    """Born-sharded REL2MATRIX: each contiguous row block is cast to float32
    and staged to the device independently, then the blocks are concatenated
    *device-side* on the one card — the downstream GCDA kernels (MatMul /
    Similarity / Regression) consume the result without a host gather.
    Values are bit-identical to :func:`rel2matrix` (same per-element float32
    cast, same row order); the block layout avoids materializing the full
    host-side matrix at once.

    Returns ``(matrix, spec)`` where ``spec`` is the sharding provenance the
    executor attaches to the operator's trace span (``born_sharded``,
    ``host_gather``, ``shards``, ``sharding``)."""
    from .storage import shard_bounds
    device = torch.device(device)
    cols = [table.col(c) for c in columns]
    blocks = []
    rows_per_block = []
    for lo, hi in shard_bounds(table.nrows, k):
        if lo >= hi:
            continue
        parts = []
        for col in cols:
            if isinstance(col, DictColumn):
                parts.append(col.codes[lo:hi].astype(np.float32))
            else:
                parts.append(np.asarray(col)[lo:hi].astype(np.float32))
        blocks.append(torch.as_tensor(np.stack(parts, axis=1), device=device))
        rows_per_block.append(hi - lo)
    if not blocks:
        mat = torch.zeros((0, len(columns)), dtype=torch.float32,
                          device=device)
    elif len(blocks) == 1:
        mat = blocks[0]
    else:
        mat = torch.cat(blocks, dim=0)
    spec = {"born_sharded": True, "host_gather": False,
            "shards": int(k),
            "sharding": f"blocks={len(blocks)} device={device.type}",
            "rows_per_block": rows_per_block}
    return mat, spec


def random_access_pairs(table: Table, group_col: str, value_col: str
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The (group id, value) pairs of random access: one per record, or one
    per element of a multi-valued ``value_col``."""
    groups = np.asarray(table.col(group_col))
    vcol = table.col(value_col)
    if isinstance(vcol, RaggedColumn):
        return np.repeat(groups, vcol.lengths()), np.asarray(vcol.values)
    return groups, np.asarray(vcol)


def random_access_matrix(table: Table, group_col: str, value_col: str,
                         n_features: int, mode: str = "multi_hot",
                         device: "torch.device | str" = "cuda"
                         ) -> tuple[torch.Tensor, np.ndarray]:
    """Random access — aggregate (multi-valued) attributes of qualifying
    records into per-group feature rows. Returns (matrix, group_ids): row i
    holds the multi-hot / count vector of ``value_col`` over group i, as a
    float32 tensor on ``device``. On a CUDA device the card builds the
    matrix from the pairs (``kernels/matgen``); elsewhere numpy does, as
    the reference. Either way the host ranks the group ids."""
    rows, vals = random_access_pairs(table, group_col, value_col)
    if torch.device(device).type == "cuda":
        mat, groups = _matgen_op(rows, vals, n_features, mode, device=device)
        return mat, groups.numpy()
    uniq, row_idx = np.unique(rows, return_inverse=True)
    mat = np.zeros((len(uniq), n_features), dtype=np.float32)
    ok = (vals >= 0) & (vals < n_features)
    np.add.at(mat, (row_idx[ok], vals[ok].astype(np.int64)), 1.0)
    if mode == "multi_hot":
        mat = np.minimum(mat, 1.0)
    return torch.as_tensor(mat, device=device), uniq


# ---------------------------------------------------------------------------
# Analytical operators (A in Eq. 5): block-parallel kernel execution
# ---------------------------------------------------------------------------


def _block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t``, contiguous: the kernels read rows of a
    contiguous matrix, so a column block (Y's over 'model') is copied once
    here; a row block is a contiguous view already."""
    from ..distributed.sharding import local_block
    return local_block(t, mesh, spec).contiguous()


def multiply(x: torch.Tensor, y: torch.Tensor, *, mesh: Optional[object] = None,
             use_kernel: bool | None = None) -> torch.Tensor:
    """MULTIPLY: Z = X·Y via the tiled matmul kernel; with a mesh, Z is
    tiled (i over 'data', j over 'model') and each rank runs the kernel on
    its X row block and Y column block. Returns a DTensor with placements
    (Shard(0), Shard(1)); ``full_tensor()`` gathers it."""
    if mesh is None:
        return _matmul_op(x, y, use_kernel=use_kernel)
    from ..distributed.sharding import P, from_blocks
    z = _matmul_op(_block(x, mesh, P("data", None)),
                   _block(y, mesh, P(None, "model")), use_kernel=use_kernel)
    return from_blocks(z, mesh, P("data", "model"))


def similarity(x: torch.Tensor, y: torch.Tensor, *,
               mesh: Optional[object] = None,
               use_kernel: bool | None = None) -> torch.Tensor:
    """SIMILARITY: pairwise cosine scores via the fused kernel; with a mesh,
    rank (i, j) scores X's row block i ('data') against Y's row block j
    ('model') and holds tile (i, j) of the (Shard(0), Shard(1)) DTensor."""
    if mesh is None:
        return _cosine_op(x, y, use_kernel=use_kernel)
    from ..distributed.sharding import P, from_blocks
    s = _cosine_op(_block(x, mesh, P("data", None)),
                   _block(y, mesh, P("model", None)), use_kernel=use_kernel)
    return from_blocks(s, mesh, P("data", "model"))


def regression(x: torch.Tensor, y: torch.Tensor, *, iters: int = 100,
               lr: float = 0.5, l2: float = 1e-4,
               use_kernel: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """REGRESSION: train a logistic-regression model with ``iters`` launches
    of the fused gradient kernel. Returns (weights, loss), the loss being
    the one computed at the pre-update weights of the last step (zero when
    ``iters`` is 0)."""
    n, d = x.shape
    y = y.to(device=x.device, dtype=torch.float32)
    w = torch.zeros((d,), dtype=torch.float32, device=x.device)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        g, loss = _logreg_op(x, y, w, use_kernel=use_kernel)
        w = w - lr * (g + l2 * w)
    return w, loss


def regression_distributed(x: torch.Tensor, y: torch.Tensor, mesh, *,
                           iters: int = 50, lr: float = 0.5, l2: float = 1e-4,
                           use_kernel: bool | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel REGRESSION: rows over 'data'; each rank runs the
    gradient kernel on its rows, and one all-reduce per iteration sums the
    partial gradients and losses (the paper's "aggregating contributions
    from each partition in parallel"). Returns (weights, loss) on every
    rank, as :func:`regression`.

    As the JAX package does, the rows are padded with zeros up to a
    multiple of the 'data' size and the sums divided by the real row count
    ``n``: a pad row adds nothing to the gradient but ``softplus(0) = log
    2`` to the loss sum, so for ``n % ranks != 0`` the loss is ``(sum over
    real rows + pad * log 2) / n``, as the reference's."""
    import torch.nn.functional as F
    from ..distributed.sharding import P, axis_size, psum

    n, d = x.shape
    pad = (-n) % axis_size(mesh, "data")
    y = y.to(device=x.device, dtype=torch.float32)
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    yp = F.pad(y, (0, pad)) if pad else y
    xl = _block(xp, mesh, P("data", None))
    yl = _block(yp, mesh, P("data"))
    share = xl.shape[0] / n          # the kernel's means are over local rows
    w = torch.zeros((d,), dtype=torch.float32, device=x.device)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        g, loss = _logreg_op(xl, yl, w, use_kernel=use_kernel)
        gl = psum(torch.cat([g, loss[None]]) * share, mesh, "data")
        g, loss = gl[:d], gl[d]
        w = w - lr * (g + l2 * w)
    return w, loss


# ---------------------------------------------------------------------------
# Volcano baseline: tuple-at-a-time GCDA (ablation §7.2)
# ---------------------------------------------------------------------------


class volcano:
    """Literal tuple-at-a-time execution of the same analytics — each value
    flows through a Python-level iterator chain (the paper's criticism:
    excessive iterator invocations, function-call overhead, no batching)."""

    @staticmethod
    def rel2matrix(table: Table, columns: Sequence[str]) -> np.ndarray:
        out = []
        for i in range(table.nrows):          # tuple at a time
            row = []
            for c in columns:
                col = table.col(c)
                v = col.codes[i] if isinstance(col, DictColumn) else np.asarray(col)[i]
                row.append(float(v))
            out.append(row)
        return np.asarray(out, dtype=np.float32)

    @staticmethod
    def multiply(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        m, k = x.shape
        k2, n = y.shape
        z = np.zeros((m, n), dtype=np.float32)
        for i in range(m):
            for j in range(n):
                acc = 0.0
                for l in range(k):
                    acc += float(x[i, l]) * float(y[l, j])
                z[i, j] = acc
        return z

    @staticmethod
    def similarity(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        m, n = x.shape[0], y.shape[0]
        out = np.zeros((m, n), dtype=np.float32)
        for i in range(m):
            for j in range(n):
                dot = nx = ny = 0.0
                for l in range(x.shape[1]):
                    dot += float(x[i, l]) * float(y[j, l])
                    nx += float(x[i, l]) ** 2
                    ny += float(y[j, l]) ** 2
                out[i, j] = dot / max((nx ** 0.5) * (ny ** 0.5), 1e-12)
        return out

    @staticmethod
    def regression(x: np.ndarray, y: np.ndarray, iters: int = 100,
                   lr: float = 0.5, l2: float = 1e-4) -> tuple[np.ndarray, float]:
        n, d = x.shape
        w = np.zeros(d, dtype=np.float64)
        loss = 0.0
        for _ in range(iters):
            g = np.zeros(d, dtype=np.float64)
            loss = 0.0
            for i in range(n):                 # tuple at a time
                z = 0.0
                for l in range(d):
                    z += float(x[i, l]) * w[l]
                p = 1.0 / (1.0 + np.exp(-z))
                err = p - float(y[i])
                for l in range(d):
                    g[l] += err * float(x[i, l])
                loss += np.logaddexp(0.0, z) - float(y[i]) * z
            w -= lr * (g / n + l2 * w)
        return w.astype(np.float32), float(loss / n)
