"""Parallel GCDA operators (paper §5.4, Table 3) + matrix generation.

* Matrix generation: ``rel2matrix`` (local access — columnar reads, no
  tuple-at-a-time scan) and ``random_access_matrix`` (aggregate multi-valued
  attributes from qualifying records into multi-hot / count features). Both
  return float32 tensors on the requested device.
* Analytical operators: MULTIPLY / SIMILARITY / REGRESSION, block-tiled
  CUDA kernels on the card (their plain PyTorch versions on the CPU). The
  JAX package's device-mesh forms are not ported yet (ROADMAP queue 1,
  item 11).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.cosine_sim.ops import cosine_sim as _cosine_op
from ..kernels.logreg.ops import logreg_grad as _logreg_op
from ..kernels.matmul.ops import matmul as _matmul_op
from .storage import DictColumn, RaggedColumn, Table

_MESH_TODO = ("device-mesh GCDA is not ported yet (ROADMAP queue 1, item "
              "11: the mesh paths of core/analytics.py)")


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


def random_access_matrix(table: Table, group_col: str, value_col: str,
                         n_features: int, mode: str = "multi_hot",
                         device: "torch.device | str" = "cuda"
                         ) -> tuple[torch.Tensor, np.ndarray]:
    """Random access — aggregate (multi-valued) attributes of qualifying
    records into per-group feature rows. Returns (matrix, group_ids): row i
    holds the multi-hot / count vector of ``value_col`` over group i, as a
    float32 tensor on ``device``."""
    groups = np.asarray(table.col(group_col))
    vcol = table.col(value_col)
    if isinstance(vcol, RaggedColumn):
        rows = np.repeat(groups, vcol.lengths())
        vals = np.asarray(vcol.values)
    else:
        rows = groups
        vals = np.asarray(vcol)
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


def flops_estimate(op: str, shapes: Sequence[Sequence[int]],
                   iters: int = 1) -> float:
    """Analytic floating-point work of one analytical-operator execution,
    from its input shapes — the kernel-span payload telemetry attaches.
    ``op`` is a physical-operator kind ("MatMul" / "Similarity" /
    "Regression"); unknown ops and degenerate shapes cost 0."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    if not shapes or len(shapes[0]) != 2:
        return 0.0
    m, k = shapes[0]
    if op == "MatMul":
        n = shapes[1][1] if len(shapes) > 1 and len(shapes[1]) == 2 else m
        return 2.0 * m * k * n
    if op == "Similarity":
        # fused cosine: the dot products plus both norm reductions
        n = shapes[1][0] if len(shapes) > 1 and len(shapes[1]) == 2 else m
        return 3.0 * m * k * n
    if op == "Regression":
        # per iteration: forward matvec + gradient matvec over (m, k)
        return 4.0 * m * k * max(iters, 1)
    return 0.0


def multiply(x: torch.Tensor, y: torch.Tensor, *, mesh: Optional[object] = None,
             use_kernel: bool | None = None) -> torch.Tensor:
    """MULTIPLY: Z = X·Y via the tiled matmul kernel."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    return _matmul_op(x, y, use_kernel=use_kernel)


def similarity(x: torch.Tensor, y: torch.Tensor, *,
               mesh: Optional[object] = None,
               use_kernel: bool | None = None) -> torch.Tensor:
    """SIMILARITY: pairwise cosine scores via the fused kernel."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    return _cosine_op(x, y, use_kernel=use_kernel)


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


def regression_distributed(x, y, mesh, *, iters: int = 50, lr: float = 0.5,
                           l2: float = 1e-4):
    """Data-parallel REGRESSION over a device mesh — not ported yet."""
    raise NotImplementedError(_MESH_TODO)
