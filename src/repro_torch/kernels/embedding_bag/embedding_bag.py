"""Wrapper of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``)."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = sum_j weights[i, j] * table[indices[i, j]] in float32.
    table: (V, D) float32; indices: (n_bags, bag) int32, -1 = padding
    (weight 0); weights: (n_bags, bag) float32 or None (1 for every valid
    slot). All contiguous, on one card. Indices are not checked against V
    (that needs a device-to-host copy): one >= V is the caller's error, and
    the kernel reads row V - 1 for it."""
    global launches
    extra = () if weights is None else (weights,)
    _lib.require_cuda("embedding_bag", table, indices, *extra)
    if table.dtype != torch.float32 or indices.dtype != torch.int32 or \
            (weights is not None and weights.dtype != torch.float32):
        raise TypeError(f"embedding_bag: float32 table and weights, int32 "
                        f"indices, got {table.dtype}, {indices.dtype}, "
                        f"{None if weights is None else weights.dtype}")
    if table.dim() != 2 or indices.dim() != 2 or table.shape[0] == 0 or \
            (weights is not None and weights.shape != indices.shape):
        raise ValueError(f"embedding_bag: shapes table {tuple(table.shape)}, "
                         f"indices {tuple(indices.shape)}, weights "
                         f"{None if weights is None else tuple(weights.shape)}")
    for name, t in (("table", table), ("indices", indices)) + tuple(
            ("weights", w) for w in extra):
        if not t.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be contiguous")
    n_bags, bag = indices.shape
    V, D = table.shape
    out = torch.empty((n_bags, D), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        _lib.launch("gredo_embedding_bag_f32", table.data_ptr(),
                    indices.data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    out.data_ptr(), n_bags, bag, V, D, _lib.stream_of(table))
    launches += 1
    return out
