"""Wrapper of the fused cosine-similarity CUDA kernel
(``csrc/cosine_sim.cu``) — the SIMILARITY GCDA operator."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper


def cosine_sim(x: torch.Tensor, y: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """x: (m, d), y: (n, d), both contiguous float32 on the card ->
    (m, n) float32 cosine scores."""
    global launches
    _lib.require_cuda("cosine_sim", x, y)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"cosine_sim: float32 inputs, got {x.dtype} and "
                        f"{y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"cosine_sim: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("cosine_sim: inputs must be contiguous")
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    inv_x = torch.empty((m,), dtype=torch.float32, device=x.device)
    inv_y = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _lib.launch("gredo_cosine_f32", x.data_ptr(), y.data_ptr(),
                    inv_x.data_ptr(), inv_y.data_ptr(), out.data_ptr(),
                    m, n, d, eps, _lib.stream_of(x))
    launches += 1
    return out
