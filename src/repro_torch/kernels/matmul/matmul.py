"""Wrapper of the tiled CUDA matmul kernel (``csrc/matmul.cu``) — the
MULTIPLY GCDA operator's hot loop."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper

_ENTRY = {torch.float32: "gredo_matmul_f32",
          torch.bfloat16: "gredo_matmul_bf16"}


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C = x @ y on the card, fp32 accumulation, output in x's dtype. ``x``
    must be contiguous; ``y`` contiguous or the transpose of a contiguous
    matrix (``x.T`` of the Gram product), which is read in place."""
    global launches
    _lib.require_cuda("matmul", x, y)
    if x.dtype not in _ENTRY or y.dtype != x.dtype:
        raise TypeError(f"matmul: float32 or bfloat16 inputs of one dtype, "
                        f"got {x.dtype} and {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    if not x.is_contiguous():
        raise ValueError("matmul: x must be contiguous")
    if y.is_contiguous():
        b, b_trans = y, 0
    elif y.T.is_contiguous():
        b, b_trans = y.T, 1
    else:
        raise ValueError("matmul: y must be contiguous or a transposed "
                         "contiguous matrix")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        _lib.launch(_ENTRY[x.dtype], x.data_ptr(), b.data_ptr(),
                    out.data_ptr(), m, n, k, max(k, 1), max(b.stride(0), 1),
                    n, b_trans, _lib.stream_of(x))
    launches += 1
    return out
