"""Wrapper of the two-pass logistic-regression gradient CUDA kernel
(``csrc/logreg.cu``) — the REGRESSION GCDA operator's inner loop."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper


def logreg_grad(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, d), y: (n,) in {0,1}, w: (d,), contiguous float32 on the card.
    Returns (grad (d,), mean loss ()) — deterministic (no atomics)."""
    global launches
    _lib.require_cuda("logreg_grad", x, y, w)
    for name, t in (("x", x), ("y", y), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"logreg_grad: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"logreg_grad: {name} must be contiguous")
    if x.dim() != 2 or y.shape != (x.shape[0],) or w.shape != (x.shape[1],):
        raise ValueError(f"logreg_grad: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}, w {tuple(w.shape)}")
    n, d = x.shape
    if n == 0:
        raise ValueError("logreg_grad: needs at least one row")
    blocks = _lib.query("gredo_logreg_blocks", n)
    part = torch.empty((blocks, d + 1), dtype=torch.float32, device=x.device)
    out = torch.empty((d + 1,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _lib.launch("gredo_logreg_f32", x.data_ptr(), y.data_ptr(),
                    w.data_ptr(), part.data_ptr(), out.data_ptr(), n, d,
                    _lib.stream_of(x))
    launches += 1
    return out[:d], out[d]
