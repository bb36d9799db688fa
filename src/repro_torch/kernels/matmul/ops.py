"""Public entry point for MULTIPLY: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. ``use_kernel=False`` forces the
plain version (the caller's ablation switch); ``use_kernel=True`` on a CPU
tensor raises."""
from __future__ import annotations

from . import matmul as _kernel
from .ref import matmul_ref


def matmul(x, y, *, use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return matmul_ref(x, y)
    return _kernel.matmul(x, y)
