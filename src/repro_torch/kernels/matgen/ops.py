"""Public entry point for random-access matrix generation. The pairs come
from host operators, so they arrive on the host and ``device`` says where
the matrix goes: the CUDA kernel for a CUDA device, the plain PyTorch
version otherwise. ``use_kernel=False`` forces the plain version;
``use_kernel=True`` with a CPU device raises."""
from __future__ import annotations

import torch

from . import matgen as _kernel
from .ref import matgen_ref


def matgen(rows, vals, n_features: int, mode: str = "multi_hot", *,
           device="cpu", use_kernel: bool | None = None):
    """(matrix, group ids): the matrix on ``device``, the group ids where
    the pairs are."""
    if use_kernel is None:
        use_kernel = torch.device(device).type == "cuda"
    if not use_kernel:
        mat, groups = matgen_ref(rows, vals, n_features, mode)
        return mat.to(device), groups
    return _kernel.matgen(rows, vals, n_features, mode, device=device)
