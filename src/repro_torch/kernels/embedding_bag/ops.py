"""Public entry point for the embedding bag: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors. ``use_kernel=False``
forces the plain version; ``use_kernel=True`` on a CPU tensor raises."""
from __future__ import annotations

from . import embedding_bag as _kernel
from .ref import embedding_bag_ref


def embedding_bag(table, indices, weights=None, *,
                  use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = table.is_cuda
    if not use_kernel:
        return embedding_bag_ref(table, indices, weights)
    return _kernel.embedding_bag(table, indices, weights)
