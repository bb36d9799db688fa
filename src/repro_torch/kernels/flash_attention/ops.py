"""Public entry point for attention: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. ``use_kernel=False`` forces the
plain version; ``use_kernel=True`` on a CPU tensor raises."""
from __future__ import annotations

from . import flash_attention as _kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, lengths=None, *, causal: bool = True,
                    use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return flash_attention_ref(q, k, v, lengths, causal=causal)
    return _kernel.flash_attention(q, k, v, lengths, causal=causal)
