from __future__ import annotations

from . import cosine_sim as _kernel
from .ref import cosine_sim_ref


def cosine_sim(x, y, *, use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return cosine_sim_ref(x, y)
    return _kernel.cosine_sim(x, y)
