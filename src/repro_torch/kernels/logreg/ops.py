from __future__ import annotations

from . import logreg as _kernel
from .ref import logreg_grad_ref


def logreg_grad(x, y, w, *, use_kernel: bool | None = None):
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return logreg_grad_ref(x, y, w)
    return _kernel.logreg_grad(x, y, w)
