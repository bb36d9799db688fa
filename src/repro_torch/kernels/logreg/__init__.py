from .ops import logreg_grad
from .ref import logreg_grad_ref

__all__ = ["logreg_grad", "logreg_grad_ref"]
