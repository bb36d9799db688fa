from .ops import matmul
from .ref import matmul_ref

__all__ = ["matmul", "matmul_ref"]
