from .ops import matgen
from .ref import matgen_ref

__all__ = ["matgen", "matgen_ref"]
