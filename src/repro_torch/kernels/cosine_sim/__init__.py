from .ops import cosine_sim
from .ref import cosine_sim_ref

__all__ = ["cosine_sim", "cosine_sim_ref"]
