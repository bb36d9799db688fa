"""Fused traversal kernel family (device-resident GCDI): CSR row-gather +
neighbour expansion + predicate evaluation + compaction in one hop, with a
batched multi-query variant. Layout per the family convention:
traversal.py (the CUDA kernel's wrapper), ops.py (dispatch + whole-chain
runners), ref.py (the plain PyTorch version)."""
from .ops import (COUNTERS, batched_hop, batched_traverse, fused_hop,
                  traverse_chain)
from .ref import batched_hop_ref, fused_hop_ref

__all__ = [
    "fused_hop", "batched_hop", "traverse_chain", "batched_traverse",
    "fused_hop_ref", "batched_hop_ref", "COUNTERS",
]
