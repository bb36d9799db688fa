"""Architecture registry of the port. ``get(arch)`` -> module with:
  * ``config()``       — full published config
  * ``smoke_config()`` — reduced same-family config for CPU smoke tests
  * ``SHAPES``         — dict shape_name -> spec dict (the assigned cells)
  * ``FAMILY``         — "lm" | "gnn" | "recsys" | "db"

The archs of the JAX package, in its order: the two MoE LMs and the
three dense LMs, the four GNNs, Wide & Deep, and the paper's own
``gredo`` workload config (``FAMILY = "db"``; ``all_cells`` skips it, as
the JAX package's registry does).
"""
from __future__ import annotations

import importlib

ARCHS = (
    # LM family
    "olmoe_1b_7b", "granite_moe_1b_a400m", "starcoder2_3b", "qwen2_1_5b",
    "stablelm_3b",
    # GNN
    "gatedgcn", "mace", "equiformer_v2", "pna",
    # RecSys
    "wide_deep",
    # the paper's own workload
    "gredo",
)


def get(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape_name, spec) for every assigned cell."""
    for arch in ARCHS:
        if arch == "gredo":
            continue
        for shape, spec in get(arch).SHAPES.items():
            if spec.get("skip") and not include_skipped:
                continue
            yield arch, shape, spec
