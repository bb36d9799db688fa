"""Architecture registry of the port. ``get(arch)`` -> module with:
  * ``config()``       — full published config
  * ``smoke_config()`` — reduced same-family config for CPU smoke tests
  * ``SHAPES``         — dict shape_name -> spec dict (the assigned cells)
  * ``FAMILY``         — "lm"

Only the ported archs are listed: the three dense LMs. The MoE LMs
(``olmoe_1b_7b``, ``granite_moe_1b_a400m``), the GNNs, recsys and the
``gredo`` workload config come with the modules they need (ROADMAP,
queue 1 item 10).
"""
from __future__ import annotations

import importlib

ARCHS = ["starcoder2_3b", "qwen2_1_5b", "stablelm_3b"]


def get(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape_name, spec) for every assigned cell."""
    for arch in ARCHS:
        for shape, spec in get(arch).SHAPES.items():
            if spec.get("skip") and not include_skipped:
                continue
            yield arch, shape, spec
