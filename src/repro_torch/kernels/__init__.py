"""Hand-written CUDA kernels of the port. Each subpackage ships
<name>.py (the wrapper that launches the kernel on CUDA tensors), ops.py
(dispatch: the kernel for a CUDA tensor, the plain version for a CPU one)
and ref.py (the plain PyTorch version). The sources live in ``csrc/``.

Every wrapper module keeps a plain integer ``launches``, raised by one
where it launches its kernel; :func:`launch_counts` reads them all."""
from __future__ import annotations

import importlib
from typing import NamedTuple


class Kernel(NamedTuple):
    wrapper: str      # module of the wrapper (a function named as the kernel)
    source: str       # its CUDA source, from the repository root
    replaces: str     # the reference's Pallas kernel or host function it
                      # takes the place of (file:line)


KERNELS = {
    "matmul": Kernel(f"{__name__}.matmul.matmul",
                     "src/repro_torch/csrc/matmul.cu",
                     "src/repro/kernels/matmul/matmul.py:46"),
    "cosine_sim": Kernel(f"{__name__}.cosine_sim.cosine_sim",
                         "src/repro_torch/csrc/cosine_sim.cu",
                         "src/repro/kernels/cosine_sim/cosine_sim.py:51"),
    "logreg_grad": Kernel(f"{__name__}.logreg.logreg",
                          "src/repro_torch/csrc/logreg.cu",
                          "src/repro/kernels/logreg/logreg.py:58"),
    "batched_hop": Kernel(f"{__name__}.traversal.traversal",
                          "src/repro_torch/csrc/traversal.cu",
                          "src/repro/kernels/traversal/traversal.py:123"),
    "flash_attention": Kernel(
        f"{__name__}.flash_attention.flash_attention",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:97"),
    "embedding_bag": Kernel(f"{__name__}.embedding_bag.embedding_bag",
                            "src/repro_torch/csrc/embedding_bag.cu",
                            "src/repro/kernels/embedding_bag/embedding_bag.py:56"),
    "matgen": Kernel(f"{__name__}.matgen.matgen",
                     "src/repro_torch/csrc/matgen.cu",
                     "src/repro/core/analytics.py:98"),
}


def wrapper_module(name: str):
    """The wrapper module of kernel ``name`` (its package re-exports the
    dispatching function under the module's name, so reach it by path)."""
    return importlib.import_module(KERNELS[name].wrapper)


def launch_counts() -> dict[str, int]:
    return {name: wrapper_module(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        wrapper_module(name).launches = 0
