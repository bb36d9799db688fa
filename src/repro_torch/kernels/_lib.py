"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and the objects are linked into
one shared library with a plain C interface, loaded with :mod:`ctypes`.
The build happens at the first kernel launch, into ``build/repro_torch/``
at the repository root, in a directory keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused. The
``nvcc`` and ``ptxas`` output (registers, shared memory, spills) is kept
beside the library as ``nvcc.log``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libgredo_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES: dict[str, tuple[list, object]] = {
    "gredo_error_string": ([_I], ctypes.c_char_p),
    "gredo_matmul_f32": ([_P, _P, _P] + [_I] * 7 + [_P], _I),
    "gredo_matmul_bf16": ([_P, _P, _P] + [_I] * 7 + [_P], _I),
    "gredo_cosine_f32": ([_P] * 5 + [_I] * 3 + [_F, _P], _I),
    "gredo_logreg_blocks": ([_I], _I),
    "gredo_logreg_f32": ([_P] * 5 + [_I] * 2 + [_P], _I),
    "gredo_hop_blocks": ([_I], _I),
    "gredo_hop_count": ([_P] * 10 + [_I] * 9 + [_P], _I),
    "gredo_hop_scatter": ([_P] * 14 + [_I] * 9 + [_P], _I),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None     # wall time of the build (or reuse)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_hash(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (or reuse the library
    already built from identical sources) and return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _source_hash(sources + sorted(CSRC.glob("*.cuh")))
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{tag}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (exit {p.returncode})\n{out}")
        if p.returncode:
            failed.append(src.name)
    (out_dir / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, so)          # atomic: a concurrent build never sees half
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        build_seconds = time.perf_counter() - t0
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` and raise on a launch error."""
    err = getattr(lib(), name)(*args)
    if err:
        msg = lib().gredo_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def query(name: str, *args) -> int:
    """Call a C helper that returns a plain integer (grid sizes)."""
    return getattr(lib(), name)(*args)


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """A kernel wrapper's device check: every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got one on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
