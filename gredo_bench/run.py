#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port of GredoDB, one cell a run.

    python3 gredo_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the repository root on a machine with the cards the cell asks for.
Prints one JSON line as the last line of standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from the
engine's operator statistics and ``torch.profiler`` (``--trace 1``),
whether the answers agreed with the plain reference, and the device. Every
number compared is printed beside its limit as the last lines of standard
error. Without a CUDA card, or without the program beside it, it exits
non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "build" / "gredo_bench"

# One session on the host, one thread of each library pool: idle workers
# that spin between calls took cores from the session on an 8-core host
# (the window ran about 12% slower with the libraries' default pools).
for _pool in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_pool] = "1"


def hold_allocator() -> None:
    """Fix glibc's malloc thresholds (mallopt's M_MMAP_THRESHOLD 1 GiB,
    M_TRIM_THRESHOLD 2 GiB, M_TOP_PAD 256 MiB) before anything allocates
    much. By default a large numpy temporary is mapped afresh and freed
    heap goes back to the kernel, so each task pays page faults, as many as
    the heap's history leaves; held, freed memory is reused after the
    warm-up pass. On an H100 host the GCDI window ran about 20% faster so.
    """
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:                  # not glibc: its allocator as it is
        return
    for param, value in ((-3, 1 << 30), (-1, (1 << 31) - 1), (-2, 1 << 28)):
        if not libc.mallopt(param, value):
            print(f"mallopt({param}, {value}) refused", file=sys.stderr)


hold_allocator()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache a library may keep lives at a fixed path in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from gredo_bench import harness
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
