"""Runs a function on several CPU ranks of a gloo process group, for the
port's mesh tests (the counterpart of the JAX package's
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` subprocesses).

    results = run_ranks(fn, 8, tmp_path, *args)   # fn(rank, world, *args)

Each rank is a process started with ``torch.multiprocessing.
start_processes(..., start_method="spawn")``; the group meets through a
``FileStore`` under ``tmp_path`` (no TCP port, so parallel test workers
cannot collide). ``fn`` must be importable (a module-level function), its
arguments and result picklable; ``results[r]`` is rank r's result. One
launch takes a few seconds, so a test batches several checks into one
``fn``. A launch that takes longer than ``timeout`` seconds is killed and
fails the test instead of hanging the suite."""
from __future__ import annotations

import os
import pickle
import time


def _rank_main(rank, fn, world, store_path, out_dir, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store_path, world))
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 300.0):
    import torch.multiprocessing as mp

    out_dir = os.fspath(tmp_path)
    store = os.path.join(out_dir, f"store_{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, store, out_dir,
                                               args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran over {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


class world_of_one:
    """A gloo process group of this process alone, for the length of a
    ``with`` block (a 1x1 mesh over it runs every collective for real)."""

    def __enter__(self):
        import torch.distributed as dist
        dist.init_process_group("gloo", rank=0, world_size=1,
                                store=dist.HashStore())
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False
