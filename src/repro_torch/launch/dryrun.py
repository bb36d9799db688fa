"""Multi-pod dry-run driver of the port.

For every (architecture x input-shape x mesh) cell:
    fake process group of the mesh's world size (``fake`` backend)
    cell     = build_cell(arch, shape, mesh)
    args     = fake tensors, distributed as DTensors at the cell's placements
    record   = one run of the step under FakeTensorMode and StepRecorder
and record the result as JSON under ``--out``.

Nothing is allocated and no device is used: the tensors are fake and the
collectives go to the ``fake`` backend, so this is the one entry point of
the port that runs on the CPU by default (and needs no card). The world is
256 ranks (``(16, 16)``) or 512 with ``--multi-pod``; ``DRYRUN_DEVICE_COUNT``
overrides it, as in the JAX package.

Differences from the JAX package's dry-run, which compiles with XLA:
  * GSPMD propagates one layout through the step; DTensor picks one
    operation by operation. The model code therefore states the layouts
    GSPMD would reach, through the mesh layer's helpers
    (``distributed.sharding``): the activations keep their batch split
    (``keep_batch``), a gather from a split dim is a masked local gather
    and an all-reduce (``take_sharded``: the LM's embedding and its loss's
    gold logits, Wide & Deep's tables), a segment maximum over split edges
    reduces across the ranks (``scatter_extremum``), and what is
    independent per batch row, head, group, node or edge runs on each
    rank's blocks (``on_shards``: attention, the MoE block, MACE's and
    EquiformerV2's products). No cell replicates an operation. An
    operation that DTensor still cannot shard would run on inputs
    replicated over the mesh dims that stop it (the set that adds the
    least work first), and the record would list it under
    ``replicated_ops`` with its count; a step that still fails is recorded
    ``ok: false`` with its error.
  * The per-device FLOPs, bytes and collective bytes come from
    ``hlo_analysis.StepRecorder`` on the ranks' local operations.
    ``flops_per_device`` and ``dot_flops_per_device`` are the same count
    (the matrix products), and so are ``bytes_per_device`` and
    ``hbm_bytes_per_device``; ``temp_bytes`` and ``generated_code_bytes``
    are ``null`` (no compiler plans the buffers); ``compile_s`` is
    ``null``.
  * An LM forward's layers are identical, so a prefill or decode step
    is traced with one layer and with two, and the record is the first
    plus (L - 1) times the difference: every layer counted, as the JAX
    package multiplies a ``while`` body by its trip count, without running
    L layers of fake dispatch (about a millisecond per operation). A
    difference below zero fails the cell. A train step is traced at full
    depth: DTensor lays out the optimizer's update of the layer stacks by
    their size, so its cost is not linear in L.
  * ``top_ops`` lists the operations with the most FLOPs and with the
    most bytes, per device, and (``products``) the products with the most
    FLOPs by their operands' local shapes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out build/repro_torch/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DEFAULT_OUT = "build/repro_torch/dryrun"


class ReplicateOnFailure(TorchDispatchMode):
    """Runs a DTensor operation that DTensor cannot shard on inputs
    replicated over the mesh dims that stop it, the cheapest set first
    (:func:`_replication_order`), and, where DTensor has no rule for it at
    all (or only the whole mesh replicated will do), on every rank's full
    replica of its inputs (the result replicated). An in-place operation
    runs so on copies, and its target then takes the result in its own
    layout; a plain target runs on the full replicas of the other inputs.
    "Cannot shard" is an error, or an output that DTensor cannot take
    further (a strided shard, a masked partial sum, or a local shard whose
    shape disagrees with its layout). ``self.replicated`` counts each such
    operation. The operations of a discarded attempt are taken back out of
    ``record`` (a ``StepRecord``)."""

    def __init__(self, record=None):
        super().__init__()
        self.replicated: dict[str, int] = {}
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from torch.utils._pytree import tree_leaves, tree_map

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = str(func)
        ok_types = (Shard, Replicate, Partial)

        def usable(out):
            return all(all(type(p) in ok_types for p in o.placements)
                       and _consistent(o)
                       for o in tree_leaves(out) if isinstance(o, DTensor))

        snap = self.record.snapshot() if self.record is not None else None

        def discard():
            if snap is not None:
                self.record.restore(snap)

        err = None
        try:
            out = func(*args, **kwargs)
            if usable(out):
                return out
        except Exception as e:  # noqa: BLE001 — retried below, or raised
            err = e
        discard()
        # an in-place operation runs on copies; its target gets the result
        target = args[0] if func._schema.is_mutable else None
        if target is not None and not (
                isinstance(target, torch.Tensor)
                and func._schema.arguments[0].alias_info is not None
                and func._schema.arguments[0].alias_info.is_write):
            raise RuntimeError(f"DTensor cannot shard {func}") from err
        plain_target = target is not None and not isinstance(target, DTensor)
        if plain_target:
            target = None           # a replicated plain target: run below
        self.replicated[name] = self.replicated.get(name, 0) + 1
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                    if isinstance(a, DTensor))

        def write_back(new_target):
            if target is not None and new_target is not target:
                target.copy_(new_target.redistribute(mesh, target.placements))
            return target if target is not None else None

        for dims in (_replication_order(mesh)
                     if target is not None or not func._schema.is_mutable
                     else ()):
            def rep(a):
                if not isinstance(a, DTensor):
                    return a
                pl = list(a.placements)
                for j in dims:
                    pl[j] = Replicate()
                return a.redistribute(a.device_mesh, pl)
            rargs, rkwargs = tree_map(rep, args), tree_map(rep, kwargs)
            try:
                out = func(*rargs, **rkwargs)
            except Exception:  # noqa: BLE001 — replicate more dims
                discard()
                continue
            if usable(out):
                return write_back(rargs[0]) if target is not None else out
            discard()
        # no rule at all: each rank runs it on its full replica
        full = [Replicate()] * mesh.ndim

        def local(a):
            if isinstance(a, DTensor):
                return a.redistribute(a.device_mesh, full).to_local()
            return a

        largs = tree_map(local, args)
        out = func(*largs, **tree_map(local, kwargs))
        if plain_target:
            return args[0]
        if target is not None:
            return write_back(DTensor.from_local(largs[0], mesh, full,
                                                 run_check=False))
        return tree_map(lambda o: DTensor.from_local(
            o, mesh, full, run_check=False)
            if isinstance(o, torch.Tensor) else o, out)


def _consistent(t) -> bool:
    """Whether a DTensor's local shard has the shape its layout implies
    (``torch.chunk``'s split, mesh dim by mesh dim); a view that DTensor
    lays out wrongly gives one that has not."""
    from torch.distributed.tensor import Shard
    shape = list(t.shape)
    for j, p in enumerate(t.placements):
        if type(p) is Shard:
            n, c = t.device_mesh.size(j), t.device_mesh.get_local_rank(j)
            size = -(-shape[p.dim] // n)
            shape[p.dim] = max(0, min(size, shape[p.dim] - c * size))
    return tuple(t.to_local().shape) == tuple(shape)


def _replication_order(mesh) -> list:
    """The sets of mesh dims to replicate an operation over, cheapest
    first: by the product of their sizes (the factor by which each rank's
    share of the work grows), then fewer dims, then minor dims first. The
    set of every dim is left to the full-replica run."""
    n = mesh.ndim
    subsets = [c for k in range(1, n) for c in itertools.combinations(
        range(n), k)]
    return sorted(subsets, key=lambda c: (math.prod(mesh.size(j) for j in c),
                                          len(c), [-j for j in c]))


def _world(multi_pod: bool) -> int:
    if os.environ.get("DRYRUN_DEVICE_COUNT"):
        return int(os.environ["DRYRUN_DEVICE_COUNT"])
    return 512 if multi_pod else 256


def fake_world(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks (this process is rank
    0), replacing any earlier one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def trace_cell(cell, mesh):
    """(StepRecord, ops run replicated, argument bytes, output bytes) of one
    run of ``cell.fn`` on fake DTensors at the cell's placements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..train.optimizer import tree_map
    from .hlo_analysis import StepRecorder
    from .specs import is_tensor_spec

    def place(spec, placements):
        return distribute_tensor(torch.empty(spec.shape, dtype=spec.dtype),
                                 mesh, placements)

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tree_map(place, cell.args, cell.in_shardings,
                        is_leaf=is_tensor_spec)
        rec = StepRecorder(mesh)
        guard = ReplicateOnFailure(rec.record)
        with implicit_replication(), rec, guard:
            out = cell.fn(*args)
        return (rec.record, guard.replicated, _local_bytes(args),
                _local_bytes(out))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             mesh_override=None, perf_variant: str = "") -> dict:
    from .hlo_analysis import collective_bytes, collective_groups, hlo_cost
    from .mesh import make_production_mesh
    from .specs import build_cell

    t0 = time.time()
    if mesh_override is None:
        fake_world(_world(multi_pod))
    mesh = mesh_override if mesh_override is not None else \
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "x".join(str(s) for s in mesh.shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "multi_pod": multi_pod, "perf_variant": perf_variant}
    try:
        cell = build_cell(arch, shape_name, mesh)
        t_lower = time.time()
        if "layers" in cell.meta and not cell.meta["fwd_bwd"]:
            # identical layers: trace 1 and 2, add L - 1 differences
            L = cell.meta["layers"]
            r1, rep1, a1, o1 = trace_cell(
                build_cell(arch, shape_name, mesh, layers=1), mesh)
            r2, rep2, a2, o2 = trace_cell(
                build_cell(arch, shape_name, mesh, layers=2), mesh)
            layer = r2.scaled_sum(r1, -1)
            if layer.negative():
                raise RuntimeError("the second layer's record is smaller "
                                   "than the first's: layers differ")
            step = r1.scaled_sum(layer, L - 1)
            replicated = {k: rep1.get(k, 0) + (L - 1) * (v - rep1.get(k, 0))
                          for k, v in rep2.items()}
            arg_bytes = a1 + (L - 1) * (a2 - a1)
            out_bytes = o1 + (L - 1) * (o2 - o1)
        else:
            step, replicated, arg_bytes, out_bytes = trace_cell(cell, mesh)
        t_trace = time.time()
        coll = collective_bytes(step)
        cost = hlo_cost(step)
        rec.update({
            "ok": True,
            "kind": cell.kind,
            "meta": cell.meta,
            "lower_s": round(t_lower - t0, 2),
            "compile_s": None,
            "trace_s": round(t_trace - t_lower, 2),
            "flops_per_device": cost["flops"],
            "bytes_per_device": cost["bytes"],
            "dot_flops_per_device": cost["flops"],
            "hbm_bytes_per_device": cost["bytes"],
            "collectives": coll,
            "collective_groups": collective_groups(step),
            "replicated_ops": replicated,
            "top_ops": {"flops": step.top_ops("flops"),
                        "bytes": step.top_ops("bytes"),
                        "products": step.top_ops("flops", 100,
                                                 "by_product")},
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": None,
                "generated_code_bytes": None,
            },
            "n_devices": mesh.size(),
        })
        print(f"[dryrun] {arch}/{shape_name}/{mesh_name}"
              f"{'/' + perf_variant if perf_variant else ''}: OK "
              f"trace={rec['trace_s']}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e} "
              f"coll={coll['total_bytes']:.3e}B "
              f"replicated_ops={sum(replicated.values())}")
        print(f"  memory: args={arg_bytes / 1e9:.2f}GB "
              f"out={out_bytes / 1e9:.2f}GB")
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {arch}/{shape_name}/{mesh_name}: FAIL "
              f"{type(e).__name__}: {str(e)[:300]}")
        print("\n".join(ln for ln in rec["traceback"].splitlines()
                        if "repro_torch" in ln)[-2000:])

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{perf_variant}" if perf_variant else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        slim = {k: v for k, v in rec.items() if k != "traceback"}
        with open(path, "w") as f:
            json.dump(slim, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[],
                    help="arch/shape; repeat for several cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--perf-variant", default="",
                    help="tag an optimized variant (env flags set by caller)")
    args = ap.parse_args(argv)

    from .. import configs

    if args.all:
        cells = [(a, s) for a, s, _ in configs.all_cells()]
    elif args.cell:
        cells = [tuple(c.replace("-", "_").replace(".", "_").split("/"))
                 for c in args.cell]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all or --cell")
        cells = [(args.arch.replace("-", "_").replace(".", "_"), args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for mp in meshes:                  # one fake world per mesh
        for arch, shape in cells:
            rec = run_cell(arch, shape, mp, args.out,
                           perf_variant=args.perf_variant)
            failures += 0 if rec.get("ok") else 1
    print(f"[dryrun] done: {len(cells) * len(meshes) - failures} ok, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
