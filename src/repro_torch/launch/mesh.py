"""Mesh construction. Functions, not module constants: importing this
module creates no process group and touches no device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
package's axis names. It spans the current process group, which the caller
creates: NCCL on the cards, gloo on CPU ranks, the ``fake`` backend in the
dry-run (:mod:`repro_torch.launch.dryrun`)."""
from __future__ import annotations


def _mesh(device: str, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = 1
    for s in shape:
        world *= s
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of {world} "
                           f"ranks; the current world is {have}")
    mesh = init_device_mesh(device, shape, mesh_dim_names=names)
    if "pod" in names:
        # the data axes flattened into a dim of their own, made here on
        # every rank: a reduction over ('pod', 'data') is one collective
        # (``sharding.joined_group``), and DTensor's own redistributions
        # merge into it. Only this dim: DTensor's merges into a flattened
        # dim with 'model' in it gave wrong values (torch 2.13, gloo)
        mesh["pod", "data"]._flatten("pod_data")
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the 'pod' axis composes with 'data' for
    hierarchical gradient reduction. Needs a world of 256 or 512, which in
    practice is the dry-run's fake backend."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                    device: str = "cuda"):
    """Small mesh over the current world (data * model [* pod] ranks), on
    the cards unless ``device="cpu"`` is asked for."""
    if pod:
        return _mesh(device, (pod, data, model), ("pod", "data", "model"))
    return _mesh(device, (data, model), ("data", "model"))
