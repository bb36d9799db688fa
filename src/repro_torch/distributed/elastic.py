"""Elastic scaling: move live training state to other devices.

Checkpoints are host-complete (CheckpointManager), so growing/shrinking the
cluster is: drain -> checkpoint -> rebuild -> restore onto the new devices.
``reshard_state`` does the same transformation for a live tree (host-gather
then a copy to each leaf's new device), used when the resize happens
without going through disk. Mirrors ``repro.distributed.elastic``; a
sharding is a ``torch.device`` (or its name), or a mesh placement: a
``(DeviceMesh, placements)`` pair (placements as
``distributed.sharding.placements`` gives them), which places the leaf as
a DTensor with ``distribute_tensor``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..train.optimizer import tree_map

Tree = Any


def host_gather(state: Tree) -> Tree:
    """Every leaf as a host numpy copy (a DTensor's full value)."""
    from torch.distributed.tensor import DTensor

    def one(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.detach().cpu().numpy().copy()
    return tree_map(one, state)


def _place(a, s):
    if isinstance(s, (torch.device, str)):
        return torch.from_numpy(a).to(torch.device(s))
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = s
    return distribute_tensor(
        torch.from_numpy(a).to(mesh.device_type), mesh, placements)


def _is_sharding(s) -> bool:
    return (isinstance(s, tuple) and len(s) == 2
            and hasattr(s[0], "mesh_dim_names"))


def reshard_state(state: Tree, new_shardings: Tree) -> Tree:
    """``state`` with each leaf copied from the host onto the sharding at
    the same place in ``new_shardings``: a device, or a (mesh, placements)
    pair, which makes the leaf a DTensor (a DTensor leaf of ``state`` is
    gathered whole first)."""
    host = host_gather(state)
    return tree_map(_place, host, new_shardings, is_leaf=_is_sharding)


def rebalanced_batch_size(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Keep the global batch divisible by the new DP degree (round down to
    the nearest multiple; the Trainer rescales LR accordingly)."""
    per = max(global_batch // new_dp, 1)
    return per * new_dp
