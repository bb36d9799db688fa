"""Elastic scaling: move live training state to other devices.

Checkpoints are host-complete (CheckpointManager), so growing/shrinking the
cluster is: drain -> checkpoint -> rebuild -> restore onto the new devices.
``reshard_state`` does the same transformation for a live tree (host-gather
then a copy to each leaf's new device), used when the resize happens
without going through disk. Mirrors ``repro.distributed.elastic``; a
sharding is a ``torch.device`` (or its name) here. The mesh form (a
sharded placement over a process group) waits for ROADMAP queue 1, item 11.
"""
from __future__ import annotations

from typing import Any

import torch

from ..train.optimizer import tree_map

Tree = Any


def host_gather(state: Tree) -> Tree:
    """Every leaf as a host numpy copy."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), state)


def _device(s) -> torch.device:
    if isinstance(s, (torch.device, str)):
        return torch.device(s)
    raise NotImplementedError(
        f"resharding onto {type(s).__name__} (a mesh placement) is not "
        "ported yet (ROADMAP queue 1, item 11)")


def reshard_state(state: Tree, new_shardings: Tree) -> Tree:
    """``state`` with each leaf copied from the host onto the device at the
    same place in ``new_shardings`` (a tree of ``torch.device``s)."""
    host = host_gather(state)
    return tree_map(lambda a, s: torch.from_numpy(a).to(_device(s)),
                    host, new_shardings)


def rebalanced_batch_size(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Keep the global batch divisible by the new DP degree (round down to
    the nearest multiple; the Trainer rescales LR accordingly)."""
    per = max(global_batch // new_dp, 1)
    return per * new_dp
