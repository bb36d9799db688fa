"""Fault-tolerant checkpointing.

* Atomic: writes to ``step_N.tmp.npz`` then ``os.replace`` -> a crash
  mid-save never corrupts the latest checkpoint.
* Async: ``save(..., blocking=False)`` copies the tensors to the host at
  once, then writes on a background thread, overlapping I/O with the next
  training steps.
* Rotating: keeps the newest ``keep`` checkpoints.
* Portable: one ``.npz`` per step, each leaf under its ``/``-joined tree
  path (dict keys, list indices) beside a JSON ``__meta__`` — the
  reference's layout, so a checkpoint written by either package restores
  in the other. bf16 leaves are written as fp32 (numpy has no bf16) and
  cast back by ``restore``, which casts every leaf to its target's dtype.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

Tree = Any


def _paths(tree: Tree, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later writes to it do not reach."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else None
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _rebuild(tree: Tree, leaves: dict, prefix: tuple = ()) -> Tree:
    """``tree``'s structure with the leaf at each path from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Tree, blocking: bool = True,
             metadata: Optional[dict] = None) -> None:
        # snapshot to host *now* (a device-to-host copy for card tensors)
        flat = _flatten(state)
        meta = dict(metadata or {})
        meta["step"] = int(step)

        def write():
            tmp = os.path.join(self.directory, f"step_{step:010d}.tmp.npz")
            final = os.path.join(self.directory, f"step_{step:010d}.npz")
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=json.dumps(meta), **flat)
            os.replace(tmp, final)  # atomic publish
            self._rotate()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self) -> None:
        ckpts = self.checkpoints()
        for step, path in ckpts[:-self.keep]:
            try:
                os.remove(path)
            except OSError:
                pass

    # --------------------------------------------------------------- restore
    def checkpoints(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.npz", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ckpts = self.checkpoints()
        return ckpts[-1][0] if ckpts else None

    def restore(self, target: Tree, step: Optional[int] = None
                ) -> tuple[Tree, dict]:
        """Restore into the structure of ``target`` (a tree of tensors):
        each leaf gets its target's shape (else ``ValueError``), dtype and
        device."""
        ckpts = dict((s, p) for s, p in self.checkpoints())
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        step = step if step is not None else max(ckpts)
        with np.load(ckpts[step], allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            flat = {k: z[k] for k in z.files if k != "__meta__"}

        leaves = {}
        for key, leaf in _paths(target):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves[key] = torch.from_numpy(arr).to(leaf.device, leaf.dtype)
        return _rebuild(target, leaves), meta
