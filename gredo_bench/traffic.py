"""The one traffic generator: reads a mix file under ``traffic/`` and draws,
from the seed, the order of the tasks and the rows of every write.

A mix is a closed loop of ``clients`` (one) sessions. ``tasks`` gives each
task's share as a whole count per block: every consecutive block holds each
task that many times, in an order drawn from the seed, so every seed sends
the same mix in another order. ``write``, when present, precedes every task
with one batch of ``rows`` new edges of ``graph``: sources and targets
uniform over the graph's two vertex labels, the other columns drawn as
``columns`` says (``["uniform", lo, hi]``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def rng(seed: int, stream: int, *index: int) -> np.random.Generator:
    """An independent generator per purpose (and per ``index``, where a
    draw belongs to one task); any whole seed, negative or past 64 bits
    included."""
    return np.random.default_rng([seed & (2**64 - 1), stream, *index])


def load(root: Path, name: str) -> dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if mix.get("clients", 1) != 1:
        raise ValueError(f"{name}: the harness drives one closed-loop client")
    return mix


class Traffic:
    """The task and write stream of one run. ``task(i)`` and ``write(i)``
    are pure functions of (mix, seed, data, i); ``writes_upto(i)`` is every
    batch accepted before task i's analytics ran, for the reference."""

    def __init__(self, mix: dict, seed: int, data: dict):
        self.mix = mix
        self.seed = seed
        self.block = [t for t, k in mix["tasks"].items() for _ in range(k)]
        self._order = rng(seed, 1)
        self._rows = rng(seed, 2)
        self._tasks: list[str] = []
        self._writes: list = []
        w = mix.get("write")
        if w:
            g = data["graphs"][w["graph"]]
            n_of = {lbl: len(next(iter(cols.values())))
                    for lbl, (_, cols) in g["vertex_tables"].items()}
            self._n_src = n_of[g["src_label"]]
            self._n_dst = n_of[g["dst_label"]]

    def task(self, i: int) -> str:
        while len(self._tasks) <= i:
            self._tasks += [self.block[j] for j in
                            self._order.permutation(len(self.block))]
        return self._tasks[i]

    def write(self, i: int):
        """``(graph, rows)`` written before task ``i``, or None."""
        w = self.mix.get("write")
        if not w:
            return None
        while len(self._writes) <= i:
            n = int(w["rows"])
            rows = {"svid": self._rows.integers(0, self._n_src, n
                                                ).astype(np.int64),
                    "tvid": self._rows.integers(0, self._n_dst, n
                                                ).astype(np.int64)}
            for col, (law, lo, hi) in w.get("columns", {}).items():
                if law != "uniform":
                    raise ValueError(f"unknown law {law}")
                rows[col] = self._rows.uniform(lo, hi, n)
            self._writes.append((w["graph"], rows))
        return self._writes[i]

    def writes_upto(self, i: int) -> list:
        """Every batch written up to and including task ``i``'s."""
        if not self.mix.get("write"):
            return []
        self.write(i)
        return self._writes[:i + 1]
