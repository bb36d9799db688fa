"""Synthetic LM data pipeline: a deterministic, seekable token stream.

Deterministic addressing (stream[step, row] is a pure function of the seed)
makes the pipeline *restart-transparent*: after a failure the Trainer
resumes at step N and the pipeline regenerates exactly the batches it would
have produced — no data-loader state in the checkpoint. Sharded hosts each
draw their own row range (host_id striding)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def batch_at(self, step: int) -> dict:
        """Markov-chain-ish synthetic tokens: structured enough that a real
        LM loss decreases, deterministic per (seed, step, row)."""
        rows = self.batch // self.n_hosts
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_id)
        base = rng.integers(0, self.vocab, (rows, 1))
        drift = rng.integers(-8, 9, (rows, self.seq)).cumsum(axis=1)
        toks = (base + np.abs(drift)) % self.vocab
        toks = toks.astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1  # no target for the last position
        return {"tokens": toks, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
