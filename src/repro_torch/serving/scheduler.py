"""Continuous-batching serving scheduler over the LM decode path.

Fixed-slot design, as in the reference:
  * B cache slots, each (L, Hk, M, dh); a slot holds one in-flight request;
  * new requests prefill on a batch=1 cache then scatter into their slot —
    active decodes are never recomputed;
  * one decode step advances ALL active slots (per-slot lengths drive the
    attention masks);
  * finished requests (EOS or max_new) free their slot immediately, so the
    batch refills mid-flight (continuous batching).
Greedy decoding is deterministic: the scheduler's outputs equal serving
each request alone. The scheduler runs on the device of the parameters it
is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.transformer import (TransformerConfig, forward, init_cache,
                                  serve_step)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int = 32
    eos_id: int = -1            # -1 = never


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    prefill_len: int
    steps: int


class ContinuousBatcher:
    def __init__(self, params, cfg: TransformerConfig, n_slots: int = 4,
                 max_len: int = 512):
        self.params = params
        self.cfg = cfg
        self.B = n_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.cache = init_cache(cfg, n_slots, max_len, self.device)
        self.lengths = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.active: list[Optional[dict]] = [None] * n_slots
        self.stats = {"prefills": 0, "decode_steps": 0, "slot_occupancy": []}

        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._prefill = lambda p, c, t: forward(p, t, cfg, cache=c,
                                                cache_lengths=zero)
        self._decode = lambda p, c, t, l: serve_step(p, c, t, l, cfg)

    # ------------------------------------------------------------------
    def _admit(self, req: Request, slot: int):
        P = len(req.prompt)
        small = init_cache(self.cfg, 1, self.max_len, self.device)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None]
        logits, small = self._prefill(self.params, small, tokens)
        first = int(torch.argmax(logits[0, P - 1]))
        # scatter the prefill cache into the slot
        for name in ("k", "v"):
            self.cache[name][:, slot] = small[name][:, 0]
        self.lengths[slot] = P
        self.active[slot] = {"req": req, "out": [first], "steps": 0}
        self.stats["prefills"] += 1

    def _finished(self, state: dict) -> bool:
        req = state["req"]
        return (len(state["out"]) >= req.max_new
                or (req.eos_id >= 0 and state["out"][-1] == req.eos_id))

    # ------------------------------------------------------------------
    def serve(self, requests: list[Request]) -> list[Completion]:
        queue = list(requests)
        done: list[Completion] = []
        next_tok = np.zeros((self.B, 1), np.int32)

        while queue or any(s is not None for s in self.active):
            # admit into free slots
            for b in range(self.B):
                if self.active[b] is None and queue:
                    req = queue.pop(0)
                    self._admit(req, b)
                    next_tok[b, 0] = self.active[b]["out"][-1]
            self.stats["slot_occupancy"].append(
                sum(s is not None for s in self.active))

            # one decode step for all active slots
            active_mask = [s is not None for s in self.active]
            if not any(active_mask):
                continue
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.as_tensor(next_tok, device=self.device), self.lengths)
            self.stats["decode_steps"] += 1
            self.lengths = self.lengths + torch.as_tensor(
                active_mask, dtype=torch.int32, device=self.device)
            nxt = torch.argmax(logits, -1).cpu().numpy()

            for b in range(self.B):
                st = self.active[b]
                if st is None:
                    continue
                st["out"].append(int(nxt[b]))
                st["steps"] += 1
                next_tok[b, 0] = int(nxt[b])
                if self._finished(st):
                    done.append(Completion(
                        rid=st["req"].rid, tokens=st["out"][:st["req"].max_new],
                        prefill_len=len(st["req"].prompt), steps=st["steps"]))
                    self.active[b] = None
                    self.lengths[b] = 0
        return sorted(done, key=lambda c: c.rid)
