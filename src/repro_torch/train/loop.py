"""Trainer: an eager train step (+ optional microbatch gradient
accumulation), checkpoint/restart fault tolerance, straggler watchdog,
deterministic data replay. Single device, for any model exposing
(init_params, loss_fn); the parameters' device is the training device.

Gradients come from ``torch.autograd.grad`` over the parameter tensors
(the reference's ``jax.value_and_grad``); the optimizer step is
``adamw_update`` on the trees, as in the reference. Before it resumes,
``run`` waits for a checkpoint still being written in the background, so
a restart right after an asynchronous save finds that save.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import CheckpointManager
from ..distributed.fault import FailureInjector, StepWatchdog
from ..distributed.sharding import reduce_partial
from .optimizer import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                        tree_map)

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    microbatch: int = 1          # gradient-accumulation splits
    log_every: int = 10
    async_ckpt: bool = True


def value_and_grad(loss_fn: Callable, params: Tree, *args,
                   has_aux: bool = False):
    """``jax.value_and_grad(loss_fn, has_aux=has_aux)(params, *args)``:
    the loss (detached; with ``has_aux``, ``(loss, aux)`` from a
    ``loss_fn`` returning both) and the gradient tree of ``params``
    (``torch.autograd.grad``; a parameter the loss does not reach gets
    zeros, as in JAX). A DTensor parameter's gradient comes back in the
    parameter's layout, as JAX gives it: its partial sums (over the data
    axes, say) reduced in one all-reduce over those mesh dims joined
    (``sharding.reduce_partial``)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(tracked)
    out = loss_fn(tracked, *args)
    loss = out[0] if has_aux else out
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else
               reduce_partial(g, getattr(p, "placements", None))
               for p, g in zip(leaves, grads)])
    grads = tree_map(lambda _: next(it), tracked)
    if has_aux:
        return (loss.detach(), out[1]), grads
    return loss.detach(), grads


class Trainer:
    def __init__(self, loss_fn: Callable, params: Tree,
                 data_at: Callable[[int], dict], tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 failure_injector: Optional[FailureInjector] = None):
        self.loss_fn = loss_fn
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.data_at = data_at
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.watchdog = StepWatchdog()
        self.injector = failure_injector or FailureInjector()
        self.params = params
        self.opt_state = adamw_init(params)
        self.metrics: list[dict] = []

    def _value_and_grad(self, params: Tree, batch: dict):
        """((loss, aux), grads) of ``loss_fn`` at ``params``."""
        (loss, aux), grads = value_and_grad(self.loss_fn, params, batch,
                                            has_aux=True)
        return (loss, aux.detach()), grads

    def _step(self, params: Tree, opt_state: Tree, batch: dict):
        """One optimizer step: (params, opt_state, loss, aux)."""
        mb = self.tcfg.microbatch
        if mb <= 1:
            (loss, aux), grads = self._value_and_grad(params, batch)
        else:
            def split(x, i):
                return x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
            grads, loss, aux = None, 0.0, 0.0
            for i in range(mb):
                (l, a), g = self._value_and_grad(
                    params, {k: split(v, i) for k, v in batch.items()})
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss, aux = loss + l, aux + a
            grads = tree_map(lambda g: g / mb, grads)
            loss, aux = loss / mb, aux / mb
        params, opt_state = adamw_update(grads, opt_state, params,
                                         self.opt_cfg)
        return params, opt_state, loss, aux

    # ------------------------------------------------------------------ run
    def run(self, resume: bool = True) -> dict:
        start = 0
        self.ckpt.wait()
        if resume and self.ckpt.latest_step() is not None:
            state = {"params": self.params, "opt": self.opt_state}
            restored, meta = self.ckpt.restore(state)
            self.params = restored["params"]
            self.opt_state = restored["opt"]
            start = meta["step"] + 1

        for step in range(start, self.tcfg.total_steps):
            t0 = time.perf_counter()
            self.injector.maybe_fail(step)
            batch = self.data_at(step)
            self.params, self.opt_state, loss, aux = self._step(
                self.params, self.opt_state, batch)
            dt = time.perf_counter() - t0
            straggler = self.watchdog.observe(step, dt)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps - 1:
                self.metrics.append({"step": step, "loss": float(loss),
                                     "aux": float(aux), "seconds": dt,
                                     "straggler": straggler})
            if self.tcfg.ckpt_every and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, {"params": self.params,
                                      "opt": self.opt_state},
                               blocking=not self.tcfg.async_ckpt)
        self.ckpt.wait()
        return {"final_step": self.tcfg.total_steps - 1,
                "metrics": self.metrics,
                "stragglers": self.watchdog.straggler_steps}

    def run_with_restarts(self, max_restarts: int = 3) -> dict:
        """Supervised run: injected/real failures trigger restore-and-replay
        from the latest checkpoint (deterministic data makes replay exact)."""
        restarts = 0
        while True:
            try:
                return self.run(resume=True)
            except RuntimeError:
                restarts += 1
                if restarts > max_restarts:
                    raise
