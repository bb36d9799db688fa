"""Fault tolerance + straggler mitigation.

A training step either completes or fails; the fault model is therefore:
  * node/process failure  -> restart from CheckpointManager.latest (the
    Trainer's run loop catches failures, restores, and replays — the data
    pipeline is deterministic-by-step so replay is exact);
  * stragglers            -> detected by the StepWatchdog (EWMA of step
    times + threshold factor); mitigation = flag the step, optionally skip
    non-critical work (checkpoint/eval) on slow steps, and surface the
    event to the orchestration layer.
Failure *injection* (tests, chaos drills) is explicit via FailureInjector.
Pure Python: the port's own copy of the reference's module.
"""
from __future__ import annotations

from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 alpha: float = 0.1):
        self.factor = factor
        self.warmup = warmup
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.count = 0
        self.straggler_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_straggler = (self.count > self.warmup
                        and seconds > self.factor * self.ewma)
        if is_straggler:
            self.straggler_steps.append(step)
        else:  # don't let stragglers poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_straggler


class FailureInjector:
    """Deterministic chaos: raises at the configured steps (once each)."""

    def __init__(self, fail_at: tuple = (), exc=RuntimeError):
        self.fail_at = set(fail_at)
        self.exc = exc

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise self.exc(f"injected failure at step {step}")


def run_with_restarts(run: Callable[[Optional[int]], int],
                      max_restarts: int = 3) -> int:
    """Supervisor loop: ``run(resume_step)`` trains until done or raises.
    On failure, restart from the latest checkpoint (run re-reads it)."""
    restarts = 0
    while True:
        try:
            return run(None)
        except Exception:  # noqa: BLE001 — any worker failure
            restarts += 1
            if restarts > max_restarts:
                raise
