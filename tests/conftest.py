"""Test-session configuration.

Registers the ``slow`` mark and installs a minimal fallback implementation
of the ``hypothesis`` API when the real package is unavailable (the tier-1
environment ships without it). The fallback draws a fixed number of
pseudo-random examples per test from a deterministic seed — no shrinking,
no database — which is enough for the property tests in this repo (they
only use ``given``/``settings`` and the ``integers``/``booleans``/
``sampled_from``/``composite`` strategies).
"""
from __future__ import annotations

import functools
import inspect
import random
import sys
import types


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers",
        "fast: quick core-engine tier (storage/planner/physical/optimizer/"
        "cardinality) — run with `make test-fast` / `pytest -m fast`")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `pytest -m gpu tests/test_torch_gpu.py`)")


def _install_hypothesis_stub():
    class _Strategy:
        def __init__(self, draw_fn):
            self._draw = draw_fn

        def example(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

    def composite(fn):
        def build(*args, **kwargs):
            def draw_fn(rng):
                def draw(strategy):
                    return strategy.example(rng)
                return fn(draw, *args, **kwargs)
            return _Strategy(draw_fn)
        return build

    def settings(max_examples=100, deadline=None, **_ignored):
        def deco(fn):
            fn._stub_settings = {"max_examples": max_examples}
            return fn
        return deco

    def given(*strategies, **kw_strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper():
                conf = getattr(wrapper, "_stub_settings", None) or getattr(
                    fn, "_stub_settings", {})
                n = conf.get("max_examples", 20)
                rng = random.Random(0xC0FFEE)
                for _ in range(n):
                    args = [s.example(rng) for s in strategies]
                    kwargs = {k: s.example(rng) for k, s in kw_strategies.items()}
                    fn(*args, **kwargs)
            # hide the original signature so pytest does not mistake drawn
            # parameters for fixtures
            wrapper.__signature__ = inspect.Signature()
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            return wrapper
        return deco

    strategies_mod = types.ModuleType("hypothesis.strategies")
    strategies_mod.integers = integers
    strategies_mod.booleans = booleans
    strategies_mod.sampled_from = sampled_from
    strategies_mod.composite = composite

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.strategies = strategies_mod
    hyp.__stub__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = strategies_mod


try:  # pragma: no cover - trivial import probe
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()
