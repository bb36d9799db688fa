"""The check refuses what it must, at a size a test run holds (SF 1 on the
CPU): the control (the reference one step below what the configuration
states, in the program's place), and the run driven with the timed path
broken underneath, once per fault the cells can have."""
from __future__ import annotations

import pytest
import torch

from gredo_bench import harness
from gredo_bench.control import Control

SF1 = {"sf": 1}
CELLS = ["ecom_sf10.gcdi", "ecom_sf40.gcda"]


def run(cell, executor=None, seed=2**31 + 77):
    return harness.run(cell, seed, 0.3, False, device="cpu", scale=SF1,
                       executor=executor, quiet=True)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = run(cell, Control)
    assert not r["correct"]
    if cell.endswith("gcdi"):
        assert r["checks"]["G1.rows_mismatched"]["value"] > 0
    else:
        for number in ("A2.max_gap", "A1.rel_gap"):
            assert r["checks"][number]["value"] \
                > r["checks"][number]["limit"]


class AlteredAnswer(harness.Executor):
    """Every answer altered where it is produced: a relation loses its last
    row, a matrix gains 1e-3 in one entry."""

    def __init__(self, prog, data, cell):
        super().__init__(prog)

    def run(self, name, i):
        out = self.prog.run(name)
        if hasattr(out, "nrows"):
            return out.take(list(range(max(out.nrows - 1, 0))))
        out = out.clone()
        out.view(-1)[0] += 1e-3
        return out


def half_rows(monkeypatch):
    """The regression's gradient taken over half of the rows, its mean over
    the rest."""
    from repro_torch.core import analytics
    orig = analytics._logreg_op

    def half(x, y, w, **kw):
        n = x.shape[0] // 2
        return orig(x[:n], y[:n], w, **kw)
    monkeypatch.setattr(analytics, "_logreg_op", half)


@pytest.mark.parametrize("fault", ["altered_answer"])
def test_gcda_faults_are_refused(fault):
    ex = {"altered_answer": AlteredAnswer}
    r = run("ecom_sf40.gcda", ex[fault])
    assert not r["correct"], r["checks"]


def test_gcdi_altered_answer_is_refused():
    r = run("ecom_sf10.gcdi", AlteredAnswer)
    assert not r["correct"]
    assert all(v["value"] > 0 for k, v in r["checks"].items()
               if k.endswith("rows_mismatched"))


def test_half_of_the_rows_left_out_is_refused(monkeypatch):
    half_rows(monkeypatch)
    r = run("ecom_sf40.gcda")
    assert not r["correct"]
    assert r["checks"]["A1.rel_gap"]["value"] \
        > r["checks"]["A1.rel_gap"]["limit"]


def test_a_failed_task_is_refused():
    class Failing(harness.Executor):
        def __init__(self, prog, data, cell):
            super().__init__(prog)

        def run(self, name, i):
            if name == "G3" and i >= 6:        # past the warm-up pass
                raise RuntimeError("injected")
            return self.prog.run(name)
    r = run("ecom_sf10.gcdi", Failing)
    assert not r["correct"] and r["failed"] > 0


def test_no_cuda_state_is_touched_on_the_cpu():
    assert not torch.cuda.is_initialized()
