"""The control: the plain reference put in the program's place, one step
below what the configuration states, which the check must refuse.

Each task's kind (``kinds/<kind>.py``) gives its control's answer:

* GCDIA outputs: float32 with TF32 off is stated, so the control computes
  them with every product input rounded to TF32 (float32 sums).
* GCDI relations state no precision but bag semantics, so the control
  answers with duplicate rows collapsed (set semantics).
* Shortest paths follow the edges in their direction, so the control reads
  every edge both ways.

    python3 gredo_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--program 1]

prints, per seed, the numbers compared for the control (and with
``--program 1`` for the program too, in the same process) as JSON lines.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


class Control:
    """An executor (see ``harness.Executor``) that answers from the
    reference in the control's precision and semantics."""

    def __init__(self, prog, data: dict, cell):
        self.data = data
        self.cell = cell
        self.device = prog.eng.device
        self.writes: list = []
        self.args: dict = {}

    def write(self, graph, rows):
        self.writes.append((graph, rows))

    def stage(self, name: str, args: tuple):
        self.args[name] = args

    def run(self, name: str, i: int):
        return self.cell.kind(name).control(
            self.cell.tasks[name], self.data, self.writes,
            self.args.get(name), self.device)


def main(argv=None) -> int:
    repo = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(repo), str(repo / "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", type=int, default=0)
    args = ap.parse_args(argv)
    from gredo_bench import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = [("control", Control)]
        if args.program:
            sides.insert(0, ("program", None))
        for side, ex in sides:
            r = harness.run(args.workload, seed, args.seconds, False,
                            executor=ex, quiet=True)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
