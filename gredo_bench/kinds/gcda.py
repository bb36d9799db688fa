"""GCDA: an analytical operator over a GCDI's relation
(``queries/<task>.json`` with ``integration``, ``op``, ``inputs``, and
``iters``, ``lr``, ``l2`` for a regression), run through the program's
``GredoEngine.analyze``. Its answer is checked against the reference in
float64 by the number its ``check`` names: ``entries_mismatched`` (summed
over the kept answers), ``max_gap`` or ``rel_gap`` (the largest). The
control computes in TF32."""
from gredo_bench import reference

FAMILY = "gcda"


def load(body: dict, find) -> dict:
    integ = find(body["integration"])
    return {**body, "text": integ["text"], "spec": integ["spec"]}


def bind(api, task):
    eng, parse, schema = api.engine, api.parse, api.schema
    text, op, iters = task["text"], task["op"], task.get("iters", 100)
    inputs = [tuple(x) for x in task["inputs"]]
    return lambda: eng.analyze(
        schema.GCDIATask(parse(text), schema.AnalyticsTask(op, inputs)),
        iters=iters)


def check(task: dict, kept: list, run) -> tuple:
    number = task["check"]["number"]
    prec = reference.Precision(False, run.device)
    inputs: dict = {}      # one integration per count of writes
    worst = 0.0
    for i, got in kept:
        done = run.writes_upto(i)
        if len(done) not in inputs:
            inputs[len(done)] = reference.gcda_inputs(task, task["spec"],
                                                      run.data, done)
        v = reference.compare_gcda(task, got, inputs[len(done)], prec)
        worst = v + worst if number == "entries_mismatched" \
            else max(worst, v)
    return number, worst, task["check"]["limit"]


def control(task: dict, data: dict, writes: list, args, device):
    mats = reference.gcda_inputs(task, task["spec"], data, writes)
    return reference.control_output(task, mats, device)


def record(task: dict, prog) -> dict:
    """The shapes the roofline readers need: N, d and the iterations."""
    return {"n": prog.rows_of("RandomAccessMatrix"), "d": task["inputs"][0][3],
            "iters": task.get("iters", 1)}
