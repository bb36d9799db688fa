"""Arithmetic shared by the per-layer metric readers under ``metrics/``.

A reader gets the observation of one traced window: ``tasks`` (one record
per task: ``name``, ``kind`` the family of the cell's end-to-end metrics,
"gcdi" or "gcda", ``task_kind`` the task's own kind (``kinds/<kind>.py``),
``wall_s``, ``write_s``, ``ops`` as (operator kind, seconds) of every
operator the engine executed, ``hops`` (traversal-kernel launches),
``launches`` (``{kernel: launches during the task}`` for every kernel
package of the program), and what the kind's ``record`` adds: for GCDA the
shapes ``n``, ``d``, ``iters``; for a shortest-path task ``pairs`` and the
searched graph's ``vertices`` and ``edges``), and ``device`` (``busy_s``,
``window_s`` from the profiler).
A task that began no trace of the engine's (a shortest-path search) has no
``ops`` and no ``spans``.
Operator seconds are the engine's own (``ExecStats.operators``), fenced on
the device by its telemetry in a traced run. A reader that finds nothing to
read returns None.
"""
from __future__ import annotations

from . import roofline

DEVICE_GCDI = ("DeviceMatchPattern",)
MATGEN = ("RandomAccessMatrix", "Rel2Matrix")
PRODUCTS = ("MatMul", "Similarity")
REGRESSION = ("Regression",)
NOT_HOST = DEVICE_GCDI + MATGEN + PRODUCTS + REGRESSION


def tasks_of(obs: dict, kind: str) -> list:
    return [t for t in obs["tasks"] if t["kind"] == kind]


def op_seconds(task: dict, kinds=None, exclude=()) -> float:
    return sum(s for k, s in task["ops"]
               if (kinds is None or k in kinds) and k not in exclude)


def mean_ms(values: list):
    return sum(values) / len(values) * 1e3 if values else None


def outside_ops_ms(obs: dict, kind: str):
    """Task wall less every executed operator's seconds, less the write."""
    return mean_ms([t["wall_s"] - op_seconds(t) - t["write_s"]
                    for t in tasks_of(obs, kind)])


def host_ops_ms(obs: dict, kind: str):
    return mean_ms([op_seconds(t, exclude=NOT_HOST)
                    for t in tasks_of(obs, kind)])


def ops_ms(obs: dict, kind: str, kinds: tuple):
    tasks = tasks_of(obs, kind)
    if not any(k in kinds for t in tasks for k, _ in t["ops"]):
        return None
    return mean_ms([op_seconds(t, kinds) for t in tasks])


def least_over_spent(tasks: list, kinds: tuple, work):
    """Sum of ``work(task)``'s least times over the sum of the fenced
    seconds of the operators of ``kinds``, in percent, over the tasks that
    ran one; None where none did."""
    least = spent = 0.0
    for t in tasks:
        secs = op_seconds(t, kinds)
        if not secs:
            continue
        least += roofline.least_seconds(*work(t))
        spent += secs
    return 100.0 * least / spent if spent else None


def roofline_share(obs: dict, kinds: tuple):
    """The GCDA operators of ``kinds``: their least times over their fenced
    seconds, in percent."""
    if kinds == REGRESSION:
        def work(t):
            return roofline.regression_work(t["n"], t["d"], t["iters"])
    else:
        def work(t):
            return roofline.product_work(t["n"], t["d"])
    return least_over_spent(tasks_of(obs, "gcda"), kinds, work)


def paths_roofline(obs: dict, kinds: tuple):
    """The shortest-path tasks' searches (``roofline.bfs_work``: the CSR
    read once per task, however many sources share it) over the fenced
    seconds of the operators of ``kinds``, in percent; None where no such
    operator ran. The operator's name is the program's to choose, so the
    metric's reader file gives it."""
    return least_over_spent(
        [t for t in obs["tasks"] if t["task_kind"] == "paths"], kinds,
        lambda t: roofline.bfs_work(t["vertices"], t["edges"], t["pairs"]))


def idle_share(obs: dict, kind: str):
    dev = obs.get("device")
    if not dev or not tasks_of(obs, kind):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def hop_launches(obs: dict):
    tasks = tasks_of(obs, "gcdi")
    return sum(t["hops"] for t in tasks) / len(tasks) if tasks else None
