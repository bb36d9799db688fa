"""Arithmetic shared by the per-layer metric readers under ``metrics/``.

A reader gets the observation of one traced window: ``tasks`` (one record
per task: ``name``, ``kind`` the family of the cell's end-to-end metrics,
"gcdi" or "gcda", ``task_kind`` the task's own kind (``kinds/<kind>.py``),
``wall_s``, ``write_s``, ``ops`` as (operator kind, seconds) of every
operator the engine executed, ``hops`` (traversal-kernel launches), and
what the kind's ``record`` adds: for GCDA the shapes ``n``, ``d``,
``iters``), and ``device`` (``busy_s``, ``window_s`` from the profiler).
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


def roofline_share(obs: dict, kinds: tuple):
    """Sum of the least times of the operators of ``kinds`` over the sum of
    their fenced seconds, in percent."""
    least = spent = 0.0
    for t in tasks_of(obs, "gcda"):
        secs = op_seconds(t, kinds)
        if not secs:
            continue
        if kinds == REGRESSION:
            work = roofline.regression_work(t["n"], t["d"], t["iters"])
        else:
            work = roofline.product_work(t["n"], t["d"])
        least += roofline.least_seconds(*work)
        spent += secs
    return 100.0 * least / spent if spent else None


def idle_share(obs: dict, kind: str):
    dev = obs.get("device")
    if not dev or not tasks_of(obs, kind):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def hop_launches(obs: dict):
    tasks = tasks_of(obs, "gcdi")
    return sum(t["hops"] for t in tasks) / len(tasks) if tasks else None
