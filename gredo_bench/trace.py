"""Reading ``torch.profiler``'s trace of a window in process: device-busy
time, the device operations that took most time, and the idle gaps named
by what the host was doing. Reads the profiler's raw events (no trace file
is written) and the engine's own operator spans."""
from __future__ import annotations

import bisect
from collections import defaultdict

TASK_MARK = "gredo_bench.task:"
PAUSE_MARK = "gredo_bench.check_copy"
NAME_CHARS = 120


def raw_events(prof) -> list:
    return prof.profiler.kineto_results.events()


def device_intervals(events) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of every operation that ran on a card (the
    harness's own annotations, mirrored on the device's timeline, are
    not operations)."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == DeviceType.CUDA
            and e.duration_ns() > 0 and not e.is_user_annotation()
            and not e.name().startswith((TASK_MARK, PAUSE_MARK))]


def task_marks(events) -> list[tuple[int, int, int]]:
    """(start ns, end ns, task index) of the harness's per-task ranges."""
    from torch.autograd import DeviceType
    out = []
    for e in events:
        name = e.name()
        if name.startswith(TASK_MARK) and e.device_type() == DeviceType.CPU:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        int(name[len(TASK_MARK):])))
    return sorted(out)


def pauses(events) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of the harness's copies for the check, which
    the window leaves out."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.name() == PAUSE_MARK
            and e.device_type() == DeviceType.CPU]


def merge(intervals) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def clip(merged, lo: int, hi: int) -> list[list[int]]:
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def intersect(a, b) -> list[list[int]]:
    """The overlap of two sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            out.append([max(s, b[k][0]), min(e, b[k][1])])
            k += 1
    return out


def window_segments(lo: int, hi: int, paused) -> list[list[int]]:
    """[lo, hi] less the paused intervals."""
    out, at = [], lo
    for s, e in clip(merge(paused), lo, hi):
        if s > at:
            out.append([at, s])
        at = max(at, e)
    if hi > at:
        out.append([at, hi])
    return out


def host_activity(t_ns: int, marks: list, tasks: list) -> str:
    """What the host was doing at profiler time ``t_ns``: the task, and the
    innermost operator span of the engine covering that moment, else the
    write or the engine's own work around the operators."""
    k = bisect.bisect_right(marks, (t_ns, float("inf"), 0)) - 1
    if k < 0 or t_ns > marks[k][1]:
        return "between tasks"
    start_ns, _, i = marks[k]
    rec = tasks[i]
    at = rec["t0"] + (t_ns - start_ns) / 1e9      # the harness's clock
    if at < rec["t0"] + rec["write_s"]:
        return f"{rec['name']}/write"
    best = None
    for s0, s1, name in rec.get("spans", ()):
        if s0 <= at <= s1 and (best is None or s0 >= best[0]):
            best = (s0, s1, name)
    return f"{rec['name']}/{best[2] if best else 'engine'}"


def summarise(events, tasks: list, top: int = 10) -> dict:
    """``busy_s``, ``window_s`` and the breakdown of one traced window, from
    the first task's start to the last one's end, less the check's copies."""
    marks = task_marks(events)
    if not marks:
        raise RuntimeError("the trace holds no task range")
    lo, hi = marks[0][0], marks[-1][1]
    window = window_segments(lo, hi, pauses(events))
    dev = [iv for iv in device_intervals(events) if iv[1] > lo and iv[0] < hi]
    busy = intersect(merge(dev), window)
    by_op: dict = defaultdict(int)
    for s, e, name in dev:
        by_op[name[:NAME_CHARS]] += sum(
            b - a for a, b in intersect([[s, e]], window))
    idle: dict = defaultdict(int)
    for w0, w1 in window:
        inside = clip(busy, w0, w1)
        edges = [w0] + [x for s, e in inside for x in (s, e)] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                idle[host_activity((g0 + g1) // 2, marks, tasks)] += g1 - g0
    busy_ns = sum(e - s for s, e in busy)
    window_ns = sum(e - s for s, e in window)

    def ranked(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy_ns / 1e9, "window_s": window_ns / 1e9,
            "breakdown": {"device_ops": ranked(by_op),
                          "idle_gaps": ranked(idle)}}
