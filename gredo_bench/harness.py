"""One run of one benchmark cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), the
tasks the mix names (``queries/<task>.sql`` for a GCDI query in SQL/PGQ,
``queries/<task>.json`` for a GCDIA over one of them) and its per-layer
metrics (``metrics/<metric>.py``). This module is the only one of the
benchmark that touches the program (``repro_torch``), and only in
:class:`Program`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import datagen, reference, stats, trace as trace_mod
from . import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# The cell, from BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------


def load_task(root: Path, name: str) -> dict:
    sql = root / "queries" / f"{name}.sql"
    if sql.exists():
        text = " ".join(sql.read_text().split())
        return {"name": name, "kind": "gcdi", "text": text,
                "spec": reference.parse(text)}
    task = json.loads((root / "queries" / f"{name}.json").read_text())
    integ = load_task(root, task["integration"])
    return {**task, "name": name, "kind": "gcda", "text": integ["text"],
            "spec": integ["spec"]}


def load_reader(root: Path, metric: str):
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"gredo_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: Path = HERE):
        if bench is None:
            bench = json.loads((REPO / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((root.parent / cfg["file"]).read_text())
        self.mix = traffic_mod.load(root, self.entry["traffic"])
        self.tasks = {t: load_task(root, t) for t in self.mix["tasks"]}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in moved]
        self.readers = {m["name"]: load_reader(root, m["name"])
                        for m in self.per_layer}
        self.kinds = {t["kind"] for t in self.tasks.values()}


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


class Program:
    """The port's engine over the generated data, driven through its public
    entry points: ``sqlpgq.parse`` and ``GredoEngine.query`` for GCDI,
    ``GredoEngine.analyze`` for a GCDIA, ``Graph.insert_edges`` for writes."""

    def __init__(self, cell: Cell, data: dict, device, telemetry: bool):
        from repro_torch.core import storage
        from repro_torch.core.deltastore import DeltaConfig
        from repro_torch.core.engine import GredoEngine
        from repro_torch.core.schema import AnalyticsTask, GCDIATask
        from repro_torch.core.sqlpgq import parse
        from repro_torch.kernels import launch_counts
        eng_cfg = cell.config["engine"]
        self.db = storage.database_from_arrays(data)
        for g in self.db.graphs.values():
            g.delta_config = DeltaConfig(
                max_segments=eng_cfg["delta_max_segments"])
        self.eng = GredoEngine(self.db,
                               interbuffer_bytes=eng_cfg["interbuffer_bytes"],
                               telemetry=telemetry, device=device)
        self._launches = launch_counts
        self._calls = {}
        for name, t in cell.tasks.items():
            if t["kind"] == "gcdi":
                self._calls[name] = (lambda text=t["text"]:
                                     self.eng.query(parse(text)))
            else:
                inputs = [tuple(x) for x in t["inputs"]]
                self._calls[name] = (
                    lambda text=t["text"], op=t["op"], inputs=inputs,
                    iters=t.get("iters", 100): self.eng.analyze(
                        GCDIATask(parse(text), AnalyticsTask(op, inputs)),
                        iters=iters))

    def write(self, graph: str, rows: dict) -> None:
        self.db.graphs[graph].insert_edges(rows)

    def run(self, name: str):
        return self._calls[name]()

    def hops(self) -> int:
        return self._launches()["batched_hop"]

    def executed_ops(self) -> list:
        return [(o["op"], o["seconds"]) for o in self.eng.last_stats.operators
                if o["executed"]]

    def rows_of(self, kind: str):
        for o in self.eng.last_stats.operators:
            if o["op"] == kind:
                return o["rows"]
        return None

    def spans(self) -> list:
        """(start, end, operator kind) of the last task's operator spans on
        the harness's clock."""
        tr = self.eng.telemetry.collector.last()
        return [(tr.t0 + s.ts, tr.t0 + s.ts + s.dur, s.name)
                for s in tr.spans if s.cat in ("gcdi", "gcda")]


def table_rows(out, select: list) -> list:
    """The program's result relation as plain columns, in SELECT order (an
    answer already in that form passes as it is)."""
    if isinstance(out, list):
        return out
    cols = []
    for ref in select:
        c = out.col(ref)
        cols.append(c.decode(c.codes) if hasattr(c, "codes")
                    else np.asarray(c))
    return cols


# ---------------------------------------------------------------------------
# The answers kept for the check
# ---------------------------------------------------------------------------


class Sample:
    """A reservoir, per task, of the window's answers: ``per_task`` of each
    (a count, or a count by task), drawn from the seed among all of that
    task's answers. A kept answer that lives on a card is copied to the
    host, so the card holds only what the program holds; an answer that
    replaces another is copied into the other's buffer."""

    def __init__(self, per_task, seed: int):
        self.per_task = per_task
        self.rng = traffic_mod.rng(seed, 3)
        self.kept: dict = {}
        self.seen: dict = {}

    def offer(self, name: str, i: int, out) -> None:
        k = (self.per_task if isinstance(self.per_task, int)
             else self.per_task.get(name, 0))
        n = self.seen[name] = self.seen.get(name, 0) + 1
        slot = self.kept.setdefault(name, [])
        if len(slot) < k:
            slot.append((i, to_host(out)))
        elif k:
            j = int(self.rng.integers(0, n))
            if j < k:
                slot[j] = (i, to_host(out, into=slot[j][1]))


def to_host(out, into=None):
    """``out`` with a tensor on a card copied to the host: into ``into``
    where that is a host buffer of its shape, else into a new page-locked
    one (a pageable copy where the host refuses to lock the pages)."""
    import torch
    if not isinstance(out, torch.Tensor) or out.device.type == "cpu":
        return out
    if (isinstance(into, torch.Tensor) and into.device.type == "cpu"
            and into.shape == out.shape and into.dtype == out.dtype):
        return into.copy_(out)
    try:
        buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    except RuntimeError:
        return out.cpu()
    return buf.copy_(out)


def check(cell: Cell, data: dict, traffic, sample: Sample, failed: int,
          device) -> dict:
    """Every number compared, ``{name: (value, limit)}``: the failed tasks,
    and per task of the mix the number its file names (relations: rows
    mismatched, exact) over the sampled answers, worked out again by the
    reference from the data and the writes up to each answer."""
    out = {"tasks_failed": (failed, 0)}
    prec = reference.Precision(False, device)
    inputs: dict = {}      # one integration per task and count of writes
    for name in cell.mix["tasks"]:
        t = cell.tasks[name]
        kept = sample.kept.get(name, [])
        if t["kind"] == "gcdi":
            worst = 0
            for i, got in kept:
                want = reference.evaluate(t["spec"], data,
                                          traffic.writes_upto(i))
                worst += reference.rows_mismatched(
                    table_rows(got, t["spec"]["select"]), want)
            out[f"{name}.rows_mismatched"] = (worst, 0)
            continue
        number = t["check"]["number"]
        worst = 0.0
        for i, got in kept:
            done = traffic.writes_upto(i)
            key = (name, len(done))
            if key not in inputs:
                inputs[key] = reference.gcda_inputs(t, t["spec"], data, done)
            v = reference.compare_gcda(t, got, inputs[key], prec)
            worst = v + worst if number == "entries_mismatched" \
                else max(worst, v)
        out[f"{name}.{number}"] = (worst, t["check"]["limit"])
    # a task of the mix with no answer in the sample would pass unchecked
    out["tasks_unchecked"] = (sum(not sample.kept.get(n)
                                  for n in cell.mix["tasks"]), 0)
    return out


def verdict(numbers: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in numbers.values())


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Executor:
    """Runs task ``name`` (after its write) and returns its answer; the
    program by default. The control and the fault tests put another in
    its place."""

    def __init__(self, prog: Program):
        self.prog = prog

    def write(self, graph, rows):
        self.prog.write(graph, rows)

    def run(self, name: str, i: int):
        return self.prog.run(name)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float | None = None, bench: dict | None = None,
        scale: dict | None = None, executor=None, quiet: bool = False) -> dict:
    """One run; returns the result line's object. ``scale`` overrides keys
    of the configuration's scale (tests only); ``executor`` wraps the
    program (the control and the fault tests)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, bench)
    if scale:
        cell.config["scale"].update(scale)
    data = datagen.generate(cell.config, seed)
    prog = Program(cell, data, device, telemetry=trace)
    ex = executor(prog, data, cell) if executor else Executor(prog)
    traffic = traffic_mod.Traffic(cell.mix, seed, data)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    def one(i: int):
        name = traffic.task(i)
        w = traffic.write(i)
        t0 = time.perf_counter()
        if w:
            ex.write(*w)
        t1 = time.perf_counter()
        out = ex.run(name, i)
        sync(device)
        return name, out, t0, t1, time.perf_counter()

    # warm-up: one pass of the cell's own tasks, counted as set-up; what
    # set-up leaves is kept out of the window's garbage collections
    n_warm = len(traffic.block)
    for i in range(n_warm):
        one(i)
    sync(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    sample = Sample(cell.mix["check"]["per_task"], seed)
    lat, recs = [], []
    failed = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if is_cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    i = n_warm
    paused = 0.0          # the check's copies, kept out of the window
    w0 = time.perf_counter()
    while True:
        mark = (record_function(f"gredo_bench.task:{len(recs)}") if trace
                else None)
        if mark:
            mark.__enter__()
        hops0 = prog.hops() if trace else 0
        try:
            name, out, t0, t1, t2 = one(i)
            ok = True
        except Exception as e:               # a task that fails is counted
            name, out, ok = traffic.task(i), None, False
            t0 = t1 = t2 = time.perf_counter()
            failed += 1
            print(f"task {i} ({name}) failed: {e!r}", file=sys.stderr)
        if mark:
            mark.__exit__(None, None, None)
        lat.append(t2 - t0 if ok else math.inf)
        if ok:
            p0 = time.perf_counter()
            pause = record_function(trace_mod.PAUSE_MARK) if trace else None
            if pause:
                pause.__enter__()
            sample.offer(name, i, out)
            if pause:
                pause.__exit__(None, None, None)
            paused += time.perf_counter() - p0
        if trace:
            rec = {"name": name, "kind": cell.tasks[name]["kind"],
                   "t0": t0, "wall_s": t2 - t0, "write_s": t1 - t0,
                   "ops": prog.executed_ops() if ok else [],
                   "hops": prog.hops() - hops0,
                   "spans": prog.spans() if ok else []}
            t = cell.tasks[name]
            if t["kind"] == "gcda":
                rec.update(n=prog.rows_of("RandomAccessMatrix"),
                           d=t["inputs"][0][3], iters=t.get("iters", 1))
            recs.append(rec)
        del out
        i += 1
        # the window ends past ``seconds``, and never before one whole block
        # of the mix ran in it, so every task is sampled for the check
        if time.perf_counter() - w0 - paused >= seconds and i >= 2 * n_warm:
            break
    window_s = time.perf_counter() - w0 - paused
    gc.unfreeze()
    device_obs = None
    if prof is not None:
        prof.__exit__(None, None, None)
        if is_cuda:
            device_obs = trace_mod.summarise(trace_mod.raw_events(prof), recs)
        del prof
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    del prog, ex
    if is_cuda:
        torch.cuda.empty_cache()

    numbers = check(cell, data, traffic, sample, failed, device)
    correct = verdict(numbers)
    attempted = len(lat)
    completed = attempted - failed
    metrics = {}
    if not trace:
        kind = "gcdi" if "gcdi" in cell.kinds else "gcda"
        values = {f"{kind}_tasks_per_s": stats.rate(completed, window_s),
                  f"{kind}_p95_ms": stats.percentile(lat, 95) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            v = values[m["name"]]
            metrics[m["name"]] = {"value": v if math.isfinite(v) else None,
                                  "unit": m["unit"]}
    else:
        obs = {"tasks": recs, "device": device_obs}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if is_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if device_obs is not None:
        dev["busy_s"] = device_obs["busy_s"]
        dev["window_s"] = device_obs["window_s"]
        result["breakdown"] = device_obs["breakdown"]
    # strict JSON has no infinity: a number that could not be read is null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, (v, lim) in numbers.items()}
    if not quiet:
        for k, (v, lim) in numbers.items():
            print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    return result
