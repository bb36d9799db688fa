"""One run of one benchmark cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), the
tasks the mix names (``queries/<task>.sql`` or ``queries/<task>.json``),
the kind of each task (``kinds/<kind>.py``) and its per-layer metrics
(``metrics/<metric>.py``). A kind says how a task is loaded, called, drawn
and checked (see ``kinds/gcdi.py``). This module is the only one of the
benchmark that touches the program (``repro_torch``), and only in
:class:`Program`.
"""
from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import datagen, reference, stats, trace as trace_mod
from . import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the kind of a task whose file names none, by the file's suffix
KIND_OF_SUFFIX = {".sql": "gcdi", ".json": "gcda"}
table_rows = reference.table_rows      # the name the tests know it by


# ---------------------------------------------------------------------------
# The cell, from BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------


def load_module(root: Path, folder: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"gredo_bench.{folder}.{name}", root / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(root: Path, kind: str):
    """The module ``kinds/<kind>.py``. It gives ``FAMILY``, the prefix of
    its tasks' end-to-end metrics; ``load(body, find)``, the task from its
    file (``find(name)`` loads another task); ``bind(api, task)``, the call
    through the program's public entry points (``api.engine``,
    ``api.parse``, ``api.schema``), which takes the drawn arguments;
    ``check(task, kept, run)``, ``(number, value, limit)`` over the kept
    ``(index, answer)`` pairs, where ``run`` holds ``data``,
    ``writes_upto``, ``seed`` and ``device``; and ``control(task, data,
    writes, args, device)``, the control's answer. Where it needs them:
    ``args(task, data, seed, i)``, task ``i``'s arguments, drawn before its
    clock starts; ``record(task, prog)``, fields of a traced task's
    record."""
    return load_module(root, "kinds", kind)


def load_task(root: Path, name: str) -> dict:
    """Task ``name`` as its kind loads it, with its ``name`` and ``kind``.
    A ``.sql`` file holds the text alone; a ``.json`` file may name its
    kind under ``"kind"``."""
    sql = root / "queries" / f"{name}.sql"
    path = sql if sql.exists() else root / "queries" / f"{name}.json"
    body = ({"text": path.read_text()} if path.suffix == ".sql"
            else json.loads(path.read_text()))
    kind = body.get("kind", KIND_OF_SUFFIX[path.suffix])
    task = load_kind(root, kind).load(body,
                                      functools.partial(load_task, root))
    return {**task, "name": name, "kind": kind}


def load_reader(root: Path, metric: str):
    return load_module(root, "metrics", metric).read


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
        self.kinds = {k: load_kind(root, k)
                      for k in {t["kind"] for t in self.tasks.values()}}
        families = {k.FAMILY for k in self.kinds.values()}
        if len(families) != 1:
            # the end-to-end metrics are named by the family: a cell of two
            # would report one family's and drop the other's
            raise ValueError(f"{name}: tasks of families {sorted(families)}"
                             "; a cell holds one")
        self.family = families.pop()

    def kind(self, task: str):
        return self.kinds[self.tasks[task]["kind"]]


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


class Program:
    """The port's engine over the generated data, driven through its public
    entry points: each task through the call its kind binds (given the
    engine, ``sqlpgq.parse`` and ``core.schema``), ``Graph.insert_edges``
    for writes."""

    def __init__(self, cell: Cell, data: dict, device, telemetry: bool):
        from repro_torch.core import schema, storage
        from repro_torch.core.deltastore import DeltaConfig
        from repro_torch.core.engine import GredoEngine
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
        api = SimpleNamespace(engine=self.eng, parse=parse, schema=schema)
        self._bound = {name: cell.kind(name).bind(api, t)
                       for name, t in cell.tasks.items()}
        self._calls = dict(self._bound)

    def write(self, graph: str, rows: dict) -> None:
        self.db.graphs[graph].insert_edges(rows)

    def stage(self, name: str, args: tuple) -> None:
        """Hand task ``name``'s next call its drawn arguments."""
        self._calls[name] = functools.partial(self._bound[name], *args)

    def run(self, name: str):
        return self._calls[name]()

    def launches(self) -> dict:
        """Launches of every kernel package of the program so far, by
        kernel (``repro_torch.kernels.launch_counts``)."""
        return self._launches()

    def graph_size(self, graph: str) -> tuple[int, int]:
        """(vertices, live edges) of ``graph`` as the program holds it now,
        accepted writes included."""
        g = self.db.graphs[graph]
        return g.n_vertices, g.n_live_edges

    def last_trace(self):
        """The engine's newest trace: compared before and after a task, it
        tells whether the task began one."""
        return self.eng.telemetry.collector.last()

    def executed_ops(self, before=None) -> list:
        """(operator kind, seconds) of the last task's executed operators;
        none where the task began no trace after ``before``."""
        if self.last_trace() is before:
            return []
        return [(o["op"], o["seconds"]) for o in self.eng.last_stats.operators
                if o["executed"]]

    def rows_of(self, kind: str):
        for o in self.eng.last_stats.operators:
            if o["op"] == kind:
                return o["rows"]
        return None

    def spans(self, before=None) -> list:
        """(start, end, operator kind) of the last task's operator spans on
        the harness's clock; none where the task began no trace after
        ``before``."""
        tr = self.last_trace()
        if tr is before:
            return []
        return [(tr.t0 + s.ts, tr.t0 + s.ts + s.dur, s.name)
                for s in tr.spans if s.cat in ("gcdi", "gcda")]


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
    and per task of the mix the number its kind compares over the sampled
    answers, worked out again by the reference from the data, the writes
    up to each answer and the arguments drawn for it."""
    out = {"tasks_failed": (failed, 0)}
    run = SimpleNamespace(data=data, writes_upto=traffic.writes_upto,
                          seed=traffic.seed, device=device)
    for name in cell.mix["tasks"]:
        number, value, limit = cell.kind(name).check(
            cell.tasks[name], sample.kept.get(name, []), run)
        out[f"{name}.{number}"] = (value, limit)
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

    def stage(self, name: str, args: tuple):
        self.prog.stage(name, args)

    def run(self, name: str, i: int):
        return self.prog.run(name)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float | None = None, bench: dict | None = None,
        scale: dict | None = None, executor=None, quiet: bool = False,
        root: Path = HERE) -> dict:
    """One run; returns the result line's object. ``scale`` overrides keys
    of the configuration's scale and ``root`` is a copy of this folder
    (tests only); ``executor`` wraps the program (the control and the fault
    tests)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, bench, root)
    if scale:
        cell.config["scale"].update(scale)
    data = datagen.generate(cell.config, seed)
    prog = Program(cell, data, device, telemetry=trace)
    ex = executor(prog, data, cell) if executor else Executor(prog)
    traffic = traffic_mod.Traffic(cell.mix, seed, data)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    # the kinds that draw arguments per task draw them off the task's clock
    draws = {name: cell.kind(name).args for name in cell.tasks
             if hasattr(cell.kind(name), "args")}

    def one(i: int):
        name = traffic.task(i)
        w = traffic.write(i)
        if name in draws:
            ex.stage(name, draws[name](cell.tasks[name], data, seed, i))
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
        launches0 = prog.launches() if trace else None
        trace0 = prog.last_trace() if trace else None
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
            t = cell.tasks[name]
            launches = {k: n - launches0[k]
                        for k, n in prog.launches().items()}
            rec = {"name": name, "kind": cell.family, "task_kind": t["kind"],
                   "t0": t0, "wall_s": t2 - t0, "write_s": t1 - t0,
                   "ops": prog.executed_ops(trace0) if ok else [],
                   "hops": launches["batched_hop"], "launches": launches,
                   "spans": prog.spans(trace0) if ok else []}
            if hasattr(cell.kind(name), "record"):
                rec.update(cell.kind(name).record(t, prog))
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
        values = {f"{cell.family}_tasks_per_s":
                  stats.rate(completed, window_s),
                  f"{cell.family}_p95_ms": stats.percentile(lat, 95) * 1e3,
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
