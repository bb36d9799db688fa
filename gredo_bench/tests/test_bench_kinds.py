"""Kinds of task are files of the harness (``kinds/<kind>.py``), found by
name: a new kind is added by files alone, a cell of two families is
refused, and the shortest-path kind (M2Bench G6-G8) is checked against its
plain breadth-first search at SF 1 on the CPU, with and without writes."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from gredo_bench import datagen, harness, reference
from gredo_bench.control import Control

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
SF1 = {"sf": 1}
SEED = 2**31 + 4099
PAIRS = {"G6": 8, "G7": 16, "G8": 32}
FOLLOWS_WRITE = {"graph": "Follows", "rows": 64,
                 "columns": {"since": ["uniform", 2000, 2026]}}


def bench_folder(tmp_path):
    """A copy of the benchmark's folder (tests left out)."""
    root = tmp_path / "gredo_bench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def add_cell(bench, cell, mix, metrics=()):
    """``bench`` with cell ``cell`` of ``mix`` at SF 10's configuration,
    reporting the GCDI end-to-end metrics and the per-layer ``metrics``."""
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": cell, "config": "m2bench_ecom_sf10",
                               "traffic": mix, "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("gcdi_tasks_per_s", "gcdi_p95_ms") + tuple(metrics):
            m["workloads"].append(cell)
    return bench


def paths_folder(tmp_path, write=None, tasks=PAIRS):
    """A copy with G6-G8 as shortest-path tasks over Follows and a mix of
    them, ``paths``, each once a block, two answers of each checked."""
    root = bench_folder(tmp_path)
    for name, k in PAIRS.items():
        (root / "queries" / f"{name}.json").write_text(json.dumps(
            {"kind": "paths", "graph": "Follows", "src_label": "Persons",
             "dst_label": "Persons", "pairs": k,
             "check": {"number": "pairs_mismatched", "limit": 0}}))
    mix = {"name": "paths", "clients": 1, "tasks": {t: 1 for t in tasks},
           "check": {"per_task": 2}}
    if write:
        mix["write"] = write
    (root / "traffic" / "paths.json").write_text(json.dumps(mix))
    return root, add_cell(BENCH, "ecom_sf10.paths", "paths")


def run(root, bench, executor=None, trace=False, cell="ecom_sf10.paths",
        seed=SEED):
    return harness.run(cell, seed, 0.3, trace, device="cpu", scale=SF1,
                       bench=bench, root=root, executor=executor, quiet=True)


def test_a_kind_is_added_by_files_alone(tmp_path):
    """A kind, a task of it, a mix and a cell, all new: the harness finds
    them by name, runs them through the program and checks them."""
    root = bench_folder(tmp_path)
    (root / "kinds" / "rowcount.py").write_text(
        '"""A GCDI query whose answer is checked by its row count."""\n'
        "from gredo_bench import reference\n\n"
        'FAMILY = "gcdi"\n\n\n'
        "def load(body, find):\n"
        '    q = find(body["query"])\n'
        '    return {**body, "text": q["text"], "spec": q["spec"]}\n\n\n'
        "def bind(api, task):\n"
        '    return lambda: api.engine.query(api.parse(task["text"]))\n\n\n'
        "def check(task, kept, run):\n"
        "    off = sum(abs(got.nrows - len(reference.evaluate(\n"
        '        task["spec"], run.data, run.writes_upto(i))[0]))\n'
        "        for i, got in kept)\n"
        '    return "rows_counted_off", off, 0\n')
    (root / "queries" / "P1.json").write_text(json.dumps(
        {"kind": "rowcount", "query": "G3"}))
    (root / "traffic" / "probe.json").write_text(json.dumps(
        {"name": "probe", "clients": 1, "tasks": {"P1": 2, "G5": 1},
         "check": {"per_task": 1}}))
    bench = add_cell(BENCH, "ecom_sf10.probe", "probe")
    r = run(root, bench, cell="ecom_sf10.probe")
    assert r["correct"], r["checks"]
    assert set(r["checks"]) >= {"P1.rows_counted_off", "G5.rows_mismatched"}
    assert set(r["metrics"]) == {"gcdi_tasks_per_s", "gcdi_p95_ms",
                                 "setup_s"}


def test_a_cell_of_two_families_is_refused(tmp_path):
    root = bench_folder(tmp_path)
    (root / "traffic" / "mixed.json").write_text(json.dumps(
        {"name": "mixed", "clients": 1, "tasks": {"G1": 1, "A1": 1},
         "check": {"per_task": 1}}))
    bench = add_cell(BENCH, "ecom_sf10.mixed", "mixed")
    with pytest.raises(ValueError, match="families"):
        harness.Cell("ecom_sf10.mixed", bench, root)


def test_task_files_name_their_kind():
    assert harness.load_task(harness.HERE, "G1")["kind"] == "gcdi"
    assert harness.load_task(harness.HERE, "A1")["kind"] == "gcda"
    cells = [harness.Cell(w["name"], BENCH) for w in BENCH["workloads"]]
    assert sorted(c.family for c in cells) == ["gcda", "gcdi"]


@pytest.mark.parametrize("write", [None, FOLLOWS_WRITE],
                         ids=["read_only", "writes"])
def test_paths_cell_is_correct(tmp_path, write):
    """G6-G8 (8, 16 and 32 pairs) through the port's
    ``GredoEngine.shortest_path``, every kept answer held pair for pair
    against the reference's search."""
    root, bench = paths_folder(tmp_path, write)
    r = run(root, bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert {f"{t}.pairs_mismatched" for t in PAIRS} <= set(r["checks"])


def test_the_paths_control_is_not_correct(tmp_path):
    root, bench = paths_folder(tmp_path)
    r = run(root, bench, Control)
    assert not r["correct"]
    assert all(r["checks"][f"{t}.pairs_mismatched"]["value"] > 0
               for t in PAIRS)


def raise_one(d):
    d[0] += 1
    return d


def unreach_one(d):
    d[np.nonzero(d >= 0)[0][0]] = -1
    return d


def drop_one(d):
    return np.delete(d, len(d) // 2)


@pytest.mark.parametrize("alter", [raise_one, unreach_one, drop_one],
                         ids=lambda f: f.__name__)
def test_altered_paths_answers_are_refused(tmp_path, alter):
    class Altered(harness.Executor):
        def __init__(self, prog, data, cell):
            super().__init__(prog)

        def run(self, name, i):
            return alter(np.array(self.prog.run(name)))
    root, bench = paths_folder(tmp_path)
    r = run(root, bench, Altered)
    assert not r["correct"]
    assert all(r["checks"][f"{t}.pairs_mismatched"]["value"] > 0
               for t in PAIRS)


def test_paths_pairs_are_drawn_per_task_from_the_seed(tmp_path):
    root, _ = paths_folder(tmp_path)
    kind = harness.load_kind(root, "paths")
    task = harness.load_task(root, "G7")
    cfg = json.loads((harness.HERE / "configs" / "m2bench_ecom_sf10.json")
                     .read_text())
    cfg["scale"].update(SF1)
    data = datagen.generate(cfg, SEED)
    n = reference.node_ids(data, "Follows")[None]
    src, dst = kind.args(task, data, SEED, 5)
    assert len(src) == len(dst) == 16
    assert 0 <= min(src.min(), dst.min()) and max(src.max(), dst.max()) < n
    again = kind.args(task, data, SEED, 5)
    assert all(np.array_equal(a, b) for a, b in zip((src, dst), again))
    assert not np.array_equal(src, kind.args(task, data, SEED, 6)[0])
    assert not np.array_equal(src, kind.args(task, data, SEED + 1, 5)[0])


def test_reference_bfs_on_a_small_graph():
    """A cycle 0 -> 1 -> 2 -> 0, an exit 2 -> 3 with no way back, 4 with no
    edges, 5 -> 3 reachable from nothing."""
    heads = np.array([0, 1, 2, 2, 5])
    tails = np.array([1, 2, 0, 3, 3])
    pairs = [(0, 0, 0), (0, 1, 1), (0, 2, 2), (0, 3, 3), (1, 0, 2),
             (2, 1, 2), (3, 0, -1), (3, 2, -1), (0, 4, -1), (4, 4, 0),
             (0, 5, -1), (5, 3, 1), (5, 0, -1)]
    src, dst, want = (np.array(c) for c in zip(*pairs))
    got = reference.hop_distances(6, heads, tails, src, dst)
    assert got.tolist() == want.tolist()


def test_reference_paths_number_each_label_apart():
    """Over a graph of two labels (Persons -> Tags), a person reaches a tag
    it is interested in in one hop and no tag reaches anything."""
    cfg = json.loads((harness.HERE / "configs" / "m2bench_ecom_sf10.json")
                     .read_text())
    cfg["scale"].update(SF1)
    data = datagen.generate(cfg, SEED)
    e = data["graphs"]["Interested_in"]["edges"][1]
    src, dst = e["svid"][:5], e["tvid"][:5]
    assert reference.shortest_paths(data, "Interested_in", [], "Persons",
                                    src, "Tags", dst).tolist() == [1] * 5
    assert reference.shortest_paths(data, "Interested_in", [], "Tags",
                                    dst, "Tags", dst).tolist() == [0] * 5
    assert reference.shortest_paths(data, "Interested_in", [], "Tags",
                                    dst, "Persons", src).tolist() == [-1] * 5


def test_follows_writes_change_the_distances():
    """A write that the reference replays moves some distance, so a write
    the program dropped could not pass unseen."""
    from gredo_bench import traffic
    cfg = json.loads((harness.HERE / "configs" / "m2bench_ecom_sf10.json")
                     .read_text())
    cfg["scale"].update(SF1)
    data = datagen.generate(cfg, SEED)
    mix = {"tasks": {"G8": 1}, "write": FOLLOWS_WRITE}
    writes = traffic.Traffic(mix, SEED, data).writes_upto(9)
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 2500, 64), rng.integers(0, 2500, 64)
    before = reference.shortest_paths(data, "Follows", [], "Persons", src,
                                      "Persons", dst)
    after = reference.shortest_paths(data, "Follows", writes, "Persons", src,
                                     "Persons", dst)
    assert (before != after).any()
    assert (after <= np.where(before < 0, np.inf, before)).all()


def test_a_path_task_leaves_no_stale_trace_records(tmp_path, monkeypatch):
    """A traced run of G3 with a path task between: the path task begins no
    trace of the engine's, so its record holds no operators and no spans,
    not G3's."""
    root, bench = paths_folder(tmp_path, tasks=["G6"])
    mix = json.loads((root / "traffic" / "paths.json").read_text())
    mix["tasks"] = {"G3": 1, "G6": 1}
    (root / "traffic" / "paths.json").write_text(json.dumps(mix))
    bench = add_cell(BENCH, "ecom_sf10.paths", "paths",
                     metrics=("engine.outside_ops_ms.gcdi",))
    seen = {}
    load = harness.load_reader

    def keeping(root_, metric):
        read = load(root_, metric)

        def kept(obs):
            seen["obs"] = obs
            return read(obs)
        return kept
    monkeypatch.setattr(harness, "load_reader", keeping)
    r = run(root, bench, trace=True)
    assert r["correct"], r["checks"]
    tasks = seen["obs"]["tasks"]
    paths = [t for t in tasks if t["task_kind"] == "paths"]
    g3 = [t for t in tasks if t["name"] == "G3"]
    assert paths and g3
    assert all(t["kind"] == "gcdi" for t in tasks)
    assert all(t["ops"] == [] and t["spans"] == [] for t in paths)
    assert all(t["ops"] and t["spans"] for t in g3)
