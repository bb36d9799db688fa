"""What a traced task's record carries for the readers: every kernel's
launches during the task, and a shortest-path task's shapes (its pairs and
the searched graph's vertices and edges, writes included); and the least
time of a search (``roofline.bfs_work``) with the reader that divides by
it (``readers.paths_roofline``)."""
from __future__ import annotations

import json

import pytest

from gredo_bench import datagen, harness, readers, reference, roofline
from gredo_bench import traffic as traffic_mod
from gredo_bench.tests.test_bench_kinds import (BENCH, FOLLOWS_WRITE, PAIRS,
                                                SEED, SF1, add_cell,
                                                paths_folder)

TRACED = ("engine.outside_ops_ms.gcdi",)


def traced_records(monkeypatch, root, bench, cell, executor=None,
                   seed=SEED):
    """The task records of one traced run at SF 1 on the CPU, as the
    readers get them, and the run's result."""
    seen = {}
    load = harness.load_reader

    def keeping(root_, metric):
        read = load(root_, metric)

        def kept(obs):
            seen["obs"] = obs
            return read(obs)
        return kept
    monkeypatch.setattr(harness, "load_reader", keeping)
    r = harness.run(cell, seed, 0.3, True, device="cpu", scale=SF1,
                    bench=bench, root=root, executor=executor, quiet=True)
    return seen["obs"]["tasks"], r


def sf1_data(root, seed=SEED):
    cfg = json.loads((root / "configs" / "m2bench_ecom_sf10.json")
                     .read_text())
    cfg["scale"].update(SF1)
    return datagen.generate(cfg, seed)


@pytest.mark.parametrize("write", [None, FOLLOWS_WRITE],
                         ids=["read_only", "writes"])
def test_path_records_carry_the_searched_graph(tmp_path, monkeypatch, write):
    """Each path task's ``pairs``, ``vertices`` and ``edges`` equal the
    task file's pairs and the reference's counts over the same data and
    the writes accepted up to that task."""
    root, _ = paths_folder(tmp_path, write)
    bench = add_cell(BENCH, "ecom_sf10.paths", "paths", metrics=TRACED)
    tasks, r = traced_records(monkeypatch, root, bench, "ecom_sf10.paths")
    assert r["correct"], r["checks"]
    data = sf1_data(root)
    mix = json.loads((root / "traffic" / "paths.json").read_text())
    traffic = traffic_mod.Traffic(mix, SEED, data)
    n_warm = len(traffic.block)
    vertices = reference.node_ids(data, "Follows")[None]
    base = len(data["graphs"]["Follows"]["edges"][1]["svid"])
    assert len(tasks) >= n_warm
    for j, t in enumerate(tasks):
        i = n_warm + j
        assert t["name"] == traffic.task(i)
        edges = len(reference.edges_after(data, "Follows",
                                          traffic.writes_upto(i))["svid"])
        assert (t["pairs"], t["vertices"], t["edges"]) == \
            (PAIRS[t["name"]], vertices, edges)
        if write:
            assert edges == base + (i + 1) * write["rows"]
        else:
            assert edges == base


def bumping(counts: dict):
    """An executor that launches nothing itself but raises the launch
    counters of some kernel modules by a count drawn from the task's
    index, and notes ``launch_counts()`` across each task into
    ``counts[i]``."""
    from repro_torch.kernels import launch_counts, wrapper_module

    class Bumping(harness.Executor):
        def __init__(self, prog, data, cell):
            super().__init__(prog)

        def run(self, name, i):
            before = launch_counts()
            for j, kernel in enumerate(("batched_hop", "matmul", "matgen")):
                wrapper_module(kernel).launches += (i + j) % 3
            out = self.prog.run(name)
            after = launch_counts()
            counts[i] = {k: after[k] - before[k] for k in after}
            return out
    return Bumping


@pytest.mark.parametrize("cell", ["ecom_sf10.gcdi", "ecom_sf40.gcda",
                                  "ecom_sf10.paths"])
def test_every_record_counts_every_kernel(tmp_path, monkeypatch, cell):
    """Every traced task's ``launches`` is the difference of
    ``launch_counts()`` across it, for every kernel package, in every kind
    of task; ``hops`` stays the traversal kernel's share of it."""
    from repro_torch.kernels import KERNELS, wrapper_module
    for kernel in KERNELS:          # restored after the test
        mod = wrapper_module(kernel)
        monkeypatch.setattr(mod, "launches", mod.launches)
    if cell == "ecom_sf10.paths":
        root, _ = paths_folder(tmp_path)
        bench = add_cell(BENCH, cell, "paths", metrics=TRACED)
    else:
        root, bench = harness.HERE, BENCH
    counts: dict = {}
    tasks, r = traced_records(monkeypatch, root, bench, cell,
                              executor=bumping(counts))
    assert r["correct"], r["checks"]
    n_warm = sum(harness.Cell(cell, bench, root).mix["tasks"].values())
    assert len(tasks) == len(counts) - n_warm
    for j, t in enumerate(tasks):
        want = counts[n_warm + j]
        assert set(t["launches"]) == set(KERNELS)
        assert t["launches"] == want
        assert t["hops"] == want["batched_hop"]
    assert any(t["launches"]["matmul"] for t in tasks)


@pytest.mark.parametrize("vertices,edges,pairs", [
    (2500, 12_567, 8),                 # SF 1's Follows, seed 2**31 + 4099
    (1_000_000, 5_002_437, 32),        # SF 400's Follows, G8
])
def test_bfs_least_time_reads_the_csr_once(vertices, edges, pairs):
    flops, nbytes = roofline.bfs_work(vertices, edges, pairs)
    assert flops == 0
    assert nbytes == 4 * (vertices + 1) + 4 * edges + 12 * pairs
    assert roofline.least_seconds(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)
    # not multiplied by the sources: more pairs add only their ids
    assert roofline.bfs_work(vertices, edges, 2 * pairs)[1] - nbytes == \
        12 * pairs


def path_task(ops, vertices=1_000_000, edges=5_000_000, pairs=8,
              task_kind="paths"):
    return {"name": "G6", "kind": "gcdi", "task_kind": task_kind,
            "wall_s": 0.1, "write_s": 0.0, "ops": list(ops), "hops": 0,
            "spans": [], "pairs": pairs, "vertices": vertices,
            "edges": edges}


def test_paths_roofline_reads_nothing_without_its_operator():
    host = {"tasks": [path_task([]), path_task([("EquiJoin", 0.01)])],
            "device": None}
    assert readers.paths_roofline(host, ("DeviceBFS",)) is None
    # the operator in a task of another kind is not a search's
    other = {"tasks": [path_task([("DeviceBFS", 0.01)], task_kind="gcdi")],
             "device": None}
    assert readers.paths_roofline(other, ("DeviceBFS",)) is None
    assert readers.paths_roofline({"tasks": [], "device": None},
                                  ("DeviceBFS",)) is None


def test_paths_roofline_on_known_records():
    """Two searches of the operator (one beside a host operator), one path
    task that ran none, and a GCDI task with the same operator name: the
    share is the two searches' least times over their fenced seconds."""
    tasks = [path_task([("DeviceBFS", 2e-3), ("Project", 5e-3)]),
             path_task([("DeviceBFS", 1e-3)], vertices=2500, edges=12_567,
                       pairs=32),
             path_task([]),
             path_task([("DeviceBFS", 9.0)], task_kind="gcdi")]
    obs = {"tasks": tasks, "device": None}
    b1 = 4 * 1_000_001 + 4 * 5_000_000 + 12 * 8
    b2 = 4 * 2501 + 4 * 12_567 + 12 * 32
    want = 100 * (b1 + b2) / 3.35e12 / 3e-3
    assert readers.paths_roofline(obs, ("DeviceBFS",)) == pytest.approx(want)
    assert readers.paths_roofline(obs, ("DeviceBFS", "Project")) == \
        pytest.approx(100 * (b1 + b2) / 3.35e12 / 8e-3)
