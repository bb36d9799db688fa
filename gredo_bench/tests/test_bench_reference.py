"""The plain reference against the port's CPU engine at SF 1: every query
and every GCDIA task of the benchmark's mixes, before and after writes."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gredo_bench import datagen, harness, reference, traffic

SF1 = {"sf": 1}
QUERIES = ["G1", "G2", "G3", "G4", "G5"]
GCDA = ["A1", "A2", "A3"]
# no cell writes today; a mix that does names its batches so, and the
# reference replays them
WRITES = {"name": "writes", "clients": 1, "tasks": {"A1": 1},
          "write": {"graph": "Interested_in", "rows": 64,
                    "columns": {"weight": ["uniform", 0.0, 1.0]}},
          "check": {"per_task": 1}}


@pytest.fixture(scope="module")
def world():
    cfg = json.loads((harness.HERE / "configs" / "m2bench_ecom_sf10.json")
                     .read_text())
    cfg["scale"].update(SF1)
    data = datagen.generate(cfg, 2**31 + 11)
    return cfg, data, traffic.Traffic(WRITES, 2**31 + 11, data)


def engine(data):
    from repro_torch.core import storage
    from repro_torch.core.engine import GredoEngine
    db = storage.database_from_arrays(data)
    return db, GredoEngine(db, device="cpu")


@pytest.mark.parametrize("writes", [0, 3])
@pytest.mark.parametrize("name", QUERIES)
def test_gcdi_matches_reference(world, name, writes):
    from repro_torch.core.sqlpgq import parse
    _, data, tr = world
    task = harness.load_task(harness.HERE, name)
    db, eng = engine(data)
    done = tr.writes_upto(writes - 1) if writes else []
    for g, rows in done:
        db.graphs[g].insert_edges(rows)
    got = harness.table_rows(eng.query(parse(task["text"])),
                             task["spec"]["select"])
    want = reference.evaluate(task["spec"], data, done)
    assert len(want[0]) > 0
    assert reference.rows_mismatched(got, want) == 0


@pytest.mark.parametrize("writes", [1, 4])
@pytest.mark.parametrize("name", GCDA)
def test_gcda_matches_reference(world, name, writes):
    from repro_torch.core.schema import AnalyticsTask, GCDIATask
    from repro_torch.core.sqlpgq import parse
    _, data, tr = world
    task = harness.load_task(harness.HERE, name)
    db, eng = engine(data)
    done = tr.writes_upto(writes - 1)
    for g, rows in done:
        db.graphs[g].insert_edges(rows)
    got = eng.analyze(GCDIATask(parse(task["text"]), AnalyticsTask(
        task["op"], [tuple(x) for x in task["inputs"]])),
        iters=task.get("iters", 100))
    mats = reference.gcda_inputs(task, task["spec"], data, done)
    v = reference.compare_gcda(task, got, mats,
                               reference.Precision(False, "cpu"), block=700)
    assert v <= task["check"]["limit"]


def test_writes_change_the_answers(world):
    """A write that the reference replays moves G1, so a dropped write
    cannot pass unseen."""
    _, data, tr = world
    spec = harness.load_task(harness.HERE, "G1")["spec"]
    before = reference.evaluate(spec, data)
    after = reference.evaluate(spec, data, tr.writes_upto(9))
    assert reference.rows_mismatched(before, after) > 0


def test_parse_reads_every_predicate_form():
    spec = reference.parse(
        "SELECT a.x, T.y FROM T MATCH (a:L)-[e:E]->(b:L) ON G WHERE "
        "T.k = a.x AND a.v BETWEEN 1 AND 2.5 AND b.w IN ('p', 'q') AND "
        "e.z <> 3")
    assert spec["joins"] == [("T.k", "a.x")]
    assert spec["filters"] == [("a.v", "between", (1, 2.5)),
                               ("b.w", "in", ("p", "q")), ("e.z", "<>", 3)]
    assert spec["edges"] == [("e", "E", "a", "b")]


def test_join_index_is_many_to_many():
    a = np.array([1, 2, 2, 5])
    b = np.array([2, 1, 2, 7])
    li, ri = reference._join_index(a, b)
    pairs = sorted(zip(li.tolist(), ri.tolist()))
    assert pairs == [(0, 1), (1, 0), (1, 2), (2, 0), (2, 2)]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 3.0], dtype=torch.float32)
    got = reference.round_tf32(x)
    assert got.tolist() == [1.0 + 2**-10, 1.0, 3.0]


@pytest.mark.parametrize("got, want, gap", [
    ([np.array([1, 2, 2])], [np.array([2, 1, 2])], 0),
    ([np.array([1, 2, 2])], [np.array([2, 1, 1])], 2),
    ([np.array(["a", "b"], dtype=object)], [np.array(["a", "c"], dtype=object)], 2),
    ([np.array([1, 2]), np.array(["x", "y"], dtype=object)],
     [np.array([2, 1]), np.array(["y", "x"], dtype=object)], 0),
])
def test_rows_mismatched_counts_the_multiset_difference(got, want, gap):
    assert reference.rows_mismatched(got, want) == gap
