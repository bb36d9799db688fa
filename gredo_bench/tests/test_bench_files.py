"""Every name in BENCHMARK.json resolves to its files, and a cell, a
configuration, a mix, a query or a metric is added by adding files."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from gredo_bench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    body = json.loads((harness.REPO / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert set(cfg["reduced"]) == set(body["reduced"])
    assert {"isolation", "visibility", "answers", "durability"} \
        <= set(body["guarantees"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = harness.Cell(w["name"], BENCH)
    assert cell.tasks and cell.per_layer and cell.end_to_end
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    for cell in m["workloads"]:
        e2e = {e["name"] for e in BENCH["end_to_end"]
               if cell in e.get("workloads", [cell])}
        assert m["moves"] in e2e


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new mix, query and metric in a copy of the folder, and a new entry
    in the benchmark: the harness finds them all by name."""
    root = tmp_path / "gredo_bench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "queries" / "G9.sql").write_text(
        "SELECT t.tid MATCH (p:Persons)-[e0:Interested_in]->(t:Tags) ON "
        "Interested_in WHERE p.country = 'uk'\n")
    (root / "traffic" / "probe.json").write_text(json.dumps(
        {"name": "probe", "clients": 1, "tasks": {"G9": 1, "G1": 2},
         "check": {"per_task": 1}}))
    (root / "metrics" / "probe.count.py").write_text(
        "def read(obs):\n    return float(len(obs['tasks']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ecom_sf10.probe",
                               "config": "m2bench_ecom_sf10",
                               "traffic": "probe", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("ecom_sf10.probe")
    bench["per_layer"].append({"name": "probe.count", "unit": "tasks",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "gcdi_tasks_per_s",
                               "workloads": ["ecom_sf10.probe"]})
    cell = harness.Cell("ecom_sf10.probe", bench, root=root)
    assert set(cell.tasks) == {"G9", "G1"}
    assert cell.tasks["G9"]["spec"]["select"] == ["t.tid"]
    assert cell.readers["probe.count"]({"tasks": [1, 2]}) == 2.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such.cell", BENCH)
