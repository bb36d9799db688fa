"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, in one child process (``tests/torch_dryrun_checks.py``; the
``fake`` backend must not live in a test worker): the twin of
``test_window_and_gcda_cells.py::test_gcda_cells_lower_on_small_mesh``
(the three gredo cells traced on a fake 2x4 mesh), one cell of each family
built on the fake production mesh, the CLI's records, the LM layer
extrapolation held against a full-depth trace, and a small MoE LM's
three kinds."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(__file__))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dryrun_checks.py"),
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULTS ")]
    return json.loads(line[-1][len("RESULTS "):])


def test_gcda_cells_lower_on_small_mesh(results):
    """Per device on the 2x4 mesh: regression reads its 1/2 of X twice (two
    matrix-vector products) and all-reduces d + 1 floats over 'data';
    similarity and multiply are one (n/2, n/4) product tile each."""
    recs = results["gcda_small_mesh"]
    for shape, rec in recs.items():
        assert rec["ok"], rec["error"]
        assert rec["mesh"] == "2x4" and rec["replicated_ops"] == {}
    reg = recs["gcda_regression"]
    n, d = 4_194_304, 512
    assert reg["flops_per_device"] == 2 * 2 * (n // 2) * d
    assert reg["collectives"]["all-reduce"] == {"count": 1,
                                                "bytes": (d + 1) * 4 * 2}
    assert reg["memory"]["argument_bytes"] == (n // 2) * (d + 1) * 4 + d * 4
    assert recs["gcda_similarity"]["flops_per_device"] == \
        2 * (262_144 // 2) * (262_144 // 4) * 256
    assert recs["gcda_multiply"]["flops_per_device"] == \
        2 * (65_536 // 2) * 4_096 * (65_536 // 4)
    # bf16 tiles out
    assert recs["gcda_multiply"]["memory"]["output_bytes"] == \
        (65_536 // 2) * (65_536 // 4) * 2


@pytest.mark.parametrize("cell,kind", [
    ("qwen2_1_5b/train_4k", "train"), ("olmoe_1b_7b/decode_32k", "decode"),
    ("stablelm_3b/prefill_32k", "prefill"), ("wide_deep/serve_p99",
                                             "recsys_serve"),
    ("gatedgcn/full_graph_sm", "gnn_train"),
    ("gredo/gcda_similarity", "gcda_similarity")])
def test_build_cell_per_family_on_the_production_mesh(results, cell, kind):
    got = results["build"][cell]
    assert got["kind"] == kind
    # one placement tuple per argument, one placement per mesh dim
    assert got["n_args"] == got["n_shardings"] > 0
    assert got["placements_per_arg"] == [2]


def test_dryrun_cli_records(results):
    cli = results["cli"]
    assert cli["rc"] == 0
    assert [r["mesh"] for r in cli["records"]] == ["16x16", "2x16x16"]
    for r in cli["records"]:
        assert r["ok"]
        for key in ("flops_per_device", "bytes_per_device",
                    "dot_flops_per_device", "hbm_bytes_per_device",
                    "collectives", "memory", "n_devices", "kind", "meta"):
            assert key in r
        assert r["memory"]["temp_bytes"] is None
    assert cli["records"][0]["n_devices"] == 256
    assert cli["records"][1]["n_devices"] == 512
    assert cli["records"][0]["flops_per_device"] == \
        2 * (65_536 // 16) * 4_096 * (65_536 // 16)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_layers_counted_per_trip(results, shape):
    """A prefill or decode record built from the 1- and 2-layer traces
    equals one trace of all 3 layers; a train record is that trace."""
    got = results["layers"][shape]
    assert got["ok"], got["error"]
    assert got["extrapolated"] == got["full"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_moe_cells_trace(results, shape):
    """The MoE routing's sorted search has no DTensor rule: it runs on
    replicated inputs and the record says so."""
    got = results["moe"][shape]
    assert got["ok"], got["error"]
    assert got["replicated_ops"].get("aten.searchsorted.Tensor", 0) > 0
    assert got["flops_per_device"] > 0
