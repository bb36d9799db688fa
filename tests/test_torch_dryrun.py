"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, in one child process (``tests/torch_dryrun_checks.py``; the
``fake`` backend must not live in a test worker): the twin of
``test_window_and_gcda_cells.py::test_gcda_cells_lower_on_small_mesh``
(the three gredo cells traced on a fake 2x4 mesh), one cell of each family
built on the fake production mesh, the CLI's records, the LM layer
extrapolation held against a full-depth trace, a small MoE LM's three
kinds, and the small LMs and a small Wide & Deep cell on a fake 2x4 and
2x2x4 mesh, held against the reference's dry-run of the same LMs
(``tests/torch_dryrun_ref_checks.py``, a child of its own)."""
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
    """The MoE block runs on each rank's groups and experts (its sorted
    search, gathers and scatters are per group), so nothing is
    replicated."""
    got = results["moe"][shape]
    assert got["ok"], got["error"]
    assert got["replicated_ops"] == {}
    assert got["flops_per_device"] > 0


def _child(script, *args):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests", script),
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULTS ")]
    return json.loads(line[-1][len("RESULTS "):])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The port's small cells on the fake (2, 4) and (2, 2, 4) meshes."""
    return _child("torch_dryrun_checks.py",
                  str(tmp_path_factory.mktemp("meshes")), "meshes")["meshes"]


@pytest.fixture(scope="module")
def reference():
    """The reference's dry-run of the same small LMs on the same meshes."""
    return _child("torch_dryrun_ref_checks.py")


SMALL_LM_CELLS = [f"{a}/{s}" for a in ("qwen2_1_5b", "olmoe_1b_7b")
                  for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("mesh", ["2x4", "2x2x4"])
@pytest.mark.parametrize("cell", SMALL_LM_CELLS + ["wide_deep/serve_p99"])
def test_small_cells_replicate_nothing(meshes, cell, mesh):
    """Every operation of an LM (dense or MoE) or Wide & Deep step is
    partitioned on one pod and on two: the batch split over ('pod',
    'data') survives every reshape, and no operation falls back to
    replicated inputs."""
    got = meshes[f"{cell}/{mesh}"]
    assert got["ok"], got["error"]
    assert got["replicated_ops"] == {}


@pytest.mark.parametrize("cell", SMALL_LM_CELLS)
def test_second_pod_shrinks_flops_as_the_reference(meshes, reference, cell):
    """A second pod halves each device's share of the step, in the port as
    in the reference: the ratio of per-device matrix-product FLOPs,
    (2, 2, 4) over (2, 4), agrees within 2% with the reference's ratio of
    the same count (``dot_flops_per_device``; XLA's ``flops_per_device``
    also counts the replicated elementwise work, which weighs at this
    size). Replicating an operation over 'pod' would raise the ratio."""
    port = (meshes[f"{cell}/2x2x4"]["dot_flops"]
            / meshes[f"{cell}/2x4"]["dot_flops"])
    for mesh in ("2x4", "2x2x4"):
        assert reference[f"{cell}/{mesh}"]["ok"], \
            reference[f"{cell}/{mesh}"]["error"]
    ref = (reference[f"{cell}/2x2x4"]["dot_flops"]
           / reference[f"{cell}/2x4"]["dot_flops"])
    assert port == pytest.approx(ref, rel=0.02)


@pytest.mark.parametrize("mesh,data", [("2x4", 2), ("2x2x4", 4)])
def test_wide_deep_lookup_moves_only_its_sums(meshes, mesh, data):
    """The lookups from row-sharded tables are masked local gathers whose
    results are all-reduced over 'model': each device moves its rows'
    (F, d) embeddings and F - 1 wide weights, twice for the ring, and not
    one table row (the smoke config's tables: 6 x 1000 x 8)."""
    got = meshes[f"wide_deep/serve_p99/{mesh}"]
    rows, F, d = 64 // data, 6, 8
    assert got["collectives"] == {
        "all-reduce": {"count": 2, "bytes": 2 * 4 * rows * (F * d + F - 1)},
        "total_bytes": 2 * 4 * rows * (F * d + F - 1)}
