"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, in one child process (``tests/torch_dryrun_checks.py``; the
``fake`` backend must not live in a test worker): the twin of
``test_window_and_gcda_cells.py::test_gcda_cells_lower_on_small_mesh``
(the three gredo cells traced on a fake 2x4 mesh), one cell of each family
built on the fake production mesh, the CLI's records, the LM layer
extrapolation held against a full-depth trace, a small MoE LM's three
kinds, and the small LMs, Wide & Deep and the four GNN families on a fake
2x4 and 2x2x4 mesh (children of their own), held against the reference's
dry-run of the same configs (``tests/torch_dryrun_ref_checks.py``, a child
run beside them): FLOPs and collective bytes per device, by kind and mesh
dims, the ``REPRO_MOE_EP=1`` variant, and the differences kept."""
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


def _children(tmp, *argvs):
    """Each ``argv`` (a helper under ``tests/`` and its arguments) in a
    child process of its own, all at once, each within 300 s: the JSON
    object each printed after ``RESULTS``."""
    procs = []
    for i, argv in enumerate(argvs):
        log = open(os.path.join(tmp, f"child{i}.log"), "w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", argv[0]),
             *argv[1:]], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    try:
        for log, p in procs:
            rc = p.wait(timeout=300)
            log.seek(0)
            text = log.read()
            assert rc == 0, text[-5000:]
            line = [ln for ln in text.splitlines()
                    if ln.startswith("RESULTS ")]
            out.append(json.loads(line[-1][len("RESULTS "):]))
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The port's small cells (LMs and Wide & Deep; the GNNs) and the
    reference's dry-run of the same configs, three children at once."""
    tmp = str(tmp_path_factory.mktemp("meshes"))
    return _children(tmp, ("torch_dryrun_checks.py", tmp, "meshes"),
                     ("torch_dryrun_checks.py", tmp, "gnn"),
                     ("torch_dryrun_ref_checks.py",))


@pytest.fixture(scope="module")
def meshes(children):
    """The port's small cells on the fake (2, 4) and (2, 2, 4) meshes (and
    the GNNs also on (2, 1))."""
    return {**children[0]["meshes"], **children[1]["meshes"]}


@pytest.fixture(scope="module")
def reference(children):
    """The reference's dry-run of the same small configs on the same
    meshes."""
    return children[2]


SMALL_LM_CELLS = [f"{a}/{s}" for a in ("qwen2_1_5b", "olmoe_1b_7b")
                  for s in ("train_4k", "prefill_32k", "decode_32k")]


WD_CELLS = ["wide_deep/serve_p99", "wide_deep/train_batch",
            "wide_deep/retrieval_cand"]


GNN_CELLS = ["gatedgcn/full_graph_sm", "pna/full_graph_sm", "mace/molecule",
             "equiformer_v2/molecule"]


@pytest.mark.parametrize("mesh", ["2x4", "2x2x4"])
@pytest.mark.parametrize("cell", SMALL_LM_CELLS + ["wide_deep/serve_p99"]
                         + WD_CELLS[1:] + GNN_CELLS)
def test_small_cells_replicate_nothing(meshes, cell, mesh):
    """Every operation of an LM (dense or MoE), Wide & Deep or GNN step is
    partitioned on one pod and on two: the batch (or the edges) split over
    ('pod', 'data') survives every reshape, and no operation falls back to
    replicated inputs."""
    got = meshes[f"{cell}/{mesh}"]
    assert got["ok"], got["error"]
    assert got["replicated_ops"] == {}


def _ratio(recs, cell, key):
    """A record's ``key`` on (2, 2, 4) over its ``key`` on (2, 4)."""
    two, one = recs[f"{cell}/2x2x4"], recs[f"{cell}/2x4"]
    for rec in (one, two):
        assert rec["ok"], rec["error"]
    return key(two) / key(one)


def _port_bytes(rec):
    return rec["collectives"]["total_bytes"]


def _ref_bytes(rec):
    return rec["coll"]


@pytest.mark.parametrize("cell", SMALL_LM_CELLS + WD_CELLS)
def test_second_pod_shrinks_flops_as_the_reference(meshes, reference, cell):
    """A second pod halves each device's share of the step, in the port as
    in the reference: the ratio of per-device matrix-product FLOPs,
    (2, 2, 4) over (2, 4), agrees within 2% with the reference's ratio of
    the same count (``dot_flops_per_device``; XLA's ``flops_per_device``
    also counts the replicated elementwise work, which weighs at this
    size). Replicating an operation over 'pod' would raise the ratio."""
    port = _ratio(meshes, cell, lambda r: r["dot_flops"])
    ref = _ratio(reference, cell, lambda r: r["dot_flops"])
    assert port == pytest.approx(ref, rel=0.02)


@pytest.mark.parametrize("cell", SMALL_LM_CELLS + ["wide_deep/serve_p99",
                                                  "wide_deep/retrieval_cand"]
                         + [c for c in GNN_CELLS if c != "mace/molecule"])
def test_second_pod_shrinks_collectives_as_the_reference(meshes, reference,
                                                         cell):
    """A second pod shrinks each device's collective bytes as it shrinks
    the reference's: the ratio of per-device collective bytes, (2, 2, 4)
    over (2, 4), within 10% of the reference's. In a train step the
    gradients are reduced once over ('pod', 'data') joined, as GSPMD
    reduces them (DTensor's own redistribution reduced them mesh dim by
    mesh dim, and a second pod raised the bytes: 1.1951 and 1.1428 for the
    dense and MoE ``train_4k``, the reference's 0.6581 and 0.6966); the
    retrieval's scores are gathered once over ('pod', 'data'). Wide &
    Deep's ``train_batch`` differs by the reference's own growth
    (:func:`test_wide_deep_train_batch_grows_only_in_the_reference`),
    MACE's by the port's smaller traffic
    (:func:`test_mace_moves_less_than_the_reference_on_both_meshes`)."""
    port = _ratio(meshes, cell, _port_bytes)
    ref = _ratio(reference, cell, _ref_bytes)
    assert port == pytest.approx(ref, rel=0.10)


@pytest.mark.parametrize("cell", ["qwen2_1_5b/train_4k",
                                  "olmoe_1b_7b/train_4k"])
def test_train_step_reduces_the_data_axes_at_once(meshes, cell):
    """By kind and mesh dims: on two pods no collective reduces over 'pod'
    or 'data' alone, and the gradients' reductions over ('pod', 'data')
    (and with 'model', for partial sums over all three) move what they
    moved over 'data' on one pod: a second pod adds no reduction."""
    one = meshes[f"{cell}/2x4"]["collective_groups"]
    two = meshes[f"{cell}/2x2x4"]["collective_groups"]
    for kind in ("all-reduce", "reduce-scatter"):
        for dim in ("pod", "data"):
            assert f"{kind} over {dim}" not in two, two
    assert two["all-reduce over pod_data"] == one["all-reduce over data"]
    assert (two["all-reduce over pod_data_model"]
            == one["all-reduce over data_model"])


@pytest.mark.parametrize("mesh", ["2x4", "2x2x4"])
def test_moe_ep_variant_is_the_default_in_the_port(meshes, reference, mesh):
    """``REPRO_MOE_EP=1`` (the reference's pins of (groups over the data
    axes, experts over 'model')) traces in the port exactly as the default
    does, whose MoE block already runs each rank's groups and experts;
    the reference's variant raises under jax 0.9.0, whose ``make_mesh``
    gives Explicit axes that ``with_sharding_constraint`` refuses (a
    reference fault the port keeps out of its own code: it does not
    raise)."""
    cell = f"olmoe_1b_7b/train_4k/{mesh}"
    ep, default = meshes[f"{cell}/ep"], meshes[cell]
    assert ep["ok"], ep["error"]
    for key in ("dot_flops", "collectives", "collective_groups",
                "replicated_ops"):
        assert ep[key] == default[key]
    assert reference[cell]["ok"]
    assert not reference[f"{cell}/ep"]["ok"]
    assert "with_sharding_constraint can only refer to Auto axes" in \
        reference[f"{cell}/ep"]["error"]


def test_wide_deep_train_batch_grows_only_in_the_reference(meshes,
                                                           reference):
    """A kept difference: on two pods XLA's partitioner cannot reshard the
    tables' gradient to their layout, replicates it ("involuntary full
    rematerialization") and the reference's collective bytes per device
    more than double (2.2986 at this size, 5.2335 at the production
    size); the port moves less per device on two pods than on one, as the
    other train steps do (0.9248 here)."""
    cell = "wide_deep/train_batch"
    assert reference[f"{cell}/2x4"]["rematerialized"] == 0
    assert reference[f"{cell}/2x2x4"]["rematerialized"] > 0
    assert _ratio(reference, cell, _ref_bytes) > 2
    assert 0.5 < _ratio(meshes, cell, _port_bytes) < 1


@pytest.mark.parametrize("mesh", ["2x4", "2x2x4"])
@pytest.mark.parametrize("cell", GNN_CELLS)
def test_gnn_work_per_device_is_at_most_the_references(meshes, reference,
                                                       cell, mesh):
    """Each device's matrix-product FLOPs of a GNN step are at most 1.05
    times the reference's on one pod and on two. The reference's count is
    made per loop trip from its HLO (``dot_flops_trips``): its own
    ``dot_flops_per_device`` skips GatedGCN's layer ``lax.scan`` (86,016
    on 2x4 against 1,134,592 counted per trip). The port splits what the
    reference splits: MACE's channel mixing into blocks of the weights'
    columns (its CG products then keep the channel split; whole over
    'model' they did 12 times the reference's work at production width),
    EquiformerV2's rotations by channel, PNA's update by the data blocks
    of its 13d inputs, GatedGCN's node products by the data blocks of the
    nodes."""
    port = meshes[f"{cell}/{mesh}"]
    ref = reference[f"{cell}/{mesh}"]
    assert port["ok"], port["error"]
    assert port["dot_flops"] <= 1.05 * ref["dot_flops_trips"]


# the reference's FLOPs ratio (2, 2, 4) over (2, 4), and how close the
# port keeps to it (None: at most the reference's)
GNN_FLOPS_RATIO_TOL = {"equiformer_v2/molecule": 0.02, "mace/molecule": 0.05,
                       "pna/full_graph_sm": None}


@pytest.mark.parametrize("cell", sorted(GNN_FLOPS_RATIO_TOL))
def test_gnn_second_pod_shrinks_flops(meshes, reference, cell):
    """A second pod shrinks each device's matrix-product FLOPs of a GNN
    step, (2, 2, 4) over (2, 4), as it shrinks the reference's: for
    EquiformerV2 within 2% (its node-wise work runs on each data rank's
    nodes, as the reference's does on two pods), for MACE within 5% (its
    CG products run whole over the data axes in both packages). PNA's
    shrinks more: on two pods GSPMD runs its update's forward whole over
    ('pod', 'data') and the weight gradient over 'data' alone (0.7295),
    on one pod both over 'data'; the port keeps one layout, its update
    split over all the data ranks on both meshes (0.5126), and so does
    less work per device than the reference on each
    (:func:`test_gnn_work_per_device_is_at_most_the_references`).
    GatedGCN is left out: GSPMD splits its node features over ('pod',
    'data') on two pods only, so the reference's ratio (0.4747, counted
    per trip) is below a half, where the port, its node products on each
    data rank's nodes on both meshes, gives 0.5728."""
    port = _ratio(meshes, cell, lambda r: r["dot_flops"])
    ref = _ratio(reference, cell, lambda r: r["dot_flops_trips"])
    tol = GNN_FLOPS_RATIO_TOL[cell]
    if tol is None:
        assert port <= ref
    else:
        assert port == pytest.approx(ref, rel=tol)


def test_mace_moves_less_than_the_reference_on_both_meshes(meshes,
                                                            reference):
    """A kept difference: the port's MACE moves fewer collective bytes per
    device than the reference's on one pod and on two, and a second pod
    shrinks them more (0.6554 against 0.7659, torch 2.13): its channel
    mixing runs on each data rank's nodes on both meshes, where GSPMD
    keeps the reference's whole over 'data' on one pod and splits it over
    ('pod', 'data') on two only."""
    cell = "mace/molecule"
    for mesh in ("2x4", "2x2x4"):
        assert (_port_bytes(meshes[f"{cell}/{mesh}"])
                < _ref_bytes(reference[f"{cell}/{mesh}"]))
    assert (_ratio(meshes, cell, _port_bytes)
            < _ratio(reference, cell, _ref_bytes))


# products each device runs whole over 'model', as the reference does:
# EquiformerV2's per-edge Wigner matrices (built on the edges' split) and
# MACE's spherical harmonics folded into each path's CG tensor
WHOLE_OVER_MODEL = {
    "equiformer_v2/molecule": ("bmm (1,256,16)x(1,16,256)",
                               "bmm (256,16,16)x(256,16,16)"),
    "mace/molecule": ("bmm (1,256,5)x(1,5,15)", "bmm (1,256,5)x(1,5,25)",
                      "bmm (1,256,3)x(1,3,15)", "bmm (1,256,3)x(1,3,25)")}


@pytest.mark.parametrize("cell", GNN_CELLS)
def test_gnn_products_split_over_model(meshes, cell):
    """Every other product of a GNN step runs on each 'model' rank's block
    of the channels or of the weights' columns: on (2, 4) they take a
    quarter (within 4%) of what they take on (2, 1), the same edges per
    device on one 'model' rank (EquiformerV2's rotations took whole
    channels on every 'model' rank before)."""
    four, one = meshes[f"{cell}/2x4"], meshes[f"{cell}/2x1"]
    whole = 0.0
    for sig in WHOLE_OVER_MODEL.get(cell, ()):
        assert four["products"][sig] == one["products"][sig]
        whole += four["products"][sig][1]
    split = (four["dot_flops"] - whole) / (one["dot_flops"] - whole)
    assert split <= 0.26


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
