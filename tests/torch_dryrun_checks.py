"""Dry-run checks of ``tests/test_torch_dryrun.py``, run in a child
process (the ``fake`` process group must not live in a test worker):
``python tests/torch_dryrun_checks.py OUT_DIR [meshes | gnn]``
prints one JSON object of results. Imports the port alone (and the small
configs' arguments from ``torch_dryrun_ref_checks``, which import
nothing)."""
from __future__ import annotations

import json
import os
import sys


def _gcda_small_mesh(out_dir):
    """The three gredo cells traced on a fake (2, 4) mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    dryrun.fake_world(8)
    mesh = make_local_mesh(2, 4, device="cpu")
    recs = {}
    for shape in ("gcda_regression", "gcda_similarity", "gcda_multiply"):
        rec = dryrun.run_cell("gredo", shape, False, out_dir,
                              mesh_override=mesh)
        recs[shape] = {k: rec.get(k) for k in
                       ("ok", "error", "flops_per_device", "bytes_per_device",
                        "collectives", "memory", "replicated_ops", "mesh")}
    return recs


def _tiny_lm(monkey_layers: int):
    """A small LM standing in for qwen2-1.5b's published config (the
    reference's twin: ``torch_dryrun_ref_checks.TINY_LM``)."""
    from repro_torch import configs
    from repro_torch.models.transformer import TransformerConfig
    from torch_dryrun_ref_checks import LM_SHAPES, TINY_LM

    mod = configs.get("qwen2_1_5b")
    mod.config = lambda: TransformerConfig(**dict(TINY_LM,
                                                  n_layers=monkey_layers))
    mod.SHAPES = LM_SHAPES
    return mod


def _tiny_moe():
    """A small MoE LM standing in for OLMoE's published config (the
    reference's twin: ``torch_dryrun_ref_checks.TINY_MOE``)."""
    from repro_torch import configs
    from repro_torch.models.transformer import TransformerConfig
    from torch_dryrun_ref_checks import MOE_SHAPES, TINY_MOE

    mod = configs.get("olmoe_1b_7b")
    mod.config = lambda: TransformerConfig(**TINY_MOE)
    mod.SHAPES = MOE_SHAPES
    return mod


# two data ranks and one of 'model': the same edges per device as on
# (2, 4), with every product whole over the single 'model' rank
EXTRA_MESHES = {"2x1": (2, 1, 0)}


def _small_meshes(archs, meshes):
    """Small cells of ``archs`` on fake meshes (``meshes``: names of
    ``MESHES`` or ``EXTRA_MESHES``): the small LM and MoE through train,
    prefill and decode, the smoke Wide & Deep through its train, serve and
    retrieval shapes, the smoke GatedGCN and PNA on a small full graph and
    MACE and EquiformerV2 on a few molecules; (2, 4) and (2, 2, 4) are the
    production meshes' shapes, one and two pods. The MoE's train step runs
    also with ``REPRO_MOE_EP=1``. Each record lists its products by
    operand shapes (``products``)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from torch_dryrun_ref_checks import GNN_ARCHS, MESHES, SMALL, use_smoke

    _tiny_lm(2)
    _tiny_moe()
    for arch in ("wide_deep",) + GNN_ARCHS:
        use_smoke(configs.get(arch), arch)
    cells = [(a, s, "") for a in archs for s in SMALL[a][1]]
    if "olmoe_1b_7b" in archs:
        cells.append(("olmoe_1b_7b", "train_4k", "ep"))
    out = {}
    for name in meshes:
        data, model, pod = {**MESHES, **EXTRA_MESHES}[name]
        dryrun.fake_world(data * model * max(pod, 1))
        mesh = make_local_mesh(data, model, pod, device="cpu")
        for arch, shape, variant in cells:
            if variant:
                os.environ["REPRO_MOE_EP"] = "1"
            try:
                rec = dryrun.run_cell(arch, shape, False, "",
                                      mesh_override=mesh)
            finally:
                os.environ.pop("REPRO_MOE_EP", None)
            out[f"{arch}/{shape}/{name}" + (f"/{variant}" if variant
                                            else "")] = {
                "ok": rec["ok"], "error": rec.get("error"),
                "replicated_ops": rec.get("replicated_ops"),
                "dot_flops": rec.get("dot_flops_per_device"),
                "products": {k: [c, f] for k, c, f, _ in
                             (rec.get("top_ops") or {}).get("products", [])},
                "collectives": rec.get("collectives"),
                "collective_groups": rec.get("collective_groups"),
                "trace_s": rec.get("trace_s")}
    return out


def _layer_extrapolation():
    """Every LM kind: the record from the 0- and 1-layer traces equals one
    trace of all 3 layers."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell

    _tiny_lm(3)
    dryrun.fake_world(8)
    mesh = make_local_mesh(2, 4, device="cpu")
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen2_1_5b", shape, False, "",
                              mesh_override=mesh)
        full, replicated, args, outs = dryrun.trace_cell(
            build_cell("qwen2_1_5b", shape, mesh), mesh)
        out[shape] = {
            "ok": rec["ok"], "error": rec.get("error"),
            "extrapolated": [rec["flops_per_device"], rec["bytes_per_device"],
                             rec["collectives"], rec["memory"]["argument_bytes"],
                             rec["memory"]["output_bytes"],
                             rec["replicated_ops"]],
            "full": [full.flops, full.bytes, collective_bytes(full), args,
                     outs, replicated]}
    return out


def _moe_cells():
    """The small MoE LM through its three kinds on a fake (2, 4) mesh: its
    routing (a sorted search, gathers and scatters per group) runs on each
    rank's groups, so nothing is replicated."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    mod = _tiny_moe()
    dryrun.fake_world(8)
    mesh = make_local_mesh(2, 4, device="cpu")
    out = {}
    for shape in mod.SHAPES:
        rec = dryrun.run_cell("olmoe_1b_7b", shape, False, "",
                              mesh_override=mesh)
        out[shape] = {k: rec.get(k) for k in ("ok", "error",
                                              "replicated_ops",
                                              "flops_per_device")}
    return out


def _build_one_per_family():
    """One cell of each family built on the fake production mesh."""
    from torch.distributed.tensor import Placement

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell, is_tensor_spec
    from repro_torch.train.optimizer import tree_leaves

    dryrun.fake_world(256)
    mesh = make_production_mesh(device="cpu")
    out = {}
    for arch, shape in (("qwen2_1_5b", "train_4k"),
                        ("olmoe_1b_7b", "decode_32k"),
                        ("stablelm_3b", "prefill_32k"),
                        ("wide_deep", "serve_p99"),
                        ("gatedgcn", "full_graph_sm"),
                        ("gredo", "gcda_similarity")):
        cell = build_cell(arch, shape, mesh)
        args = tree_leaves(cell.args, is_leaf=is_tensor_spec)
        sh = tree_leaves(cell.in_shardings, is_leaf=lambda x: isinstance(
            x, tuple) and all(isinstance(p, Placement) for p in x))
        out[f"{arch}/{shape}"] = {
            "kind": cell.kind, "n_args": len(args), "n_shardings": len(sh),
            "placements_per_arg": sorted({len(s) for s in sh}),
            "meta": {k: v for k, v in cell.meta.items()
                     if isinstance(v, (int, float, bool))}}
    return out


def _cli(out_dir):
    from repro_torch.launch import dryrun
    rc = dryrun.main(["--cell", "gredo/gcda_multiply", "--both-meshes",
                      "--out", out_dir])
    files = sorted(os.listdir(out_dir))
    recs = [json.load(open(os.path.join(out_dir, f))) for f in files
            if f.startswith("gredo_gcda_multiply")]
    return {"rc": rc, "records": recs}


def main(out_dir: str, group: str = "") -> None:
    if group == "meshes":                # children of their own: the
        results = {"meshes": _small_meshes(   # slowest
            ("qwen2_1_5b", "olmoe_1b_7b", "wide_deep"), ("2x4", "2x2x4"))}
    elif group == "gnn":
        from torch_dryrun_ref_checks import GNN_ARCHS
        results = {"meshes": _small_meshes(GNN_ARCHS,
                                           ("2x4", "2x2x4", "2x1"))}
    else:
        results = {"gcda_small_mesh": _gcda_small_mesh(
                       os.path.join(out_dir, "a")),
                   "build": _build_one_per_family(),
                   "cli": _cli(os.path.join(out_dir, "b")),
                   "layers": _layer_extrapolation(),
                   "moe": _moe_cells()}
    print("RESULTS " + json.dumps(results, default=str))


if __name__ == "__main__":
    main(*sys.argv[1:])
