"""Dry-run checks of ``tests/test_torch_dryrun.py``, run in a child
process (the ``fake`` process group must not live in a test worker):
``python tests/torch_dryrun_checks.py OUT_DIR`` prints one JSON object of
results. Imports the port alone."""
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
    """A small LM standing in for qwen2-1.5b's published config."""
    from repro_torch import configs
    from repro_torch.models.transformer import TransformerConfig

    mod = configs.get("qwen2_1_5b")
    mod.config = lambda: TransformerConfig(
        name="tiny", n_layers=monkey_layers, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, qkv_bias=True, q_chunk=16,
        kv_chunk=16)
    mod.SHAPES = {"train_4k": {"kind": "train", "seq": 32, "batch": 8},
                  "prefill_32k": {"kind": "prefill", "seq": 64, "batch": 4},
                  "decode_32k": {"kind": "decode", "seq": 64, "batch": 8}}
    return mod


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
    """A small MoE LM (standing in for OLMoE's published config) through
    its three kinds on a fake (2, 4) mesh: its routing runs operations
    DTensor cannot shard (a sorted search, in-place scatters), which the
    dry-run replicates and lists."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import TransformerConfig

    mod = configs.get("olmoe_1b_7b")
    mod.config = lambda: TransformerConfig(
        name="tiny-moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, n_experts=8, top_k=2, q_chunk=16, kv_chunk=16)
    mod.SHAPES = {"train_4k": {"kind": "train", "seq": 32, "batch": 8},
                  "prefill_32k": {"kind": "prefill", "seq": 32, "batch": 4},
                  "decode_32k": {"kind": "decode", "seq": 32, "batch": 8}}
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


def main(out_dir: str) -> None:
    results = {"gcda_small_mesh": _gcda_small_mesh(os.path.join(out_dir, "a")),
               "build": _build_one_per_family(),
               "cli": _cli(os.path.join(out_dir, "b")),
               "layers": _layer_extrapolation(),
               "moe": _moe_cells()}
    print("RESULTS " + json.dumps(results, default=str))


if __name__ == "__main__":
    main(sys.argv[1])
