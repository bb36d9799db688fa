"""The reference's dry-run of the small LMs of ``tests/torch_dryrun_checks.py``
and of the smoke Wide & Deep and EquiformerV2 (the same configs and
shapes), run in a child process of its own (``DRYRUN_DEVICE_COUNT`` must be
set before JAX starts): ``python tests/torch_dryrun_ref_checks.py`` prints
one JSON object, the per-device FLOPs and collective bytes (in all and by
kind) of each cell on the (2, 4) and (2, 2, 4) meshes, how often XLA's
partitioner reported an involuntary full rematerialization while
compiling it, and the small MoE's train step with ``REPRO_MOE_EP=1``. Imports the reference alone; the port's child imports
the configs from here."""
from __future__ import annotations

import json
import os
import sys
import tempfile

# the small configs, as keyword arguments of either package's
# TransformerConfig, and their shapes
TINY_LM = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=128, vocab=256, qkv_bias=True, q_chunk=16, kv_chunk=16)
TINY_MOE = dict(name="tiny-moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=32, vocab=256, n_experts=8, top_k=2,
                q_chunk=16, kv_chunk=16)
LM_SHAPES = {"train_4k": {"kind": "train", "seq": 32, "batch": 8},
             "prefill_32k": {"kind": "prefill", "seq": 64, "batch": 4},
             "decode_32k": {"kind": "decode", "seq": 64, "batch": 8}}
MOE_SHAPES = {"train_4k": {"kind": "train", "seq": 32, "batch": 8},
              "prefill_32k": {"kind": "prefill", "seq": 32, "batch": 4},
              "decode_32k": {"kind": "decode", "seq": 32, "batch": 8}}
# Wide & Deep and EquiformerV2 at their smoke configs (``smoke_config``)
WD_SHAPES = {"train_batch": {"kind": "train", "batch": 64},
             "serve_p99": {"kind": "serve", "batch": 64},
             "retrieval_cand": {"kind": "retrieval", "batch": 1,
                                "n_candidates": 4096}}
EQV2_SHAPES = {"molecule": {"kind": "molecule", "n_nodes": 30,
                            "n_edges": 64, "batch": 8}}
SMALL = {"qwen2_1_5b": (TINY_LM, LM_SHAPES),
         "olmoe_1b_7b": (TINY_MOE, MOE_SHAPES),
         "wide_deep": (None, WD_SHAPES),
         "equiformer_v2": (None, EQV2_SHAPES)}
MESHES = {"2x4": (2, 4, 0), "2x2x4": (2, 4, 2)}


def _logged(fn):
    """(fn(), what it wrote to file descriptor 2): XLA's own log, where
    the partitioner reports an involuntary full rematerialization."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 2)
        try:
            out = fn()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        return out, f.read().decode(errors="replace")


def main() -> None:
    os.environ["DRYRUN_DEVICE_COUNT"] = "16"       # before JAX starts
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from repro import configs
    from repro.launch import dryrun
    from repro.launch.mesh import make_local_mesh
    from repro.models.transformer import TransformerConfig

    cells = [(a, s, "") for a in SMALL for s in SMALL[a][1]]
    cells.append(("olmoe_1b_7b", "train_4k", "ep"))     # REPRO_MOE_EP=1
    out = {}
    for arch, shape, variant in cells:
        kw, shapes = SMALL[arch]
        mod = configs.get(arch)
        mod.config = (mod.smoke_config if kw is None else
                      lambda kw=kw: TransformerConfig(**kw))
        mod.SHAPES = shapes
        for name, (data, model, pod) in MESHES.items():
            if variant:
                os.environ["REPRO_MOE_EP"] = "1"
            try:
                rec, log = _logged(lambda: dryrun.run_cell(
                    arch, shape, False, "",
                    mesh_override=make_local_mesh(data, model, pod)))
            finally:
                os.environ.pop("REPRO_MOE_EP", None)
            out[f"{arch}/{shape}/{name}" + (f"/{variant}" if variant
                                            else "")] = {
                "ok": rec["ok"], "error": rec.get("error"),
                "flops": rec.get("flops_per_device"),
                "dot_flops": rec.get("dot_flops_per_device"),
                "coll": (rec.get("collectives") or {}).get("total_bytes"),
                "collectives": rec.get("collectives"),
                "rematerialized": log.count(
                    "Involuntary full rematerialization")}
    print("RESULTS " + json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main()
