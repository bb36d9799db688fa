"""The reference's dry-run of the small LMs of ``tests/torch_dryrun_checks.py``
and of the smoke Wide & Deep and GNNs (the same configs and shapes), run
in a child process of its own (``DRYRUN_DEVICE_COUNT`` must be set before
JAX starts): ``python tests/torch_dryrun_ref_checks.py`` prints one JSON
object, the per-device FLOPs and collective bytes (in all and by kind) of
each cell on the (2, 4) and (2, 2, 4) meshes, how often XLA's partitioner
reported an involuntary full rematerialization while compiling it, its
matrix products by shape (``dots``) and their FLOPs counted per loop trip
(``dot_flops_trips``), and the small MoE's train step with
``REPRO_MOE_EP=1``. Imports the reference alone; the port's child imports
the configs from here."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

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
# Wide & Deep and the GNNs at their smoke configs (``smoke_config``)
WD_SHAPES = {"train_batch": {"kind": "train", "batch": 64},
             "serve_p99": {"kind": "serve", "batch": 64},
             "retrieval_cand": {"kind": "retrieval", "batch": 1,
                                "n_candidates": 4096}}
MOLECULE_SHAPES = {"molecule": {"kind": "molecule", "n_nodes": 30,
                                "n_edges": 64, "batch": 8}}
GRAPH_SHAPES = {"full_graph_sm": {"kind": "full_graph", "n_nodes": 256,
                                  "n_edges": 1024, "d_feat": 24,
                                  "n_classes": 4}}
SMALL = {"qwen2_1_5b": (TINY_LM, LM_SHAPES),
         "olmoe_1b_7b": (TINY_MOE, MOE_SHAPES),
         "wide_deep": (None, WD_SHAPES),
         "gatedgcn": (None, GRAPH_SHAPES),
         "pna": (None, GRAPH_SHAPES),
         "mace": (None, MOLECULE_SHAPES),
         "equiformer_v2": (None, MOLECULE_SHAPES)}
GNN_ARCHS = ("gatedgcn", "pna", "mace", "equiformer_v2")
MESHES = {"2x4": (2, 4, 0), "2x2x4": (2, 4, 2)}


def use_smoke(mod, arch: str) -> None:
    """Point either package's config module of ``arch`` at its smoke
    config and ``SMALL``'s shapes. For the feature GNNs ``build_cell``
    passes the shape's input width, classes and readout, which replace
    the smoke config's."""
    smoke = mod.smoke_config
    if arch in ("gatedgcn", "pna"):
        mod.config = lambda **kw: dataclasses.replace(smoke(), **kw)
    else:
        mod.config = smoke
    mod.SHAPES = SMALL[arch][1]


_DOT = re.compile(r"^(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\w+\[[0-9,]*\])\S*\s+"
                  r"dot\(%?([\w.\-]+), %?([\w.\-]+)\),.*?"
                  r"lhs_contracting_dims=\{([0-9,]*)\}")
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+\[[0-9,]*\])|"
                  r"%?([\w.\-]+):\s*(\w+\[[0-9,]*\])")
_TYPE = re.compile(r"\w+\[([0-9,]*)\]")
_BODY = re.compile(r"\bwhile\(.*?body=%?([\w.\-]+)")
_CALLS = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")


def dots_by_shape(hlo: str):
    """The matrix products of a compiled step's HLO text: {"out <- lhs x
    rhs": [count, FLOPs]} and their FLOPs in all, each product inside a
    loop counted once per trip. The reference's own count
    (``hlo_cost``) skips a ``while`` whose tuple type carries an
    ``/*index=N*/`` comment (its line pattern refuses the ``=``), so a
    ``lax.scan``'s body (GatedGCN's layers) is left out there."""
    from repro.launch.hlo_analysis import _TRIP_RE, _split_computations

    def dims(t):
        return [int(d) for d in t.split(",") if d]

    comps = _split_computations(hlo)
    types = {}          # value or parameter name -> its array type
    for line in hlo.splitlines():
        for m in _DEF.finditer(line):
            name, t = (m.group(1), m.group(2)) if m.group(1) else \
                (m.group(3), m.group(4))
            types.setdefault(name, t)
    own, calls = {}, {}
    for name, lines in comps.items():
        own[name], calls[name] = [], []
        for line in lines:
            m = _DOT.match(line)
            if m:
                out, lhs, rhs = m.group(1), types[m.group(2)], \
                    types[m.group(3)]
                n = 1
                for d in dims(_TYPE.match(out).group(1)):
                    n *= d
                for i in dims(m.group(4)):
                    n *= dims(_TYPE.match(lhs).group(1))[i]
                own[name].append((f"{out} <- {lhs} x {rhs}", 2 * n))
            body = _BODY.search(line)
            if body:
                trips = _TRIP_RE.search(line)
                calls[name].append((body.group(1),
                                    int(trips.group(1)) if trips else 1))
            elif " while(" not in line:
                calls[name] += [(c, 1) for c in _CALLS.findall(line)]
    entry = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M).group(1)
    table = defaultdict(lambda: [0, 0.0])

    def walk(name, k, stack=()):
        if name not in comps or name in stack:
            return
        for sig, f in own[name]:
            table[sig][0] += k
            table[sig][1] += k * f
        for child, trips in calls[name]:
            walk(child, k * trips, stack + (name,))

    walk(entry, 1)
    return dict(table), sum(f for _, f in table.values())


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
    from repro.launch import dryrun, hlo_analysis
    from repro.launch.mesh import make_local_mesh
    from repro.models.transformer import TransformerConfig

    hlo = {}
    cost = hlo_analysis.hlo_cost

    def keep_text(text):        # run_cell's own call: keep the HLO text
        hlo["text"] = text
        return cost(text)

    hlo_analysis.hlo_cost = keep_text
    cells = [(a, s, "") for a in SMALL for s in SMALL[a][1]]
    cells.append(("olmoe_1b_7b", "train_4k", "ep"))     # REPRO_MOE_EP=1
    out = {}
    for arch, shape, variant in cells:
        kw, shapes = SMALL[arch]
        mod = configs.get(arch)
        if kw is None:
            use_smoke(mod, arch)
        else:
            mod.config = lambda kw=kw: TransformerConfig(**kw)
            mod.SHAPES = shapes
        for name, (data, model, pod) in MESHES.items():
            hlo.clear()
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
            if arch in GNN_ARCHS and "text" in hlo:
                dots, trips = dots_by_shape(hlo["text"])
                out[f"{arch}/{shape}/{name}"].update(
                    dots=dots, dot_flops_trips=trips)
    print("RESULTS " + json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main()
