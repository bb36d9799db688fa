"""Rank programs of the port's mesh tests (``tests/test_torch_mesh.py``),
run by ``torch_spawn.run_ranks`` on 8 gloo ranks. They import the port
alone; the tests hold what they return against the JAX package."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _gcda(inp):
    from repro_torch.core import analytics
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 4, device="cpu")
    X, Y = torch.from_numpy(inp["X"]), torch.from_numpy(inp["Y"])
    Z = analytics.multiply(X, Y, mesh=mesh)
    S = analytics.similarity(X, X, mesh=mesh)
    return {"Z": _np(Z), "S": _np(S), "Z_local": _np(Z.to_local()),
            "Z_placements": [str(p) for p in Z.placements],
            "coord": mesh.get_coordinate()}


def _regression(inp):
    from repro_torch.core import analytics
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(8, 1, device="cpu")
    out = {}
    for name, iters in (("r256", 30), ("r512", 40), ("r250", 30)):
        X, y = (torch.from_numpy(inp[name][0]),
                torch.from_numpy(inp[name][1]))
        w, loss = analytics.regression_distributed(X, y, mesh, iters=iters)
        out[name] = (_np(w), float(loss))
    return out


def _lm(inp):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import params_from_arrays
    from repro_torch.models import transformer as tfm

    mesh = make_local_mesh(2, 4, device="cpu")
    out = {}
    # sequence-sharded decode
    cfg = tfm.TransformerConfig(**inp["decode_cfg"], dtype=torch.float32,
                                attn_impl="dense")
    cfg_d = dataclasses.replace(cfg, mesh=mesh, mesh_dp=("data",),
                                kv_seq_shard="model")
    p = params_from_arrays(inp["decode_params"])
    toks, nxt = (torch.from_numpy(inp["toks"]).long(),
                 torch.from_numpy(inp["nxt"]).long())
    cache = tfm.init_cache(cfg, 4, 32)
    _, cache = tfm.forward(p, toks, cfg_d, cache=cache,
                           cache_lengths=torch.zeros(4, dtype=torch.int32))
    nl, _ = tfm.serve_step(p, cache, nxt, torch.full((4,), 24,
                                                     dtype=torch.int32), cfg_d)
    out["decode"] = _np(nl)
    out["decode_cache"] = _np(cache["k"])
    # the same with the cache a DTensor laid out as the reference's test
    # lays it out: batch over 'data', positions over 'model'
    spec = placements(P(None, "data", None, "model", None), mesh)
    cache = {k: distribute_tensor(v, mesh, spec)
             for k, v in tfm.init_cache(cfg, 4, 32).items()}
    _, cache = tfm.forward(p, toks, cfg_d, cache=cache,
                           cache_lengths=torch.zeros(4, dtype=torch.int32))
    nl, _ = tfm.serve_step(p, cache, nxt, torch.full((4,), 24,
                                                     dtype=torch.int32), cfg_d)
    out["decode_sharded_cache"] = (_np(nl), _np(cache["k"]),
                                   [str(x) for x in cache["k"].placements])
    # expert-parallel MoE
    cfg = tfm.TransformerConfig(**inp["moe_cfg"], dtype=torch.float32)
    cfg_sm = dataclasses.replace(cfg, mesh=mesh, mesh_dp=("data",),
                                 moe_ep_axis="model", moe_impl="shard_map")
    p = params_from_arrays(inp["moe_params"])
    logits, aux = tfm.forward(p, torch.from_numpy(inp["moe_toks"]).long(),
                              cfg_sm)
    out["moe"] = (_np(logits), float(aux))
    return out


def _retrieval(inp):
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import params_from_arrays, recsys

    mesh = make_local_mesh(2, 4, device="cpu")
    cfg = configs.get("wide_deep").smoke_config()
    p = params_from_arrays(inp["rs_params"])
    v, i = recsys.retrieval_step_distributed(
        p, torch.from_numpy(inp["dense"]), torch.from_numpy(inp["sparse"]),
        torch.from_numpy(inp["cands"]).to(torch.bfloat16), cfg, mesh,
        top_k=16)
    return {"v": _np(v.float()), "i": _np(i)}


def _compressed_psum(rank, inp):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.optimizer import compressed_psum

    mesh = make_local_mesh(2, 4, device="cpu")
    g = {"a": torch.from_numpy(inp["g"][rank]["a"]),
         "b": [torch.from_numpy(inp["g"][rank]["b"])]}
    e = {"a": torch.from_numpy(inp["e"][rank]["a"]),
         "b": [torch.from_numpy(inp["e"][rank]["b"])]}
    s, r = compressed_psum(g, "model", e, mesh)
    return {"sum": (_np(s["a"]), _np(s["b"][0])),
            "res": (_np(r["a"]), _np(r["b"][0])),
            "model_rank": mesh.get_local_rank("model"),
            "data_rank": mesh.get_local_rank("data")}


def _reshard(inp):
    from repro_torch.distributed import elastic
    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 4, device="cpu")
    state = {"a": torch.from_numpy(inp["state_a"]),
             "b": [torch.from_numpy(inp["state_b"]), None]}
    shardings = {"a": (mesh, placements(P("data", "model"), mesh)),
                 "b": [(mesh, placements(P(), mesh)), None]}
    placed = elastic.reshard_state(state, shardings)
    back = elastic.host_gather(placed)
    return {"a_local": _np(placed["a"].to_local()),
            "a_placements": [str(p) for p in placed["a"].placements],
            "back": (back["a"], back["b"][0], back["b"][1]),
            "coord": mesh.get_coordinate()}


def _pod(inp):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, local_block, placements
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 2, pod=2, device="cpu")
    t = torch.from_numpy(inp["pod_t"])
    spec = P(("pod", "data"), "model")
    d = distribute_tensor(t, mesh, placements(spec, mesh))
    return {"coord": mesh.get_coordinate(), "local": _np(d.to_local()),
            "block": _np(local_block(t, mesh, spec)),
            "placements": [str(p) for p in d.placements]}


def _hlo(inp):
    import torch.distributed as dist

    from repro_torch.launch.hlo_analysis import collective_bytes, trace
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 4, device="cpu")
    g = mesh.get_group("model")

    def step():
        x = torch.ones(64)
        for _ in range(4):                   # a 4-trip loop
            dist.all_reduce(x, group=g)
        out = torch.empty(128)
        dist.all_gather_into_tensor(out, torch.ones(32), group=g)
        return x, out

    (x, out), rec = trace(step)
    return {"coll": collective_bytes(rec), "x": _np(x)}


def _pins(inp):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.gnn import equiformer_v2 as eqv2

    mesh = make_local_mesh(2, 4, device="cpu")
    x = torch.from_numpy(inp["pin_x"])                     # (G, E, C, d)
    xd = distribute_tensor(x, mesh, placements(P(), mesh))
    cfg = tfm.TransformerConfig(mesh=mesh, mesh_dp=("data",),
                                moe_ep_axis="model")
    pre = tfm._ep_constraint(xd, cfg, expert_sharded=True)
    post = tfm._ep_constraint(pre, cfg, expert_sharded=False)
    h = torch.from_numpy(inp["pin_h"])                     # (N, dim, C)
    hd = distribute_tensor(h, mesh, placements(P(), mesh))
    ecfg = eqv2.EquiformerV2Config(channel_shard_axis="model")
    pinned = eqv2._cshard(ecfg, hd)
    return {"pre": ([str(p) for p in pre.placements], _np(pre)),
            "post": ([str(p) for p in post.placements], _np(post)),
            "plain": tfm._ep_constraint(x, cfg, True) is x,
            "cshard": ([str(p) for p in pinned.placements], _np(pinned))}


SHARDED_MODELS = ("lm", "moe", "wide_deep", "gatedgcn", "pna")
EQUIVARIANT_MODELS = ("mace", "equiformer_v2")


def _sharded_step(name, inp):
    """The dry-run's layouts run for real: model ``name``'s loss and
    gradients with parameters and batch as DTensors laid out by the
    sharding rules on a (2, 2, 2) pod mesh, and the same on plain tensors:
    [(loss, gradient leaves)] of both, full tensors."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import params_from_arrays, recsys
    from repro_torch.models import transformer as tfm
    from repro_torch.models.gnn import build, common
    from repro_torch.models.gnn import equiformer_v2, gatedgcn, mace, pna
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import tree_leaves, tree_map

    mesh = make_local_mesh(2, 2, pod=2, device="cpu")
    dp = shr.dp_axes(mesh)

    def place(tree, specs):
        return tree_map(lambda t, s: distribute_tensor(
            t, mesh, shr.placements(s, mesh)), tree, specs,
            is_leaf=shr.is_spec)

    def both(loss, params, specs, batch, bspecs):
        plain = value_and_grad(lambda q: loss(q, batch), params)
        with implicit_replication():        # plain constants, as the dry-run
            dist = value_and_grad(lambda q: loss(q, place(batch, bspecs)),
                                  place(params, specs))
        return [(_np(v), [_np(g) for g in tree_leaves(gs)])
                for v, gs in (plain, dist)]

    if name in ("lm", "moe"):
        kw, params = ((inp["decode_cfg"], inp["decode_params"]) if name == "lm"
                      else (dict(inp["moe_cfg"], moe_groups=4),
                            inp["moe_params"]))
        cfg = tfm.TransformerConfig(**kw, dtype=torch.float32,
                                    attn_impl="dense")
        toks = torch.from_numpy(inp["toks"]).long() % cfg.vocab
        return both(lambda q, b: tfm.loss_fn(q, b, cfg)[0],
                    params_from_arrays(params), shr.lm_param_specs(cfg, mesh),
                    {"tokens": toks, "labels": torch.roll(toks, -1, 1)},
                    {"tokens": shr.P(dp, None), "labels": shr.P(dp, None)})
    if name == "wide_deep":
        rcfg = configs.get("wide_deep").smoke_config()
        p = params_from_arrays(inp["rs_params"])
        rspecs = {"tables": shr.P(None, "model", None),
                  "wide": shr.P("model"),
                  "mlp": [{"w": shr.P(), "b": shr.P()} for _ in p["mlp"]],
                  "head": shr.P(), "cand_proj": shr.P()}
        batch = {"dense": torch.from_numpy(inp["rs_dense"]),
                 "sparse": torch.from_numpy(inp["rs_sparse"]),
                 "labels": torch.from_numpy(inp["rs_labels"])}
        return both(lambda q, b: recsys.loss_fn(q, b, rcfg), p, rspecs, batch,
                    {"dense": shr.P(dp, None), "sparse": shr.P(dp, None),
                     "labels": shr.P(dp)})
    # a GNN: edges over the data axes, nodes whole, as the GNN cells
    m = {"gatedgcn": gatedgcn, "pna": pna, "mace": mace,
         "equiformer_v2": equiformer_v2}[name]
    gcfg = configs.get(name).smoke_config()
    graph = {k: torch.from_numpy(v) for k, v in inp["graph"].items()}
    feats, labels = ((("x",), "labels") if name in ("gatedgcn", "pna")
                     else (("pos", "species", "graph_id"), "energy"))

    def loss(q, b):
        g = common.GraphBatch(src=b["src"], dst=b["dst"],
                              edge_mask=b["edge_mask"],
                              n_graphs=b["energy"].shape[0],
                              **{f: b[f] for f in feats})
        return m.loss_fn(q, g, b[labels], gcfg)

    p = m.init_params(torch.Generator().manual_seed(0), gcfg)
    # ill-conditioned in fp32 in both packages: PNA's std aggregator,
    # EquiformerV2 at init
    if name in ("pna", "equiformer_v2"):
        p = tree_map(lambda t: t.double(), p)
        graph = {k: v.double() if v.is_floating_point() else v
                 for k, v in graph.items()}
    return both(loss, p, build._param_specs(p, mesh), graph,
                {k: shr.P(dp) if k in ("src", "dst", "edge_mask") else
                 shr.P(*([None] * v.ndim)) for k, v in graph.items()})


def mesh_checks(rank: int, world: int, inp: dict) -> dict:
    """Every mesh check of ``tests/test_torch_mesh.py`` in one launch; each
    rank returns its results by check name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"gcda": _gcda(inp), "regression": _regression(inp),
            "lm": _lm(inp), "retrieval": _retrieval(inp),
            "compressed_psum": _compressed_psum(rank, inp),
            "reshard": _reshard(inp), "pod": _pod(inp), "hlo": _hlo(inp),
            "pins": _pins(inp)}


def sharded_steps(rank: int, world: int, inp: dict, models) -> dict:
    """Each of ``models`` through :func:`_sharded_step`, in a launch of its
    own."""
    return {m: _sharded_step(m, inp) for m in models}
