"""GNN dry-run cell builder: (arch x shape) -> train step + shape/dtype
inputs + placements.

Sharding scheme (baseline), as ``repro.models.gnn.build``:
  * edge arrays (src/dst/masks) — data-sharded (edge-parallel MP)
  * node feature/label arrays — replicated (small); with
    ``REPRO_GNN_CHANNEL_SHARD=1`` EquiformerV2 pins the channel dim of its
    irrep features to 'model'
  * params — last dim sharded over 'model' when divisible (channel TP)

The models state inside their step the layouts GSPMD gives the
reference's (see each model's docstring).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ...distributed import sharding as shr
from ...train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                tree_map)
from .common import GraphBatch

P = shr.P


def _param_specs(params_shape, mesh):
    from ...launch.specs import is_tensor_spec
    tp = shr.axis_size(mesh, "model")

    def spec(leaf):
        if leaf.ndim >= 2 and leaf.shape[-1] % tp == 0 and leaf.shape[-1] >= tp:
            return P(*([None] * (leaf.ndim - 1) + ["model"]))
        return P()

    return tree_map(spec, params_shape, is_leaf=is_tensor_spec)


def _graph_args(spec: dict, arch: str, mesh):
    """Shape/dtype batch + placements for one shape spec."""
    from ...launch.specs import TensorSpec

    dp = shr.dp_axes(mesh)
    equivariant = arch in ("mace", "equiformer_v2")
    kind = spec["kind"]
    if kind == "molecule":
        B, nn, ne = spec["batch"], spec["n_nodes"], spec["n_edges"]
        N, E = B * nn, B * ne
        n_graphs = B
    else:
        N, E = spec["n_nodes"], spec["n_edges"]
        n_graphs = 1
    E = -(-E // 512) * 512  # pad edges to a DP-shardable multiple (masked)

    f32, i32 = torch.float32, torch.int32
    rep = shr.placements(P(), mesh)
    edge = shr.placements(P(dp), mesh)
    batch = {
        "src": TensorSpec((E,), i32),
        "dst": TensorSpec((E,), i32),
        "edge_mask": TensorSpec((E,), f32),
    }
    shard = {"src": edge, "dst": edge, "edge_mask": edge}
    if equivariant:
        batch["pos"] = TensorSpec((N, 3), f32)
        batch["species"] = TensorSpec((N,), i32)
        batch["labels"] = TensorSpec((n_graphs,), f32)
        shard.update(pos=rep, species=rep, labels=rep)
        if kind == "molecule":
            batch["graph_id"] = TensorSpec((N,), i32)
            shard["graph_id"] = rep
    else:
        batch["x"] = TensorSpec((N, spec.get("d_feat", 16)), f32)
        batch["labels"] = TensorSpec((N,), i32)
        shard.update(x=rep, labels=rep)
    if kind == "minibatch":
        batch["node_mask"] = TensorSpec((N,), f32)
        shard["node_mask"] = rep
    return batch, shard, N, E, n_graphs


def build_cell(arch: str, shape_name: str, spec: dict, mesh, Cell):
    from ... import configs as configs_pkg
    from ...launch.specs import (TensorSpec, eval_shape, materialize,
                                 n_elements)
    from ...train.loop import value_and_grad

    mod = configs_pkg.get(arch)
    kind = spec["kind"]

    if arch in ("gatedgcn", "pna"):
        readout = "graph" if kind == "molecule" else "node"
        d_in = spec.get("d_feat", 16) if kind != "molecule" else 16
        cfg = mod.config(d_in=d_in, n_classes=spec.get("n_classes", 1),
                         readout=readout)
    else:
        cfg = mod.config()
        if (arch == "equiformer_v2"
                and os.environ.get("REPRO_GNN_CHANNEL_SHARD") == "1"):
            cfg = dataclasses.replace(cfg, channel_shard_axis="model")

    if arch == "gatedgcn":
        from . import gatedgcn as m
    elif arch == "pna":
        from . import pna as m
    elif arch == "mace":
        from . import mace as m
    else:
        from . import equiformer_v2 as m

    batch_args, batch_shard, N, E, n_graphs = _graph_args(spec, arch, mesh)
    if arch in ("gatedgcn", "pna") and kind == "molecule":
        # feature-GNNs on molecule cells consume random node features
        rep = shr.placements(P(), mesh)
        batch_args["x"] = TensorSpec((N, 16), torch.float32)
        batch_args["graph_id"] = TensorSpec((N,), torch.int32)
        batch_args["labels"] = TensorSpec((n_graphs,), torch.float32)
        batch_shard.update(x=rep, graph_id=rep, labels=rep)

    params_shape = eval_shape(
        lambda: m.init_params(torch.Generator().manual_seed(0), cfg))
    pspecs = _param_specs(params_shape, mesh)
    pshard = shr.tree_shardings(pspecs, mesh)
    opt_shape = eval_shape(lambda: adamw_init(materialize(params_shape)))
    ospecs = shr.opt_state_specs(pspecs, params_shape, mesh)
    oshard = shr.tree_shardings(ospecs, mesh)
    opt_cfg = AdamWConfig()
    ng = n_graphs

    def train_step(params, opt_state, batch):
        def loss(p):
            g = GraphBatch(
                src=batch["src"], dst=batch["dst"], x=batch.get("x"),
                pos=batch.get("pos"), species=batch.get("species"),
                node_mask=batch.get("node_mask"),
                edge_mask=batch.get("edge_mask"),
                graph_id=batch.get("graph_id"), n_graphs=ng)
            return m.loss_fn(p, g, batch["labels"], cfg)

        lval, grads = value_and_grad(loss, params)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, lval

    return Cell(arch, shape_name, "gnn_train", train_step,
                (params_shape, opt_shape, batch_args),
                (pshard, oshard, batch_shard), donate_argnums=(0, 1),
                meta={"n_nodes": N, "n_edges": E,
                      "n_params": n_elements(params_shape),
                      "n_graphs": ng, "fwd_bwd": True})
