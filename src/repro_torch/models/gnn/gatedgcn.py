"""GatedGCN [arXiv:2003.00982 benchmarking / arXiv:1711.07553] of the port:
edge-gated message passing with explicit edge features.

    e'_ij = e_ij + ReLU( BN(A h_i + B h_j + C e_ij) )
    eta_ij = sigma(e'_ij) / (sum_j sigma(e'_ij) + eps)
    h'_i  = h_i + ReLU( BN(U h_i + sum_j eta_ij * (V h_j)) )

Config (assigned): n_layers=16, d_hidden=70, gated aggregator.

Mirrors ``repro.models.gnn.gatedgcn``: the layer parameters stay stacked
over layers (so the reference's tree carries over unchanged) and the
reference's ``lax.scan`` is a Python loop over their leading axis. On
DTensors the edges run over the data axes and each product into its
rank's block of the weight's columns (over 'model'); the node products
run on each data rank's block of the nodes, gathered before the edges
read them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...distributed.sharding import (keep_batch, keep_split, on_shards,
                                     split_over, whole)
from .. import params_from_arrays  # noqa: F401  (re-exported)
from .common import GraphBatch, graph_pool, node_nll, rows_of, scatter_sum


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 0
    n_classes: int = 16
    readout: str = "node"        # "node" classification | "graph" regression


def init_params(gen: torch.Generator, cfg: GatedGCNConfig):
    L, d = cfg.n_layers, cfg.d_hidden
    dev = gen.device

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * (shape[0] ** -0.5)

    return {
        "embed_x": w(cfg.d_in, d),
        "embed_e": w(max(cfg.d_edge_in, 1), d),
        "layers": {
            "A": w(L, d, d), "B": w(L, d, d), "C": w(L, d, d),
            "U": w(L, d, d), "V": w(L, d, d),
            "ln_h": torch.ones((L, d), device=dev),
            "ln_e": torch.ones((L, d), device=dev),
        },
        "head": w(d, cfg.n_classes),
    }


def _ln(x, g):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g


def forward(params, g: GraphBatch, cfg: GatedGCNConfig):
    n = g.n_nodes
    h = _mm(g.x, params["embed_x"])
    if g.edge_attr is not None:
        e = _mm(g.edge_attr, params["embed_e"])
    else:
        e = h.new_zeros((g.n_edges, cfg.d_hidden))

    layers = params["layers"]
    for i in range(layers["A"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        # each data rank multiplies its block of the nodes, with all their
        # features, into its block of 'model' columns; the results the
        # edges read are gathered over the data axes first
        hw = split_over(whole(h), 0, ("pod", "data"))
        e = split_over(e, 0, ("pod", "data"))
        eh = keep_split(_mm(hw, lp["A"]), (1,))
        msg_src = keep_split(_mm(hw, lp["B"]), (1,))
        e = e + F.relu(_ln(rows_of(eh, g.src) + rows_of(msg_src, g.dst)
                           + _mm(keep_batch(e), lp["C"]), lp["ln_e"]))
        gate = torch.sigmoid(e)
        if g.edge_mask is not None:
            gate = gate * g.edge_mask[:, None]
        vh = rows_of(keep_split(_mm(hw, lp["V"]), (1,)), g.src)
        num = scatter_sum(gate * vh, g.dst, n)
        den = scatter_sum(gate, g.dst, n) + 1e-6
        # the nodes whole again, their features over 'model'
        h = keep_split(h + F.relu(_ln(_mm(hw, lp["U"]) + num / den,
                                      lp["ln_h"])), (1,))
    return h @ params["head"]


def _mm(x, w):
    """``x @ w``: on DTensors each rank multiplies its rows of ``x`` (all
    its features) into its block of ``w``'s columns, as the reference's
    specs split ``w``'s last dim over 'model' (``sharding.on_shards``)."""
    return on_shards(torch.mm, (x, w), (("row", None), (None, "col")),
                     ("row", "col"))


def loss_fn(params, g: GraphBatch, labels, cfg: GatedGCNConfig):
    logits = forward(params, g, cfg)
    if cfg.readout == "graph":
        pooled = graph_pool(logits, g.graph_id, g.n_graphs, g.node_mask)
        return torch.mean((pooled[:, 0] - labels) ** 2)
    return node_nll(logits, labels, g.node_mask)
