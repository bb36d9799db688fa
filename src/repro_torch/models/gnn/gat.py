"""GAT / GATv2 [arXiv:1710.10903 / arXiv:2105.14491] of the port — extra
(non-assigned) pool architecture exercising the SDDMM -> edge-softmax ->
SpMM regime.

    e_ij = LeakyReLU(a^T [W h_i || W h_j])        (GAT)
    e_ij = a^T LeakyReLU(W [h_i || h_j])          (GATv2)
    alpha = edge_softmax(e); h'_i = ||_heads sum_j alpha_ij W h_j

Mirrors ``repro.models.gnn.gat``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import params_from_arrays  # noqa: F401  (re-exported)
from .common import (GraphBatch, node_nll, rows_of, scatter_softmax,
                     scatter_sum)


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 3
    d_hidden: int = 64
    n_heads: int = 4
    d_in: int = 1433
    n_classes: int = 7
    v2: bool = True
    negative_slope: float = 0.2


def init_params(gen: torch.Generator, cfg: GATConfig):
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.d_hidden // cfg.n_heads
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    d_prev = cfg.d_hidden
    layers = [{"W": normal(d_prev, H, dh, scale=d_prev ** -0.5),
               "a_src": normal(H, dh, scale=dh ** -0.5),
               "a_dst": normal(H, dh, scale=dh ** -0.5)}
              for _ in range(L)]
    return {"embed": normal(cfg.d_in, cfg.d_hidden, scale=cfg.d_in ** -0.5),
            "layers": layers,
            "head": normal(cfg.d_hidden, cfg.n_classes,
                           scale=cfg.d_hidden ** -0.5)}


def forward(params, g: GraphBatch, cfg: GATConfig):
    n = g.n_nodes
    H, dh = cfg.n_heads, cfg.d_hidden // cfg.n_heads
    h = g.x @ params["embed"]
    slope = cfg.negative_slope
    for lp in params["layers"]:
        hw = torch.einsum("nd,dhe->nhe", h, lp["W"])        # (N, H, dh)
        if cfg.v2:
            z = rows_of(hw, g.src) + rows_of(hw, g.dst)        # (E, H, dh)
            scores = torch.einsum("ehd,hd->eh", F.leaky_relu(z, slope),
                                  lp["a_src"])
        else:
            s_src = torch.einsum("nhe,he->nh", hw, lp["a_src"])
            s_dst = torch.einsum("nhe,he->nh", hw, lp["a_dst"])
            scores = F.leaky_relu(rows_of(s_src, g.src)
                                  + rows_of(s_dst, g.dst), slope)
        if g.edge_mask is not None:
            scores = torch.where(g.edge_mask[:, None] > 0, scores, -1e30)
        alpha = scatter_softmax(scores, g.dst, n)            # (E, H)
        msg = rows_of(hw, g.src) * alpha[..., None]
        agg = scatter_sum(msg.reshape(-1, H * dh), g.dst, n)
        h = F.elu(agg) + h
    return h @ params["head"]


def loss_fn(params, g: GraphBatch, labels, cfg: GATConfig):
    return node_nll(forward(params, g, cfg), labels, g.node_mask)
