"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718] of the
port: 4 aggregators (mean/max/min/std) x 3 scalers (identity/
amplification/attenuation) -> 12-way concat -> linear, with a pairwise
message MLP.

Config (assigned): n_layers=4, d_hidden=75, aggregators mean-max-min-std,
scalers id-amp-atten. Mirrors ``repro.models.gnn.pna``. On DTensors the
update contracts each data rank's block of its 13d inputs (``_update``),
as GSPMD splits the reference's update on one pod.
"""
from __future__ import annotations

import dataclasses

import torch

from ...distributed.sharding import keep_split, on_shards, split_over
from .. import params_from_arrays  # noqa: F401  (re-exported)
from .common import (GraphBatch, degrees, graph_pool, mlp_apply, mlp_params,
                     node_nll, rows_of, scatter_max, scatter_mean,
                     scatter_min)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 16
    avg_log_deg: float = 2.3      # normalizing constant (dataset statistic)
    readout: str = "node"


def init_params(gen: torch.Generator, cfg: PNAConfig):
    d = cfg.d_hidden
    dev = gen.device
    layers = [{"msg": mlp_params(gen, [2 * d, d, d]),
               "upd": mlp_params(gen, [12 * d + d, d]),
               "ln": torch.ones(d, device=dev)}
              for _ in range(cfg.n_layers)]
    return {
        "embed": torch.randn((cfg.d_in, d), generator=gen, device=dev)
        * cfg.d_in ** -0.5,
        "layers": layers,     # list (heterogeneous MLPs) — python loop
        "head": torch.randn((d, cfg.n_classes), generator=gen, device=dev)
        * d ** -0.5,
    }


def _update(upd, x):
    """``mlp_apply(upd, x)`` of the one-layer update on (N, 13d). On
    DTensors each rank contracts its data block of ``x``'s features with
    the same rows of its block of the weight's columns (split over
    'model', as the reference's specs split it), and the partial sums are
    reduced over the data axes at once (``sharding.on_shards``): the
    nodes stay whole, and no rank runs the whole product."""
    (lyr,) = upd
    dp = ("pod", "data")
    # pinned twice: the gradient's partial sums over 'model' are reduced
    # on each data rank's block, before the blocks are gathered
    x = keep_split(split_over(keep_split(x, ()), 1, dp), (1,))
    w = split_over(lyr["w"], 0, dp)
    return keep_split(on_shards(torch.mm, (x, w), ((None, "k"), ("k", "col")),
                                (None, "col")), (1,)) + lyr["b"]


def forward(params, g: GraphBatch, cfg: PNAConfig):
    n = g.n_nodes
    h = g.x @ params["embed"]
    deg = degrees(g.dst, n, g.edge_mask)
    log_deg = torch.log(deg + 1.0)[:, None]
    amp = log_deg / cfg.avg_log_deg
    att = cfg.avg_log_deg / torch.clamp(log_deg, min=1e-6)
    has = deg[:, None] > 0

    for lp in params["layers"]:
        m = mlp_apply(lp["msg"], torch.cat([rows_of(h, g.src),
                                            rows_of(h, g.dst)], -1))
        if g.edge_mask is not None:
            m = m * g.edge_mask[:, None]
        mean = scatter_mean(m, g.dst, n)
        mx = torch.where(has, torch.maximum(scatter_max(m, g.dst, n),
                                            m.new_tensor(-1e30)), 0.0)
        mn = torch.where(has, torch.minimum(scatter_min(m, g.dst, n),
                                            m.new_tensor(1e30)), 0.0)
        var = scatter_mean(m * m, g.dst, n) - mean * mean
        # torch.maximum, not clamp: at var == 0 (a single message) both
        # split the gradient evenly between the two sides, as jnp.maximum
        std = torch.sqrt(torch.maximum(var, var.new_tensor(0.0)) + 1e-10)
        aggs = torch.cat([mean, mx, mn, std], -1)                   # (N, 4d)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], -1)      # 12d
        h = h + _update(lp["upd"], torch.cat([h, scaled], -1))
        h = (h - torch.mean(h, -1, keepdim=True)) * torch.rsqrt(
            torch.var(h, -1, keepdim=True, correction=0) + 1e-5) * lp["ln"]
    return h @ params["head"]


def loss_fn(params, g: GraphBatch, labels, cfg: PNAConfig):
    logits = forward(params, g, cfg)
    if cfg.readout == "graph":
        pooled = graph_pool(logits, g.graph_id, g.n_graphs, g.node_mask)
        return torch.mean((pooled[:, 0] - labels) ** 2)
    return node_nll(logits, labels, g.node_mask)
