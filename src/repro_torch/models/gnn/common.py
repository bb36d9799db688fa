"""Shared GNN substrate of the port: message passing via segment
reductions over an edge index, graph batch containers, and degree
utilities. Mirrors ``repro.models.gnn.common``:
  * ``scatter_sum`` is an out-of-place ``index_add`` on fresh zeros. On the
    card it adds in no fixed order, so results there agree with the CPU
    within a tolerance, never bit for bit, and do not repeat bit for bit.
  * ``scatter_max``/``scatter_min`` are ``scatter_reduce`` with
    ``include_self=False`` over a tensor filled with -inf/+inf, so an empty
    segment gives -inf/+inf as ``segment_max``/``segment_min`` do; their
    gradient splits evenly among tied maxima (minima), as JAX's does. On
    DTensors with the edges split, each rank reduces its edges and the
    ranks' results are reduced in turn (``sharding.scatter_extremum``);
    ``scatter_sum`` and ``rows_of`` (the nodes' rows at an edge index) run
    on each rank's edges too, so no DTensor scatter or gather runs.
  * ``mlp_params(gen, dims)`` draws from ``gen`` on ``gen.device``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ...distributed.sharding import (keep_split, on_shards, scatter_extremum,
                                     take_sharded)

Pytree = dict

_FIELDS = ("src", "dst", "x", "edge_attr", "pos", "species", "node_mask",
           "edge_mask", "graph_id")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Static-shape (padded) graph batch.
    x: (N, F) node features; edge_index src/dst: (E,); edge_attr: (E, Fe);
    node_mask/edge_mask: validity; graph_id: (N,) for pooled readout over
    G graphs (batched small molecules); pos: (N, 3) for equivariant nets."""
    src: torch.Tensor
    dst: torch.Tensor
    x: Optional[torch.Tensor] = None
    edge_attr: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    species: Optional[torch.Tensor] = None
    node_mask: Optional[torch.Tensor] = None
    edge_mask: Optional[torch.Tensor] = None
    graph_id: Optional[torch.Tensor] = None
    n_graphs: int = 1

    @property
    def n_nodes(self) -> int:
        for a in (self.x, self.pos, self.species):
            if a is not None:
                return a.shape[0]
        raise ValueError("empty batch")

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "GraphBatch":
        """The batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _FIELDS
            if getattr(self, f) is not None})


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int
                ) -> torch.Tensor:
    def add(m, d):
        return m.new_zeros((n_nodes,) + tuple(m.shape[1:])).index_add(0, d, m)

    # on DTensors each rank adds its edges: the nodes' partial sums
    rows = tuple(f"dim{i}" for i in range(1, messages.dim()))
    out = on_shards(add, (messages, dst), (("edge",) + rows, ("edge",)),
                    (None,) + rows)
    return keep_split(out, range(1, messages.dim()))


def rows_of(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]``: the rows of the nodes ``index`` names (on DTensors a
    local gather per rank, ``sharding.take_sharded``)."""
    return take_sharded(lambda a, i: a[i], t, 0, index)


def _scatter_extremum(messages, dst, n_nodes, reduce, fill):
    def scatter(m, d):
        out = m.new_full((n_nodes,) + tuple(m.shape[1:]), fill)
        idx = d.view((-1,) + (1,) * (m.dim() - 1))
        return out.scatter_reduce(0, idx.expand_as(m), m, reduce,
                                  include_self=False)

    return scatter_extremum(scatter, messages, dst.long(), reduce)


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int
                ) -> torch.Tensor:
    return _scatter_extremum(messages, dst, n_nodes, "amax", float("-inf"))


def scatter_min(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int
                ) -> torch.Tensor:
    return _scatter_extremum(messages, dst, n_nodes, "amin", float("inf"))


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(messages, dst, n_nodes)
    cnt = scatter_sum(messages.new_ones((messages.shape[0], 1)), dst, n_nodes)
    return s / (cnt + eps)


def scatter_softmax(scores: torch.Tensor, dst: torch.Tensor, n_nodes: int
                    ) -> torch.Tensor:
    """Edge softmax: normalize scores over incoming edges of each dst node.
    scores: (E, H)."""
    smax = scatter_max(scores, dst, n_nodes)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - rows_of(smax, dst))
    denom = scatter_sum(ex, dst, n_nodes)
    return ex / (rows_of(denom, dst) + 1e-16)


def degrees(dst: torch.Tensor, n_nodes: int, edge_mask=None) -> torch.Tensor:
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    if edge_mask is not None:
        ones = ones * edge_mask
    return scatter_sum(ones, dst, n_nodes)


def graph_pool(x: torch.Tensor, graph_id: torch.Tensor, n_graphs: int,
               node_mask=None, mode: str = "sum") -> torch.Tensor:
    if node_mask is not None:
        x = x * node_mask[:, None]
    if mode == "sum":
        return scatter_sum(x, graph_id, n_graphs)
    if mode == "mean":
        s = scatter_sum(x, graph_id, n_graphs)
        c = scatter_sum(node_mask if node_mask is not None
                        else x.new_ones(x.shape[0]), graph_id, n_graphs)
        return s / torch.clamp(c, min=1)[:, None]
    raise ValueError(mode)


def mlp_params(gen: torch.Generator, dims, name=""):
    dev = gen.device
    return [{"w": torch.randn((a, b), generator=gen, device=dev,
                              dtype=torch.float32) * (a ** -0.5),
             "b": torch.zeros(b, device=dev)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(layers, x, act=F.relu, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def node_nll(logits: torch.Tensor, labels: torch.Tensor, node_mask=None
             ) -> torch.Tensor:
    """Mean cross-entropy over the nodes with a label >= 0 (and a set
    ``node_mask``): the node-classification loss of gatedgcn, pna and gat.
    A label of -1 (every sampled node that is not a seed) is gathered at
    class 0 and masked out: the reference's ``take_along_axis`` wraps it
    and its mask zeroes the term; torch's gather would raise on it."""
    logz = torch.logsumexp(logits, -1)
    gold = take_sharded(lambda t, i: torch.gather(t, -1, i), logits, -1,
                        labels.long().clamp(min=0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    if node_mask is not None:
        mask = mask * node_mask
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1)
