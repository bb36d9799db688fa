"""Graph data pipeline of the port: synthetic generators for the assigned
shapes and a REAL fanout neighbor sampler (the minibatch_lg regime)
producing padded static-shape subgraphs.

Mirrors ``repro.data.graphs``: every generator makes the reference's numpy
draws, in its order, and puts the result on ``device``, the card unless
the caller names another (``core.engine.resolve_device``; without a card
and without a device this raises). The sampler stays numpy on the host,
over the port's ``core.storage.build_csr``, and draws from its numpy
``Generator`` in the reference's order, so its subgraphs equal the
reference's bit for bit; ``sample`` builds the batch on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine import resolve_device
from ..core.storage import build_csr
from ..models.gnn.common import GraphBatch


def _on(device, who):
    dev = resolve_device(device, who)
    return lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=dev)


def random_feature_graph(n_nodes: int, n_edges: int, d_feat: int,
                         n_classes: int, seed: int = 0, device=None
                         ) -> tuple[GraphBatch, torch.Tensor]:
    """Citation-style graph: features + node labels (full-batch)."""
    t = _on(device, "graphs.random_feature_graph")
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    x = rng.standard_normal((n_nodes, d_feat)).astype(np.float32) * 0.2
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    g = GraphBatch(src=t(src, torch.int32), dst=t(dst, torch.int32), x=t(x))
    return g, t(labels)


def random_molecule_batch(batch: int, n_nodes: int, n_edges: int,
                          n_species: int = 16, seed: int = 0, device=None
                          ) -> tuple[GraphBatch, torch.Tensor]:
    """Batched small 3D graphs (flattened with graph_id) + energy labels."""
    t = _on(device, "graphs.random_molecule_batch")
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    pos = rng.standard_normal((N, 3)).astype(np.float32) * 1.5
    species = rng.integers(0, n_species, N).astype(np.int32)
    # intra-graph edges, no self loops
    s_loc = rng.integers(0, n_nodes, E)
    d_off = rng.integers(1, n_nodes, E)
    d_loc = (s_loc + d_off) % n_nodes
    gidx = np.repeat(np.arange(batch), n_edges)
    src = (gidx * n_nodes + s_loc).astype(np.int32)
    dst = (gidx * n_nodes + d_loc).astype(np.int32)
    graph_id = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    energies = rng.standard_normal(batch).astype(np.float32)
    g = GraphBatch(src=t(src), dst=t(dst), pos=t(pos), species=t(species),
                   graph_id=t(graph_id), n_graphs=batch)
    return g, t(energies)


def random_geometric_graph(n_nodes: int, n_edges: int, n_species: int = 16,
                           seed: int = 0, device=None
                           ) -> tuple[GraphBatch, torch.Tensor]:
    """Single large 3D point cloud (equivariant archs on graph shapes)."""
    t = _on(device, "graphs.random_geometric_graph")
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n_nodes, 3)).astype(np.float32) * 3
    species = rng.integers(0, n_species, n_nodes).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = ((src + rng.integers(1, n_nodes, n_edges)) % n_nodes).astype(np.int32)
    g = GraphBatch(src=t(src), dst=t(dst), pos=t(pos), species=t(species),
                   n_graphs=1)
    return g, t(np.zeros((1,), np.float32))


# ---------------------------------------------------------------------------
# Neighbor sampler (minibatch_lg): real fanout sampling over CSR
# ---------------------------------------------------------------------------


class NeighborSampler:
    """GraphSAGE-style fanout sampler. Produces padded, static-shape
    subgraphs: at fanouts (f1, f2) and S seeds the outputs are always
    (S*(1+f1+f1*f2)) nodes and (S*f1 + S*f1*f2) edges with validity masks.
    Host numpy; ``sample`` puts the batch on its ``device``."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray,
                 x: np.ndarray, labels: np.ndarray, fanouts=(15, 10),
                 seed: int = 0):
        self.csr = build_csr(n_nodes, dst, src)  # sample in-neighbors
        self.n_nodes = n_nodes
        self.x = x
        self.labels = labels
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_layer(self, frontier: np.ndarray, fanout: int):
        """For each frontier node sample <= fanout in-neighbors (with
        replacement, random offsets modulo the degree), padded to exactly
        fanout with -1."""
        deg = (self.csr.row_ptr[frontier + 1]
               - self.csr.row_ptr[frontier]).astype(np.int64)
        out = np.full((len(frontier), fanout), -1, dtype=np.int64)
        r = self.rng.integers(0, 1 << 62, size=(len(frontier), fanout))
        has = deg > 0
        offs = r[has] % deg[has, None]
        out[has] = self.csr.col_idx[self.csr.row_ptr[frontier[has], None]
                                    + offs]
        return out

    def sample(self, seeds: np.ndarray, device=None
               ) -> tuple[GraphBatch, torch.Tensor]:
        t = _on(device, "NeighborSampler.sample")
        S = len(seeds)
        f1, f2 = self.fanouts
        l1 = self._sample_layer(seeds, f1)                 # (S, f1)
        l1_flat = l1.reshape(-1)
        l1_safe = np.maximum(l1_flat, 0)
        l2 = self._sample_layer(l1_safe, f2)               # (S*f1, f2)
        l2[l1_flat < 0] = -1
        l2_flat = l2.reshape(-1)

        # node table: [seeds | l1 | l2] with padding
        all_nodes = np.concatenate([seeds, l1_flat, l2_flat])
        node_mask = (all_nodes >= 0).astype(np.float32)
        safe_nodes = np.maximum(all_nodes, 0)

        # edges: l1[i,j] -> seed i ; l2[e,j] -> l1-node e
        src1 = S + np.arange(S * f1)
        dst1 = np.repeat(np.arange(S), f1)
        m1 = l1_flat >= 0
        src2 = S + S * f1 + np.arange(S * f1 * f2)
        dst2 = S + np.repeat(np.arange(S * f1), f2)
        m2 = l2_flat >= 0
        src = np.concatenate([src1, src2]).astype(np.int32)
        dst = np.concatenate([dst1, dst2]).astype(np.int32)
        edge_mask = np.concatenate([m1, m2]).astype(np.float32)

        x = self.x[safe_nodes].astype(np.float32) * node_mask[:, None]
        labels = np.where(all_nodes >= 0, self.labels[safe_nodes], -1)
        # only seeds carry supervised labels
        labels[S:] = -1
        g = GraphBatch(src=t(src), dst=t(dst), x=t(x),
                       node_mask=t(node_mask), edge_mask=t(edge_mask))
        return g, t(labels.astype(np.int32))
