"""Shared GNN-family shape set (assigned).

* full_graph_sm — Cora-scale full-batch (2708 nodes / 10556 edges / 1433 f)
* minibatch_lg  — Reddit-scale (232 965 nodes / 114.6M edges) with a REAL
  fanout-(15,10) neighbor sampler over 1024 seed nodes; the dry-run lowers
  the train step on the sampler's padded static output shapes:
  nodes <= 1024*(1+15+15*10) = 169 984, edges <= 1024*15+15 360*10 = 168 960.
* ogb_products  — full-batch-large (2 449 029 nodes / 61 859 140 edges / 100 f)
* molecule      — batch=128 of 30-node/64-edge graphs (flattened: 3840/8192)

For the equivariant archs (mace, equiformer-v2) node inputs are positions +
species; the d_feat column sets of the citation-graph shapes are unused by
those archs (noted in DESIGN.md §Arch-applicability).
"""

FANOUT = (15, 10)
MB_SEEDS = 1024
MB_NODES = MB_SEEDS * (1 + FANOUT[0] + FANOUT[0] * FANOUT[1])
MB_EDGES = MB_SEEDS * FANOUT[0] + MB_SEEDS * FANOUT[0] * FANOUT[1]

GNN_SHAPES = {
    "full_graph_sm": {"kind": "full_graph", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7},
    "minibatch_lg": {"kind": "minibatch", "n_nodes": MB_NODES,
                     "n_edges": MB_EDGES, "d_feat": 602, "n_classes": 41,
                     "global_nodes": 232965, "global_edges": 114615892,
                     "batch_nodes": MB_SEEDS, "fanout": FANOUT},
    "ogb_products": {"kind": "full_graph", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    "molecule": {"kind": "molecule", "n_nodes": 30, "n_edges": 64,
                 "batch": 128},
}
