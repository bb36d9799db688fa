"""gatedgcn [arXiv:2003.00982]: n_layers=16 d_hidden=70 gated aggregator."""
from ..models.gnn.gatedgcn import GatedGCNConfig
from .gnn_shapes import GNN_SHAPES

FAMILY = "gnn"
SHAPES = GNN_SHAPES


def config(d_in: int = 1433, n_classes: int = 7,
           readout: str = "node") -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70,
                          d_in=d_in, n_classes=n_classes, readout=readout)


def smoke_config() -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn-smoke", n_layers=2, d_hidden=16,
                          d_in=24, n_classes=4)
