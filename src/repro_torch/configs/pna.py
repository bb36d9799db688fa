"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75, aggregators
mean-max-min-std, scalers id-amp-atten."""
from ..models.gnn.pna import PNAConfig
from .gnn_shapes import GNN_SHAPES

FAMILY = "gnn"
SHAPES = GNN_SHAPES


def config(d_in: int = 1433, n_classes: int = 7,
           readout: str = "node") -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_in,
                     n_classes=n_classes, readout=readout)


def smoke_config() -> PNAConfig:
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=12, d_in=24,
                     n_classes=4)
