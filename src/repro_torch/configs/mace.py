"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant ACE message passing."""
from ..models.gnn.mace import MACEConfig
from .gnn_shapes import GNN_SHAPES

FAMILY = "gnn"
SHAPES = GNN_SHAPES


def config() -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, channels=128, l_max=2,
                      correlation=3, n_rbf=8)


def smoke_config() -> MACEConfig:
    return MACEConfig(name="mace-smoke", n_layers=1, channels=8, l_max=2,
                      correlation=3, n_rbf=4, n_species=8)
