"""equiformer-v2 [arXiv:2306.12059]: n_layers=12 d_hidden=128 l_max=6
m_max=2 n_heads=8, SO(2)-eSCN equivariant graph attention."""
from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .gnn_shapes import GNN_SHAPES

FAMILY = "gnn"
SHAPES = GNN_SHAPES


def config() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2", n_layers=12,
                              channels=128, l_max=6, m_max=2, n_heads=8)


def smoke_config() -> EquiformerV2Config:
    return EquiformerV2Config(name="eqv2-smoke", n_layers=2, channels=8,
                              l_max=3, m_max=2, n_heads=4, n_species=8)
