"""wide-deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat; tables 1M rows/field (row-sharded over 'model')."""
from ..models.recsys import WideDeepConfig

FAMILY = "recsys"

SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}


def config() -> WideDeepConfig:
    return WideDeepConfig()


def smoke_config() -> WideDeepConfig:
    return WideDeepConfig(name="wide-deep-smoke", n_sparse=6, n_dense=4,
                          embed_dim=8, vocab_per_field=1000, wide_hash=512,
                          mlp=(32, 16), tower_dim=16)
