"""DCN-v2 [arXiv:2008.13535] of the port — extra (non-assigned) pool
architecture: explicit low-rank cross network + deep tower over sparse
embeddings.

    x_{l+1} = x_0 * (U_l (V_l^T x_l) + b_l) + x_l

Mirrors ``repro.models.dcn_v2``; the per-field lookup is recsys's (one
advanced index over the stacked tables: an id outside [-V, V) raises where
the reference's ``jnp.take`` returns NaN rows). ``init_params(gen, cfg)``
draws from ``gen`` on ``gen.device``; ``random_batch`` draws the
reference's numpy batch onto the card unless the caller names another
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import params_from_arrays  # noqa: F401  (re-exported)
from .recsys import _embed


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_sparse: int = 26
    n_dense: int = 13
    embed_dim: int = 16
    vocab_per_field: int = 100_000
    n_cross: int = 3
    cross_rank: int = 64
    mlp: tuple = (256, 128)


def init_params(gen: torch.Generator, cfg: DCNv2Config):
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    d0 = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    cross = [{"U": normal(d0, cfg.cross_rank, scale=d0 ** -0.5),
              "V": normal(d0, cfg.cross_rank, scale=d0 ** -0.5),
              "b": torch.zeros(d0, device=dev)}
             for _ in range(cfg.n_cross)]
    dims = (d0,) + tuple(cfg.mlp)
    mlp = [{"w": normal(a, b, scale=a ** -0.5), "b": torch.zeros(b, device=dev)}
           for a, b in zip(dims[:-1], dims[1:])]
    return {
        "tables": normal(cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim,
                         scale=0.01),
        "cross": cross,
        "mlp": mlp,
        "head": normal(cfg.mlp[-1] + d0, 1, scale=0.05),
    }


def forward(params, dense, sparse_idx, cfg: DCNv2Config):
    B = sparse_idx.shape[0]
    x0 = torch.cat([_embed(params, sparse_idx).reshape(B, -1), dense], -1)
    x = x0
    for cp in params["cross"]:
        x = x0 * ((x @ cp["V"]) @ cp["U"].T + cp["b"]) + x
    h = x0
    for lyr in params["mlp"]:
        h = F.relu(h @ lyr["w"] + lyr["b"])
    return (torch.cat([x, h], -1) @ params["head"])[:, 0]


def loss_fn(params, batch, cfg: DCNv2Config):
    logits = forward(params, batch["dense"], batch["sparse"], cfg)
    y = batch["labels"]
    return torch.mean(F.softplus(logits) - y * logits)


def random_batch(cfg: DCNv2Config, batch: int, seed: int = 0, device=None):
    """The reference's batch (the same numpy draws) on ``device``: the
    card unless the caller names another (``core.engine.resolve_device``)."""
    from ..core.engine import resolve_device
    dev = resolve_device(device, "dcn_v2.random_batch")
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch, cfg.n_dense))
    sparse = rng.integers(0, cfg.vocab_per_field, (batch, cfg.n_sparse))
    labels = rng.integers(0, 2, batch)
    return {
        "dense": torch.as_tensor(dense, dtype=torch.float32, device=dev),
        "sparse": torch.as_tensor(sparse.astype(np.int32), device=dev),
        "labels": torch.as_tensor(labels, dtype=torch.float32, device=dev),
    }
