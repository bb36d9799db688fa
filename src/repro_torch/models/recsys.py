"""Wide & Deep [arXiv:1606.07792] of the port — n_sparse=40 fields,
embed_dim=32, deep MLP 1024-512-256, interaction=concat, plus a
hashed-cross wide part.

Mirrors ``repro.models.recsys`` function for function, with PyTorch in
place of JAX:
  * The tables are stacked (F, V, D) and the lookup is one gather per
    field (one advanced index over the stack), as the reference's vmapped
    ``jnp.take``; the embedding-bag kernel stays on no path, as there.
    Ids must lie in [-V, V): a negative id counts from the end in both
    packages, and an id outside that range raises here where the
    reference's ``jnp.take`` returns NaN rows.
  * ``_hash_cross`` evaluates the reference's uint32 arithmetic in int64,
    masked to 32 bits after each operation that can wrap, so the wide ids
    equal the reference's bit for bit.
  * ``retrieval_step``'s top-k is a stable descending sort: on equal
    scores the lower candidate index comes first, as in ``lax.top_k``.
  * The tables' gradient is dense (F, V, D), as the reference's.
  * ``init_params(gen, cfg)`` draws from ``gen`` on ``gen.device`` (same
    shapes and scales as the reference, other random numbers);
    ``random_batch`` draws the reference's numpy batch and puts it on the
    card unless the caller names another device.

Not ported yet: ``retrieval_step_distributed`` (the sharded hierarchical
top-k) and ``build_cell`` (the mesh cell builder) wait for ROADMAP queue
1, item 11, and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import params_from_arrays  # noqa: F401  (re-exported)

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    n_dense: int = 13
    embed_dim: int = 32
    vocab_per_field: int = 1_000_000
    wide_hash: int = 1_000_000
    mlp: tuple = (1024, 512, 256)
    tower_dim: int = 256           # retrieval tower output


def init_params(gen: torch.Generator, cfg: WideDeepConfig):
    F_, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    dims = (F_ * D + cfg.n_dense,) + tuple(cfg.mlp)
    tables = normal(F_, V, D, scale=0.01)
    mlp = [{"w": normal(a, b, scale=a ** -0.5),
            "b": torch.zeros(b, device=dev)}
           for a, b in zip(dims[:-1], dims[1:])]
    return {
        "tables": tables,
        "wide": torch.zeros(cfg.wide_hash, device=dev),
        "mlp": mlp,
        "head": normal(cfg.mlp[-1], 1, scale=0.05),
        "cand_proj": normal(cfg.mlp[-1], cfg.tower_dim, scale=0.06),
    }


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k`` modulo 2**32 for int64 ``a`` in [0, 2**32): the product
    in two 16-bit halves of ``a``, so no int64 product overflows."""
    lo = (a & 0xFFFF) * k
    hi = (((a >> 16) * k) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_cross(sparse_idx: torch.Tensor, wide_hash: int) -> torch.Tensor:
    """Hashed pairwise cross features (field i x field i+1) -> wide ids:
    ``(a * 2654435761) ^ (b + 0x9E3779B9 + (a << 6) + (a >> 2))`` in
    uint32 (``*`` binds tighter than ``^``), modulo ``wide_hash``."""
    u = sparse_idx.long() & _M32                     # int32 -> uint32 bits
    a, b = u[:, :-1], u[:, 1:]
    h = _mul32(a, 2654435761) ^ ((b + 0x9E3779B9 + ((a << 6) & _M32)
                                  + (a >> 2)) & _M32)
    return (h % wide_hash).to(torch.int32)


def _embed(params, sparse_idx: torch.Tensor) -> torch.Tensor:
    """(B, F, D): row ``sparse_idx[b, f]`` of table ``f``."""
    tables = params["tables"]
    fields = torch.arange(tables.shape[0], device=sparse_idx.device)
    return tables[fields[None, :], sparse_idx.long()]


def _deep(params, dense, sparse_idx) -> torch.Tensor:
    B = sparse_idx.shape[0]
    h = torch.cat([_embed(params, sparse_idx).reshape(B, -1), dense], -1)
    for lyr in params["mlp"]:
        h = F.relu(h @ lyr["w"] + lyr["b"])
    return h


def forward(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
            cfg: WideDeepConfig) -> torch.Tensor:
    """dense: (B, n_dense) float; sparse_idx: (B, F) int. Returns logits."""
    deep_logit = (_deep(params, dense, sparse_idx) @ params["head"])[:, 0]
    cross_ids = _hash_cross(sparse_idx, cfg.wide_hash)      # (B, F-1)
    wide_logit = params["wide"][cross_ids.long()].sum(-1)
    return deep_logit + wide_logit


def user_tower(params, dense, sparse_idx, cfg) -> torch.Tensor:
    return _deep(params, dense, sparse_idx) @ params["cand_proj"]


def loss_fn(params, batch, cfg: WideDeepConfig):
    logits = forward(params, batch["dense"], batch["sparse"], cfg)
    y = batch["labels"]
    return torch.mean(F.softplus(logits) - y * logits)     # logistic loss


def serve_step(params, dense, sparse_idx, cfg: WideDeepConfig):
    return torch.sigmoid(forward(params, dense, sparse_idx, cfg))


def _top_k(scores: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: (values, indices), descending,
    the lower index first on equal values (a stable sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def retrieval_step(params, dense, sparse_idx, candidates, cfg: WideDeepConfig,
                   top_k: int = 100):
    """Score one query batch against (n_cand, tower_dim) candidates with a
    single batched dot (the SIMILARITY GCDA pattern) + top-k."""
    q = user_tower(params, dense, sparse_idx, cfg)          # (B, T)
    qn = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-9)
    cn = candidates * torch.rsqrt(
        torch.sum(candidates * candidates, -1, keepdim=True) + 1e-9)
    return _top_k(qn @ cn.T, top_k)                         # (B, n_cand)


def retrieval_step_distributed(params, dense, sparse_idx, candidates,
                               cfg: WideDeepConfig, mesh, top_k: int = 100):
    raise NotImplementedError(
        "retrieval_step_distributed (the sharded hierarchical top-k) is not "
        "ported yet (ROADMAP queue 1, item 11)")


# ---------------------------------------------------------------------------
# Synthetic batch pipeline
# ---------------------------------------------------------------------------


def random_batch(cfg: WideDeepConfig, batch: int, seed: int = 0,
                 device=None):
    """The reference's batch (the same numpy draws) on ``device``: the
    card unless the caller names another (``core.engine.resolve_device``;
    without a card and without a device this raises)."""
    from ..core.engine import resolve_device
    dev = resolve_device(device, "recsys.random_batch")
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch, cfg.n_dense))
    sparse = rng.integers(0, cfg.vocab_per_field, (batch, cfg.n_sparse))
    labels = rng.integers(0, 2, batch)
    return {
        "dense": torch.as_tensor(dense, dtype=torch.float32, device=dev),
        "sparse": torch.as_tensor(sparse.astype(np.int32), device=dev),
        "labels": torch.as_tensor(labels, dtype=torch.float32, device=dev),
    }


def build_cell(arch: str, shape_name: str, spec: dict, mesh, Cell):
    raise NotImplementedError(
        f"build_cell ({arch}/{shape_name}, the mesh cell builder) is not "
        "ported yet (ROADMAP queue 1, item 11)")
