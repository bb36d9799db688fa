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

``retrieval_step_distributed`` is the reference's hierarchical top-k as
a per-rank program over a ``DeviceMesh``, and ``build_cell`` the dry-run
cell builder (``launch.specs``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import take_sharded
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
    hi = _shl((_shr(a, 16) * k) & 0xFFFF, 16)
    return (lo + hi) & _M32


# ``torch.bitwise_*_shift``, not ``<<``/``>>``: DTensor gets the operators'
# scalar overloads wrong (torch 2.13), the functions right
def _shl(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bitwise_left_shift(a, n)


def _shr(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bitwise_right_shift(a, n)


def _hash_cross(sparse_idx: torch.Tensor, wide_hash: int) -> torch.Tensor:
    """Hashed pairwise cross features (field i x field i+1) -> wide ids:
    ``(a * 2654435761) ^ (b + 0x9E3779B9 + (a << 6) + (a >> 2))`` in
    uint32 (``*`` binds tighter than ``^``), modulo ``wide_hash``."""
    u = sparse_idx.long() & _M32                     # int32 -> uint32 bits
    a, b = u[:, :-1], u[:, 1:]
    h = _mul32(a, 2654435761) ^ ((b + 0x9E3779B9 + (_shl(a, 6) & _M32)
                                  + _shr(a, 2)) & _M32)
    return (h % wide_hash).to(torch.int32)


def _embed(params, sparse_idx: torch.Tensor) -> torch.Tensor:
    """(B, F, D): row ``sparse_idx[b, f]`` of table ``f``."""
    tables = params["tables"]
    fields = torch.arange(tables.shape[0], device=sparse_idx.device)
    return take_sharded(lambda t, i: t[fields[None, :], i], tables, 1,
                        sparse_idx.long())


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
    wide_logit = take_sharded(lambda t, i: t[i], params["wide"], 0,
                              cross_ids.long()).sum(-1)
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
    """Hierarchical top-k retrieval over a mesh. The candidates are bf16
    and split over ALL mesh axes (major to minor); each rank scores its
    block against the (replicated, tiny) query tower output, takes a LOCAL
    top-k, shifts its ids by its linear rank times the block size, and the
    winners of every rank are merged after one all-gather over the whole
    mesh. Ties go to the lower id, as ``lax.top_k`` gives them. Returns
    (values, ids), the same on every rank."""
    from ..distributed.sharding import (P, all_gather, axis_index,
                                        axis_names, local_block)

    q = user_tower(params, dense, sparse_idx, cfg)
    qn = (q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-9)
          ).to(torch.bfloat16)
    axes = axis_names(mesh)
    per = candidates.shape[0] // mesh.size()
    cand_l = local_block(candidates, mesh, P(axes, None))
    cn = cand_l * torch.rsqrt(
        torch.sum(cand_l.float() ** 2, -1, keepdim=True) + 1e-9
    ).to(torch.bfloat16)
    scores = qn.float() @ cn.float().T               # fp32 accumulation
    v, i = _top_k(scores, min(top_k, per))           # local winners
    i = i + axis_index(mesh, axes) * per             # global ids
    v_all = all_gather(v, mesh, axes, dim=1)
    i_all = all_gather(i, mesh, axes, dim=1)
    vg, sel = _top_k(v_all, top_k)                   # merge
    return vg, i_all.gather(1, sel)


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
    """The dry-run cell of a Wide & Deep shape (``launch.specs``): tables
    row-sharded over 'model' (or, with ``REPRO_RETRIEVAL_OPT=1`` on a
    retrieval cell, over 'model' and the data axes), dense layers
    replicated, the batch over the data axes."""
    import os

    from .. import configs as configs_pkg
    from ..distributed import sharding as shr
    from ..launch.specs import (TensorSpec, eval_shape, materialize,
                                n_elements)
    from ..train.loop import value_and_grad
    from ..train.optimizer import AdamWConfig, adamw_init, adamw_update

    P = shr.P
    cfg = configs_pkg.get(arch).config()
    dp = shr.dp_axes(mesh)
    tp = shr.axis_size(mesh, "model")
    params_shape = eval_shape(
        lambda: init_params(torch.Generator().manual_seed(0), cfg))
    dp_total = 1
    for a in dp:
        dp_total *= shr.axis_size(mesh, a)

    if (os.environ.get("REPRO_RETRIEVAL_OPT") == "1"
            and spec["kind"] == "retrieval"
            and cfg.embed_dim % dp_total == 0):
        # 2-D table sharding (vocab x embed-dim)
        tables_spec = P(None, "model", dp)
    else:
        tables_spec = P(None, "model" if cfg.vocab_per_field % tp == 0
                        else None, None)
    pspecs = {
        "tables": tables_spec,
        "wide": P("model" if cfg.wide_hash % tp == 0 else None),
        "mlp": [{"w": P(), "b": P()} for _ in params_shape["mlp"]],
        "head": P(),
        "cand_proj": P(),
    }
    pshard = shr.tree_shardings(pspecs, mesh)

    B = spec["batch"]
    f32, i32 = torch.float32, torch.int32
    dense_s = TensorSpec((B, cfg.n_dense), f32)
    sparse_s = TensorSpec((B, cfg.n_sparse), i32)
    bsh = shr.placements(P(dp, None), mesh)
    n_params = n_elements(params_shape)
    meta = {"n_params": n_params, "batch": B}

    if spec["kind"] == "train":
        opt_shape = eval_shape(lambda: adamw_init(materialize(params_shape)))
        ospecs = shr.opt_state_specs(pspecs, params_shape, mesh)
        oshard = shr.tree_shardings(ospecs, mesh)
        opt_cfg = AdamWConfig()

        def train_step(params, opt_state, batch):
            lval, grads = value_and_grad(loss_fn, params, batch, cfg)
            params, opt_state = adamw_update(grads, opt_state, params,
                                             opt_cfg)
            return params, opt_state, lval

        args = (params_shape, opt_shape,
                {"dense": dense_s, "sparse": sparse_s,
                 "labels": TensorSpec((B,), f32)})
        in_sh = (pshard, oshard,
                 {"dense": bsh, "sparse": bsh,
                  "labels": shr.placements(P(dp), mesh)})
        meta["fwd_bwd"] = True
        return Cell(arch, shape_name, "recsys_train", train_step, args, in_sh,
                    donate_argnums=(0, 1), meta=meta)

    if spec["kind"] == "retrieval":
        n_cand = spec["n_candidates"]
        if os.environ.get("REPRO_RETRIEVAL_OPT") == "1":
            n_cand = -(-n_cand // 512) * 512   # pad to a shardable multiple
            cand_s = TensorSpec((n_cand, cfg.tower_dim), torch.bfloat16)

            def retr(params, dense, sparse, cands):
                return retrieval_step_distributed(params, dense, sparse,
                                                  cands, cfg, mesh)

            cand_sh = shr.placements(P(shr.axis_names(mesh), None), mesh)
        else:
            cand_s = TensorSpec((n_cand, cfg.tower_dim), f32)

            def retr(params, dense, sparse, cands):
                return retrieval_step(params, dense, sparse, cands, cfg)

            cand_sh = shr.placements(P(dp, None), mesh)

        args = (params_shape, dense_s, sparse_s, cand_s)
        in_sh = (pshard, shr.placements(P(), mesh),
                 shr.placements(P(), mesh), cand_sh)
        meta.update({"fwd_bwd": False, "n_candidates": n_cand})
        return Cell(arch, shape_name, "recsys_retrieval", retr, args, in_sh,
                    meta=meta)

    def serve(params, dense, sparse):
        return serve_step(params, dense, sparse, cfg)

    args = (params_shape, dense_s, sparse_s)
    in_sh = (pshard, bsh, bsh)
    meta["fwd_bwd"] = False
    return Cell(arch, shape_name, "recsys_serve", serve, args, in_sh,
                meta=meta)

