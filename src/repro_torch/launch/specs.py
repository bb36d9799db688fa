"""Per-cell step builders and shape/dtype input records for the dry-run.

``build_cell(arch, shape_name, mesh)`` returns a ``Cell`` with:
  * ``fn``            — the step function to trace (train_step /
                         prefill_step / serve_step / gnn_train_step /
                         recsys steps / the GCDA steps)
  * ``in_shardings``  — tree of DTensor placements matching ``args``
  * ``args``          — tree of :class:`TensorSpec` shape/dtype records
                         (the counterpart of ``jax.ShapeDtypeStruct``;
                         never allocated)
  * ``meta``          — flops/bytes accounting inputs

Mirrors ``repro.launch.specs``. The ``REPRO_MOE_EP``,
``REPRO_MOE_SHARDMAP``, ``REPRO_KV_SEQ_SHARD``, ``REPRO_RETRIEVAL_OPT`` and
``REPRO_GNN_CHANNEL_SHARD`` variants are read as there.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, NamedTuple

import torch

from .. import configs as configs_pkg
from ..distributed import sharding as shr
from ..train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_map)

Tree = Any
P = shr.P


class TensorSpec(NamedTuple):
    """Shape and dtype of an argument that is never allocated."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def is_tensor_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def eval_shape(fn: Callable) -> Tree:
    """The :class:`TensorSpec` tree of ``fn()``'s tensors, from a run on
    fake tensors (nothing is allocated), as ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = fn()
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), out,
                    is_leaf=is_tensor_spec)


def materialize(tree: Tree, device=None) -> Tree:
    """Empty tensors of a :class:`TensorSpec` tree (fake ones under a
    ``FakeTensorMode``)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device),
                    tree, is_leaf=is_tensor_spec)


def n_elements(tree: Tree) -> int:
    return sum(math.prod(t.shape)
               for t in tree_leaves(tree, is_leaf=is_tensor_spec))


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    donate_argnums: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(arch: str, shape_name: str, spec: dict, mesh,
             layers: int | None = None) -> Cell:
    from ..models import transformer as tfm
    from ..train.loop import value_and_grad

    mod = configs_pkg.get(arch)
    cfg = mod.config()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    B, S = spec["batch"], spec["seq"]
    dp = shr.dp_axes(mesh)
    dp_total = math.prod(shr.axis_size(mesh, a) for a in dp)
    if cfg.is_moe:
        # dispatch groups == DP shards: top-k sort + capacity are shard-local
        cfg = dataclasses.replace(cfg, moe_groups=min(dp_total, B))
        if os.environ.get("REPRO_MOE_EP") == "1":
            cfg = dataclasses.replace(cfg, mesh=mesh, mesh_dp=tuple(dp),
                                      moe_ep_axis="model")
        if os.environ.get("REPRO_MOE_SHARDMAP") == "1":
            cfg = dataclasses.replace(cfg, mesh=mesh, mesh_dp=tuple(dp),
                                      moe_ep_axis="model",
                                      moe_impl="shard_map")

    params_shape = eval_shape(
        lambda: tfm.init_params(torch.Generator().manual_seed(0), cfg))
    pspecs = shr.lm_param_specs(cfg, mesh)
    pshard = shr.tree_shardings(pspecs, mesh)
    batch_sh = shr.placements(P(dp, None), mesh)
    i32 = torch.int32

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()

    if spec["kind"] == "train":
        opt_shape = eval_shape(lambda: adamw_init(materialize(params_shape)))
        ospecs = shr.opt_state_specs(pspecs, params_shape, mesh)
        oshard = shr.tree_shardings(ospecs, mesh)
        opt_cfg = AdamWConfig()

        def train_step(params, opt_state, batch):
            (loss, nll), grads = value_and_grad(
                lambda p: tfm.loss_fn(p, batch, cfg), params, has_aux=True)
            params, opt_state = adamw_update(grads, opt_state, params,
                                             opt_cfg)
            return params, opt_state, {"loss": loss, "nll": nll}

        args = (params_shape, opt_shape,
                {"tokens": TensorSpec((B, S), i32),
                 "labels": TensorSpec((B, S), i32)})
        in_sh = (pshard, oshard, {"tokens": batch_sh, "labels": batch_sh})
        return Cell(arch, shape_name, "train", train_step, args, in_sh,
                    donate_argnums=(0, 1),
                    meta={"tokens": B * S, "n_params": n_params,
                          "n_active": n_active, "fwd_bwd": True,
                          "layers": cfg.n_layers})

    kv_seq_shard = (os.environ.get("REPRO_KV_SEQ_SHARD") == "1"
                    and spec["kind"] == "decode")
    if kv_seq_shard:
        cfg = dataclasses.replace(cfg, mesh=mesh, mesh_dp=tuple(dp),
                                  kv_seq_shard="model")
    cache_shape = eval_shape(lambda: tfm.init_cache(cfg, B, S))
    cspecs = shr.lm_cache_specs(cfg, mesh, seq_shard=kv_seq_shard)
    cshard = shr.tree_shardings(cspecs, mesh)
    len_sh = shr.placements(P(dp), mesh)

    if spec["kind"] == "prefill":
        def prefill_step(params, cache, tokens):
            logits, new_cache = tfm.forward(
                params, tokens, cfg, cache=cache,
                cache_lengths=torch.zeros((tokens.shape[0],), dtype=i32,
                                          device=tokens.device))
            return logits[:, -1], new_cache

        args = (params_shape, cache_shape, TensorSpec((B, S), i32))
        in_sh = (pshard, cshard, batch_sh)
        return Cell(arch, shape_name, "prefill", prefill_step, args, in_sh,
                    donate_argnums=(1,),
                    meta={"tokens": B * S, "n_params": n_params,
                          "n_active": n_active, "fwd_bwd": False,
                          "layers": cfg.n_layers})

    if spec["kind"] == "decode":
        def decode_step(params, cache, tokens, lengths):
            return tfm.serve_step(params, cache, tokens, lengths, cfg)

        args = (params_shape, cache_shape, TensorSpec((B, 1), i32),
                TensorSpec((B,), i32))
        in_sh = (pshard, cshard, batch_sh, len_sh)
        return Cell(arch, shape_name, "decode", decode_step, args, in_sh,
                    donate_argnums=(1,),
                    meta={"tokens": B, "n_params": n_params,
                          "n_active": n_active, "fwd_bwd": False,
                          "layers": cfg.n_layers,
                          "kv_bytes": math.prod(cache_shape["k"].shape)
                          * 2 * 2})

    raise ValueError(spec["kind"])


# ---------------------------------------------------------------------------
# GNN and RecSys cells
# ---------------------------------------------------------------------------


def _gnn_cell(arch: str, shape_name: str, spec: dict, mesh) -> Cell:
    from ..models.gnn import build as gnn_build
    return gnn_build.build_cell(arch, shape_name, spec, mesh, Cell)


def _recsys_cell(arch: str, shape_name: str, spec: dict, mesh) -> Cell:
    from ..models import recsys as rs
    return rs.build_cell(arch, shape_name, spec, mesh, Cell)


# ---------------------------------------------------------------------------
# The paper's GCDA operators
# ---------------------------------------------------------------------------


def _db_cell(arch: str, shape_name: str, spec: dict, mesh) -> Cell:
    """The paper's GCDA operators (§5.4) at production scale: each rank
    runs the kernel dispatch (``kernels.*.ops``) on its block — the CUDA
    kernel on the card, the plain version on CPU or fake tensors."""
    from ..kernels.cosine_sim.ops import cosine_sim
    from ..kernels.logreg.ops import logreg_grad
    from ..kernels.matmul.ops import matmul

    dp = shr.dp_axes(mesh)
    f32 = torch.float32
    kind = spec["kind"]

    def block(t, s):
        return shr.local_block(t, mesh, s).contiguous()

    if kind == "gcda_regression":
        n, d = spec["rows"], spec["features"]

        def step(X, y, w):
            Xl, yl, wl = block(X, P(dp, None)), block(y, P(dp)), block(w, P())
            g, loss = logreg_grad(Xl, yl, wl)      # means over local rows
            gl = shr.psum(torch.cat([g, loss[None]]) * (Xl.shape[0] / n),
                          mesh, dp)
            return wl - 0.5 * gl[:d], gl[d]

        args = (TensorSpec((n, d), f32), TensorSpec((n,), f32),
                TensorSpec((d,), f32))
        in_sh = (shr.placements(P(dp, None), mesh),
                 shr.placements(P(dp), mesh), shr.placements(P(), mesh))
        meta = {"rows": n, "features": d, "fwd_bwd": True}
        return Cell(arch, shape_name, "gcda_regression", step, args, in_sh,
                    meta=meta)

    if kind == "gcda_similarity":
        n, d = spec["rows"], spec["features"]

        def sim(X, Y):
            s = cosine_sim(block(X, P(dp, None)), block(Y, P("model", None)))
            return shr.from_blocks(s.to(torch.bfloat16), mesh, P(dp, "model"))

        args = (TensorSpec((n, d), f32), TensorSpec((n, d), f32))
        in_sh = (shr.placements(P(dp, None), mesh),
                 shr.placements(P("model", None), mesh))
        return Cell(arch, shape_name, "gcda_similarity", sim, args, in_sh,
                    meta={"rows": n, "features": d, "fwd_bwd": False})

    if kind == "gcda_multiply":
        m, k, n = spec["m"], spec["k"], spec["n"]

        def mul(X, Y):
            z = matmul(block(X, P(dp, None)), block(Y, P(None, "model")))
            return shr.from_blocks(z.to(torch.bfloat16), mesh, P(dp, "model"))

        args = (TensorSpec((m, k), f32), TensorSpec((k, n), f32))
        in_sh = (shr.placements(P(dp, None), mesh),
                 shr.placements(P(None, "model"), mesh))
        return Cell(arch, shape_name, "gcda_multiply", mul, args, in_sh,
                    meta={"m": m, "k": k, "n": n, "fwd_bwd": False})

    raise ValueError(kind)


def build_cell(arch: str, shape_name: str, mesh,
               layers: int | None = None) -> Cell:
    """The cell of ``arch``/``shape_name`` on ``mesh``; ``layers`` cuts an
    LM to that many layers (the dry-run's per-layer trace)."""
    mod = configs_pkg.get(arch)
    spec = mod.SHAPES[shape_name]
    if spec.get("skip"):
        raise ValueError(f"cell {arch}/{shape_name} is skipped: {spec['skip']}")
    if mod.FAMILY == "lm":
        return _lm_cell(arch, shape_name, spec, mesh, layers)
    if mod.FAMILY == "gnn":
        return _gnn_cell(arch, shape_name, spec, mesh)
    if mod.FAMILY == "recsys":
        return _recsys_cell(arch, shape_name, spec, mesh)
    if mod.FAMILY == "db":
        return _db_cell(arch, shape_name, spec, mesh)
    raise ValueError(mod.FAMILY)

