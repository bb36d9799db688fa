"""AdamW with optional int8 gradient compression (error feedback).

States are plain trees (nested dicts and lists of tensors, ``None`` an
empty subtree), as in the reference: ``adamw_init`` gives {"m", "v",
"step"} with ``step`` an int32 scalar, and ``adamw_update`` returns new
trees and leaves its inputs untouched. Trees are walked with dict keys in sorted order, as
``jax.tree`` walks them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Callable | None = None) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure). ``None`` is an empty subtree,
    as in ``jax.tree``: it has no leaf and maps to ``None``. ``is_leaf``
    marks nodes of ``tree`` to take whole (a tuple spec, say)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree, is_leaf: Callable | None = None) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def adamw_init(params: Tree) -> Tree:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = tree_leaves(params)[0].device
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads: Tree, state: Tree, params: Tree,
                 cfg: AdamWConfig) -> tuple[Tree, Tree]:
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        newp = p - cfg.lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                             + cfg.weight_decay * p)
        return newp.to(p.dtype), m, v

    flat = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(params))]

    def rebuild(i):
        it = iter([o[i] for o in flat])
        return tree_map(lambda _: next(it), grads)
    return rebuild(0), {"m": rebuild(1), "v": rebuild(2), "step": step}


# ---------------------------------------------------------------------------
# Gradient compression (int8 quantization with error feedback) — flag-gated
# distributed-optimization trick for a bandwidth-bound all-reduce.
# ---------------------------------------------------------------------------


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(tree: Tree, axis: str, errors: Tree, mesh
                    ) -> tuple[Tree, Tree]:
    """Quantize -> all-reduce -> dequantize with error-feedback residuals,
    over the ranks of mesh axis ``axis``: each rank adds its residual,
    quantizes to int8 and keeps the new residual; the dequantized values
    are summed over ``mesh.get_group(axis)``, in fp32 as in the reference
    (whose docstring promises int8 traffic; both sum the dequantized
    values). The residual keeps the update unbiased over steps (EF-SGD).
    ``mesh`` is the reference's implicit shard_map mesh made explicit.
    Returns (sums, residuals)."""
    from ..distributed.sharding import psum

    def one(g, e):
        gc = g + e
        q, scale = compress_int8(gc)
        approx = decompress_int8(q, scale)
        return psum(approx, mesh, axis), gc - approx

    outs = [one(g, e) for g, e in zip(tree_leaves(tree), tree_leaves(errors))]

    def rebuild(i):
        it = iter([o[i] for o in outs])
        return tree_map(lambda _: next(it), tree)
    return rebuild(0), rebuild(1)
