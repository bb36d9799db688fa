"""Sharding rules for every model family on the production mesh.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') multi-pod.
  * batch/data dims  -> ('pod','data') (DP; 'pod' composes hierarchically)
  * TP ('model')     -> attention heads / FFN hidden / MoE experts (EP) /
                        embedding vocab / recsys table rows
  * divisibility-checked: a dim is sharded only if divisible by the axis
    size; otherwise replicated (DTensor's uneven ``Shard`` is never used).
  * ZeRO: optimizer states additionally shard their largest replicated dim
    over 'data'.

Mirrors ``repro.distributed.sharding``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or any
object with ``axis_names`` and a ``shape`` dict (the rules only read axis
names and sizes). A spec is this module's :class:`PartitionSpec`, one entry
per tensor dim: a mesh axis name, a tuple of names (major to minor), or
``None``. :func:`placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

from typing import Any

from ..train.optimizer import tree_map

Tree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim, as ``jax.sharding.PartitionSpec``: a tuple
    whose one-name tuples read as the name (``P(("a",)) == P("a")``).
    Trailing ``None``s count: ``P("a") != P("a", None)``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(tuple(self))}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(names.index(name))
    return mesh.shape[name]


def _maybe(dim_size: int, n: int, axis="model"):
    """Shard a dim over `axis` only when divisible."""
    return axis if dim_size % n == 0 else None


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


# ---------------------------------------------------------------------------
# LM transformer
# ---------------------------------------------------------------------------


def lm_param_specs(cfg, mesh) -> Tree:
    tp = axis_size(mesh, "model")
    d, h, kv, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                      cfg.vocab)
    E = cfg.n_experts
    h_ax = _maybe(h, tp)              # shard attention heads?
    kv_ax = _maybe(kv, tp)
    f_ax = _maybe(f, tp)
    v_ax = _maybe(v, tp)
    e_ax = _maybe(E, tp) if cfg.is_moe else None

    layers = {
        "wq": P(None, None, h_ax),
        "wk": P(None, None, kv_ax),
        "wv": P(None, None, kv_ax),
        "wo": P(None, h_ax, None),
        "ln1": P(), "ln2": P(),
    }
    if cfg.qkv_bias:
        layers["bq"] = P(None, h_ax)
        layers["bk"] = P(None, kv_ax)
        layers["bv"] = P(None, kv_ax)
    if cfg.norm == "layernorm":
        layers["ln1_b"] = P()
        layers["ln2_b"] = P()
    if cfg.is_moe:
        layers["router"] = P()
        layers["w_in"] = P(None, e_ax, None, None if e_ax else f_ax)
        layers["w_out"] = P(None, e_ax, None if e_ax else f_ax, None)
        if cfg.mlp == "swiglu":
            layers["w_gate"] = P(None, e_ax, None, None if e_ax else f_ax)
    else:
        layers["w_in"] = P(None, None, f_ax)
        layers["w_out"] = P(None, f_ax, None)
        if cfg.mlp == "swiglu":
            layers["w_gate"] = P(None, None, f_ax)

    specs = {
        "embed": P(v_ax, None) if v_ax else P(None, _maybe(d, tp)),
        "ln_f": P(),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        specs["head"] = P(None, v_ax) if v_ax else P(_maybe(d, tp), None)
    return specs


def lm_batch_spec(mesh) -> P:
    return P(dp_axes(mesh), None)


def lm_cache_specs(cfg, mesh, seq_shard: bool = False) -> Tree:
    if seq_shard:  # KV seq dim sharded over 'model'
        spec = P(None, dp_axes(mesh), None, "model", None)
    else:
        kv_ax = _maybe(cfg.n_kv_heads, axis_size(mesh, "model"))
        spec = P(None, dp_axes(mesh), kv_ax, None, None)  # (L, B, Hk, M, dh)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# GNN: edge-parallel message passing
# ---------------------------------------------------------------------------


def gnn_data_specs(mesh, replicate_nodes: bool = True) -> dict:
    dp = dp_axes(mesh)
    return {
        "edges": P(dp, None),                 # (E, 2) edge index, edge-parallel
        "nodes": P() if replicate_nodes else P(dp, None),
        "batch_nodes": P(dp, None),           # batched small graphs
    }


# ---------------------------------------------------------------------------
# RecSys: DLRM-style table-row sharding
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (``None`` an empty
    subtree; anything with a ``shape`` a leaf), ``path`` the keys and
    indices from the root."""
    if tree is None:
        return None
    if hasattr(tree, "shape"):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, t, path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree)


def recsys_param_specs(params: Tree, mesh) -> Tree:
    """Embedding tables row(vocab)-sharded over 'model'; dense replicated."""
    tp = axis_size(mesh, "model")

    def spec_for(path, leaf):
        name = "/".join(str(k) for k in path)
        if "tables" in name and leaf.ndim == 2:
            return P(_maybe(leaf.shape[0], tp), None)
        return P()

    return _map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# ZeRO optimizer-state sharding
# ---------------------------------------------------------------------------


def zero_spec(spec: P, shape: tuple, mesh) -> P:
    """Add 'data' sharding on the largest unsharded, divisible dim."""
    n = axis_size(mesh, "data")
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = -1, 0
    for i, (s, dim) in enumerate(zip(entries, shape)):
        if s is None and dim % n == 0 and dim > best_size:
            best, best_size = i, dim
    if best >= 0:
        entries[best] = "data"
    return P(*entries)


def opt_state_specs(param_specs: Tree, params_shape: Tree, mesh,
                    zero: bool = True) -> Tree:
    def one(spec, shaped):
        if not zero:
            return spec
        return zero_spec(spec, tuple(shaped.shape), mesh)

    m = tree_map(one, param_specs, params_shape, is_leaf=is_spec)
    return {"m": m, "v": tree_map(lambda s: s, m, is_leaf=is_spec),
            "step": P()}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a DeviceMesh), one per
    mesh dim in mesh order: ``Shard(i)`` where tensor dim i names that
    axis, ``Replicate()`` otherwise. A dim over several axes, e.g.
    ``("pod", "data")``, is ``Shard(i)`` on each of them; DTensor splits
    over mesh dims in mesh order, major to minor, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            j = names.index(name)
            if out[j] != Replicate():
                raise ValueError(f"axis {name!r} shards two dims of {spec}")
            out[j] = Shard(i)
    return tuple(out)


def tree_shardings(specs: Tree, mesh) -> Tree:
    """The DTensor placements of every spec of ``specs``."""
    return tree_map(lambda s: placements(s, mesh), specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# Per-rank programs (the counterpart of shard_map): each rank runs a
# function on its own block; collectives are torch.distributed calls on the
# mesh axis groups.
# ---------------------------------------------------------------------------


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_index(mesh, axes) -> int:
    """This rank's linear index over ``axes`` (major to minor), as
    ``lax.axis_index``."""
    idx = 0
    for name in _axes(axes):
        idx = idx * axis_size(mesh, name) + mesh.get_local_rank(name)
    return idx


def local_block(t, mesh, spec: P):
    """This rank's block of ``t`` under ``spec``: a DTensor's local shard,
    or the slice of a full tensor at this rank's mesh coordinate (each
    sharded dim must divide evenly, as the sharding rules ensure)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, placements(spec, mesh)).to_local()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = 1
        for name in _axes(entry):
            n *= axis_size(mesh, name)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                             f"over {entry} ({n} ranks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, entry) * size, size)
    return t


def _all_reduce_sum(t, group):
    import torch
    import torch.distributed as dist

    class AllReduceSum(torch.autograd.Function):
        """SUM over ``group``; its gradient is the SUM of the gradients."""

        @staticmethod
        def forward(ctx, x):
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, group=group)
            return x

        @staticmethod
        def backward(ctx, g):
            return AllReduceSum.apply(g)

    return AllReduceSum.apply(t)


def from_blocks(block, mesh, spec: P):
    """The DTensor laid out as ``spec`` whose shard on this rank is
    ``block`` (each rank passes its own)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, mesh, placements(spec, mesh),
                              run_check=False)


def psum(t, mesh, axes):
    """Sum of ``t`` over the ranks of ``axes`` (differentiable: the
    gradient is summed back the same way)."""
    for name in _axes(axes):
        t = _all_reduce_sum(t, mesh.get_group(name))
    return t


def pmax(t, mesh, axes):
    import torch.distributed as dist

    for name in _axes(axes):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    return t


def pmean(t, mesh, axes):
    """Mean over ``axes``: a SUM then a division (gloo has no AVG)."""
    n = 1
    for name in _axes(axes):
        n *= axis_size(mesh, name)
    return psum(t, mesh, axes) / n


def all_gather(t, mesh, axes, dim: int = 0):
    """Concatenate the ranks' ``t`` along ``dim`` in the linear order of
    ``axes`` (major to minor), as ``lax.all_gather(..., tiled=True)``."""
    import torch
    import torch.distributed as dist

    for name in reversed(_axes(axes)):   # the minor axis first
        n = axis_size(mesh, name)
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, moved, group=mesh.get_group(name))
        t = out.movedim(0, dim)
    return t
