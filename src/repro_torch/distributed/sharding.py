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

import math
from typing import Any

import torch

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
# Layouts the model code asks of a DTensor: the counterparts of GSPMD's
# ``with_sharding_constraint`` and of its partitioning of a gather from a
# sharded dim. On a plain tensor each computes what the plain code does, so
# a single device's results do not change.
# ---------------------------------------------------------------------------


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: itself, or a replicated one."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def block_index(t, dim: int) -> int:
    """This rank's block of DTensor ``t`` along tensor dim ``dim``: its
    linear index over the mesh dims that shard ``dim``, major first."""
    from torch.distributed.tensor import Shard

    idx = 0
    for j, p in enumerate(t.placements):
        if p == Shard(dim):
            idx = idx * t.device_mesh.size(j) + t.device_mesh.get_local_rank(j)
    return idx


class _Pin(torch.autograd.Function):
    """Redistribute to ``pl``, and the gradient to ``pl`` too."""

    @staticmethod
    def forward(ctx, t, pl):
        ctx.pl = pl
        return t.redistribute(t.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


class _Relayout(torch.autograd.Function):
    """Redistribute to ``pl``; the gradient back to the input's layout, but
    left a partial sum over the mesh dims where the input was replicated:
    its reduction is :func:`reduce_partial`'s, one for all those dims (a
    parameter's gradient over the data axes), where DTensor's own backward
    would reduce it there, mesh dim by mesh dim. Over a dim where the input
    was a partial sum the gradient is replicated, as DTensor's own."""

    @staticmethod
    def forward(ctx, t, pl):
        ctx.pl = t.placements
        return t.redistribute(t.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        pl = [q if p.is_replicate() and q.is_partial() else
              Replicate() if p.is_partial() and not q.is_partial() else p
              for p, q in zip(ctx.pl, g.placements)]
        return g.redistribute(g.device_mesh, pl), None


def _relayout(t, pl):
    return t if tuple(pl) == tuple(t.placements) else _Relayout.apply(t, pl)


def keep_split(t, dims):
    """``t`` with its splits of the tensor dims ``dims`` kept, every other
    dim replicated and partial sums reduced, and its gradient pinned to the
    same layout: the counterpart of a ``with_sharding_constraint``. Left
    alone, DTensor picks the cheapest layout operation by operation, and on
    a mesh with two data axes it splits the sequence over 'model' where the
    next reshape cannot follow."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dims = {d % t.ndim for d in dims}
    pl = tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
               for p in t.placements)
    return _Pin.apply(t, pl)


def whole(t, dims=()):
    """``t`` replicated over every mesh dim but those that split its
    tensor dims ``dims`` (its other splits gathered, partial sums
    reduced), its gradient sent back to ``t``'s layout (a reduce-scatter
    where ``t`` was split, where :func:`keep_split`'s gradient stays in
    the new layout and is all-reduced): the input of products that each
    need all of ``t``'s features."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dims = {d % t.ndim for d in dims}
    return _relayout(t, tuple(
        p if isinstance(p, Shard) and p.dim in dims else Replicate()
        for p in t.placements))


def split_over(t, dim: int, axes):
    """``t`` with tensor dim ``dim`` split over the mesh dims ``axes`` (a
    name, or names major to minor; names the mesh lacks are skipped): each
    rank's block where ``t`` was replicated there, its other splits kept
    and partial sums reduced: a ``with_sharding_constraint`` that adds a
    split. Its gradient goes back to ``t``'s layout (gathered over
    ``axes``), so a region split so ends where it began and DTensor never
    sums ``t``'s gradients in two layouts. Where the mesh dims do not
    divide ``dim``, ``t`` is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    names = axis_names(t.device_mesh)
    js = [names.index(a) for a in ((axes,) if isinstance(axes, str)
                                   else axes) if a in names]
    if not js or t.shape[dim] % math.prod(t.device_mesh.size(j)
                                          for j in js):
        return t
    pl = [Shard(dim) if j in js else
          p if isinstance(p, Shard) and p.dim != dim else Replicate()
          for j, p in enumerate(t.placements)]
    return _relayout(t, tuple(pl))


def keep_batch(t):
    """:func:`keep_split` of the batch (dim 0): the layout GSPMD gives the
    activations of a data- and tensor-parallel step."""
    return keep_split(t, (0,))


def on_shards(fn, args, roles, out_roles):
    """``fn(*args)`` for an ``fn`` that is independent along some of its
    dims, named by ``roles`` (per argument, one name or ``None`` per dim)
    and ``out_roles`` (likewise per output; a tuple of them when ``fn``
    returns several): the counterpart of a ``shard_map`` over named dims.
    Given DTensors, each rank runs ``fn`` on its blocks. A mesh dim is kept
    where every DTensor argument that has a role is split along it on that
    role (a plain argument with the role is cut to the rank's block); over
    the other mesh dims every argument is replicated (partial sums reduced)
    and each rank computes alike. An output split along a kept mesh dim by
    its role is a shard of the result, one without the role is a partial
    sum over it (so ``fn`` returns each rank's share). Each argument's
    gradient is its block's share: split where the argument is, summed
    over the kept mesh dims it has no role on, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    kept = []
    for j in range(mesh.ndim):
        split = {r[p.dim] if isinstance(p, Shard) else False
                 for a, r in zip(args, roles) if isinstance(a, DTensor)
                 for p in (a.placements[j],) if not p.is_replicate()}
        role = split.pop() if len(split) == 1 else None
        if role and all(a.placements[j] == Shard(r.index(role))
                        for a, r in zip(args, roles)
                        if isinstance(a, DTensor) and role in r):
            kept.append(role)
        else:
            kept.append(None)

    def layout(r, missing):
        return [Replicate() if k is None else
                Shard(r.index(k)) if k in r else missing for k in kept]

    local = []
    for a, r in zip(args, roles):
        if isinstance(a, DTensor) or (isinstance(a, torch.Tensor) and
                                      any(k in r for k in kept if k)):
            a = _relayout(as_dtensor(a, mesh), layout(r, Replicate())
                          ).to_local(grad_placements=layout(r, Partial()))
        local.append(a)
    out = fn(*local)
    many = isinstance(out, tuple)
    outs = tuple(DTensor.from_local(o, mesh, layout(r, Partial()),
                                    run_check=False)
                 for o, r in zip(out if many else (out,),
                                 out_roles if many else (out_roles,)))
    return outs if many else outs[0]


def joined_group(mesh, dims):
    """The process group over the mesh dims ``dims`` (indices) taken as one:
    the dim's own group, the group of a flattened dim of ``mesh``'s root
    (``launch.mesh`` flattens ('pod', 'data')), or one made once for these
    dims on every rank (a collective call) and kept on the root mesh. Only
    a flattened dim is one that DTensor's own redistributions merge
    into."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes

    names = [axis_names(mesh)[j] for j in sorted(dims)]
    if len(names) == 1:
        return mesh.get_group(names[0])
    root = mesh._get_root_mesh()
    name = "_".join(names)
    if name in root._flatten_mapping:
        return root._flatten_mapping[name].get_group()
    made = root.__dict__.setdefault("_joined_groups", {})
    if name not in made:
        # outside any dispatch mode: making a group is no operation of a
        # traced step
        with _disable_current_modes():
            order = [axis_names(root).index(n) for n in names]
            ranks = root.mesh.movedim(order, list(range(-len(order), 0)))
            size = math.prod(root.mesh.shape[j] for j in order)
            made[name], _ = dist.new_subgroups_by_enumeration(
                ranks.reshape(-1, size).tolist())
    return made[name]


def group_dims(mesh, group) -> str:
    """The dims of ``mesh`` that process group ``group`` (a group or its
    name) spans, joined by "_" (``pod_data``): read from its ranks'
    coordinates on the mesh, so any group over those dims has the name,
    whichever mesh object made it."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import _disable_current_modes

    if isinstance(group, str):
        group = _resolve_process_group(group)
    ranks = dist.get_process_group_ranks(group)
    root = mesh._get_root_mesh()
    with _disable_current_modes():      # the mesh's ranks, not a fake copy
        layout = np.asarray(root.mesh.tolist())
    coords = np.argwhere(np.isin(layout, ranks))
    return "_".join(n for j, n in enumerate(axis_names(root))
                    if len(set(coords[:, j])) > 1)


class _ReducePartial(torch.autograd.Function):
    """One all-reduce of a DTensor's partial sums over the joined group of
    their mesh dims. The gradient of a partial sum is the result's, as
    DTensor's own backward leaves it."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate

        mesh, pl = t.device_mesh, t.placements
        dims = [j for j, p in enumerate(pl) if p.is_partial()]
        local = t.to_local()
        ops = {pl[j].reduce_op for j in dims}
        if ops <= {"sum", "avg"}:       # a mean is a sum of shares
            for j in dims:
                if pl[j].reduce_op == "avg":
                    local = local / mesh.size(j)
            ops = {"sum"}
        if len(ops) != 1:
            raise ValueError(f"mixed partial reductions in {pl}")
        local = funcol.all_reduce(local.contiguous(), ops.pop(),
                                  joined_group(mesh, dims))
        return DTensor.from_local(
            funcol.wait_tensor(local), mesh,
            [Replicate() if j in dims else p for j, p in enumerate(pl)],
            run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g


def reduce_partial(t, target=None):
    """DTensor ``t`` with its partial sums reduced in ONE all-reduce over
    the joined group of the mesh dims that hold them, as GSPMD reduces a
    gradient over ('pod', 'data') at once (DTensor's own redistribution
    reduces mesh dim by mesh dim where no flattened dim joins them), then
    laid out as ``target`` (its placements; a split of a replicated dim is
    a local slice). Differentiable; a plain tensor is returned as it
    is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    if any(p.is_partial() for p in t.placements):
        t = _ReducePartial.apply(t)
    if target is not None and tuple(target) != tuple(t.placements):
        t = t.redistribute(t.device_mesh, target)
    return t


class _Extremum(torch.autograd.Function):
    """The rows' scatter on each rank, reduced over the mesh dims that
    split the rows; the gradient to each row equal to its result, split
    among the ties."""

    @staticmethod
    def forward(ctx, src, index, fn, reduce):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard

        mesh, pl = src.device_mesh, src.placements
        out = DTensor.from_local(
            fn(src.to_local(), index.to_local()), mesh,
            [Partial("max" if reduce == "amax" else "min") if p == Shard(0)
             else p for p in pl], run_check=False)
        out = out.redistribute(mesh, [Replicate() if p == Shard(0) else p
                                      for p in pl])
        ctx.save_for_backward(src, index, out)
        return out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard

        src, index, out = ctx.saved_tensors
        mesh, pl = src.device_mesh, src.placements
        sl, il, ol = src.to_local(), index.to_local(), out.to_local()
        hit = (sl == ol[il]).to(sl.dtype)
        ties = DTensor.from_local(
            torch.zeros_like(ol).index_add(0, il, hit), mesh,
            [Partial() if p == Shard(0) else p for p in pl],
            run_check=False).redistribute(mesh, out.placements).to_local()
        gl = g.redistribute(mesh, out.placements).to_local()
        return (DTensor.from_local(gl[il] * hit / ties[il], mesh, pl,
                                   run_check=False), None, None, None)


def scatter_extremum(fn, src, index, reduce: str):
    """``fn(src, index)``, a scatter of the rows of ``src`` to the rows
    ``index`` names, reduced by ``reduce`` ("amax" or "amin") with no
    initial values. On a DTensor ``src`` split along its rows (edges), each
    rank scatters its rows and the results are reduced over the ranks (an
    all-reduce of the maximum or minimum), as GSPMD partitions a segment
    maximum over a split operand; its other splits are kept. The gradient
    goes to each row equal to its result, split among the ties, as
    torch's own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(src, DTensor):
        return fn(src, index)
    mesh = src.device_mesh
    pl = [p if isinstance(p, Shard) else Replicate() for p in src.placements]
    return _Extremum.apply(
        src.redistribute(mesh, pl),
        as_dtensor(index, mesh).redistribute(
            mesh, [p if p == Shard(0) else Replicate() for p in pl]),
        fn, reduce)


def take_sharded(fn, t, dim: int, idx):
    """``fn(t, idx)`` for an ``fn`` that reads ``t`` along ``dim`` only at
    the positions ``idx`` holds (a gather or an index), each result element
    from one position, the result's dim 0 being ``idx``'s and its last dims
    ``t``'s dims after ``dim``. On DTensors each rank runs ``fn`` on its
    blocks, so no DTensor gather or index runs: where ``t`` is split along
    ``dim``, on its block with the positions moved into it, the elements
    whose position lies in another block zeroed, and the partial results
    summed over those mesh dims (a masked local gather and an all-reduce,
    as GSPMD partitions a gather from a sharded operand dim, never a
    gather of ``t``); ``idx``'s split of its dim 0 is kept (a dim 0 of
    ``t`` split the same way is the same batch), and so are ``t``'s splits
    of the dims after ``dim``; both are replicated over the other mesh
    dims. The result keeps those splits, its partial sums reduced
    (:func:`keep_split`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(t, DTensor):
        return fn(t, idx)
    mesh = t.device_mesh
    dim %= t.ndim
    idx = as_dtensor(idx, mesh)
    lays = []          # (t, idx, t's gradient, result or trailing dim)
    for p, q in zip(t.placements, idx.placements):
        if p == Shard(dim):                         # a block of the positions
            lays.append((p, Replicate(), p, Partial()))
        elif isinstance(p, Shard) and p.dim > dim:  # carried to the result
            lays.append((p, Replicate(), p, p.dim - t.ndim))
        elif q == Shard(0) and (p == Shard(0) or not isinstance(p, Shard)):
            tp = p if p == Shard(0) else Replicate()             # the batch
            lays.append((tp, q, p if p == Shard(0) else Partial(), q))
        else:
            lays.append((Replicate(),) * 4)
    tpl, ipl, gpl, opl = zip(*lays)
    t = _relayout(t, tpl)
    tl = t.to_local(grad_placements=gpl)
    il = idx.redistribute(mesh, ipl).to_local()
    if Shard(dim) not in tpl:
        out = fn(tl, il)
    else:
        size = tl.shape[dim]
        pos = il - block_index(t, dim) * size
        inside = (pos >= 0) & (pos < size)
        out = fn(tl, pos.clamp(0, size - 1))
        inside = inside.reshape(inside.shape + (1,) * (out.ndim - inside.ndim))
        out = torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))
    opl = [Shard(out.ndim + o) if isinstance(o, int) else o for o in opl]
    out = DTensor.from_local(out, mesh, opl, run_check=False)
    return keep_split(out, [0] + [p.dim for p in opl if isinstance(p, Shard)])


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


def _dims(mesh, axes) -> list:
    return [axis_names(mesh).index(name) for name in _axes(axes)]


def psum(t, mesh, axes):
    """Sum of ``t`` over the ranks of ``axes``, one all-reduce over them
    joined (differentiable: the gradient is summed back the same way)."""
    if not _axes(axes):
        return t
    return _all_reduce_sum(t, joined_group(mesh, _dims(mesh, axes)))


def pmax(t, mesh, axes):
    import torch.distributed as dist

    if not _axes(axes):
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=joined_group(mesh, _dims(mesh, axes)))
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
