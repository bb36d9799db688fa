"""Cost analysis of a traced torch step: FLOPs, bytes and collective bytes
per device, for the dry-run's roofline records.

The JAX package parses the optimized HLO text of a compiled step. The port
has no HLO: it runs the step once under :class:`StepRecorder`, a
``TorchDispatchMode`` (usually on fake tensors, so nothing is allocated or
computed) and keeps a :class:`StepRecord` of what each rank's local
operations do. ``collective_bytes`` and ``hlo_cost`` keep the JAX
package's names and keys and read such a record instead of HLO text.

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention; and 2 per element of a matrix-vector
    product), applied to the operations on LOCAL tensors.
    On a DTensor an operation dispatches twice, once on the global DTensor
    and once on each rank's shard; only the shard's is counted, so the
    figure is per device.
  * Bytes: every tensor read and written by each local operation, as the
    JAX package counts each top-level HLO op's operands and result; views
    and allocations move nothing and count nothing.
  * Collectives: the operations that ``CommDebugMode`` counts as
    collectives (c10d and functional collectives), by the JAX package's
    kinds — all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute — with the bytes of their results, all-reduce
    doubled for the ring; ``collective_groups`` splits them by the mesh
    dims each one runs over (several joined by "_", e.g. ``pod_data``).
  * Loops: eager code runs every trip of a Python loop, so each trip is
    counted, the counterpart of the JAX package's trip-count walk of
    ``while`` bodies.
  * Products: ``by_product`` tallies each operation that has FLOPs by its
    name and its tensor operands' local shapes (``mm (512,24)x(24,3)``),
    so a product whole over a mesh dim can be told from a split one.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from types import MappingProxyType

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# overload-packet name -> collective kind
_KINDS = MappingProxyType({
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
})

# operations that move no data: views, allocations, metadata
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "alias", "detach", "t", "transpose",
    "permute", "expand", "select", "slice", "narrow", "squeeze", "unsqueeze",
    "as_strided", "split", "split_with_sizes", "unbind", "chunk", "unfold",
    "view_as_real", "view_as_complex", "_reshape_alias", "movedim",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "lift_fresh", "lift_fresh_copy", "device", "size", "stride",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "numel",
    "is_contiguous", "_local_scalar_dense", "wait_tensor", "set_",
})


def _tally():
    return defaultdict(lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})


@dataclasses.dataclass
class StepRecord:
    """What one rank's local operations of a traced step do: totals, the
    collectives by kind and by "kind over mesh dims" (``groups``),
    ``by_op`` (count, FLOPs and bytes by operation name) and
    ``by_product`` (the same, of the operations with FLOPs, by name and
    operand shapes)."""
    flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    collectives: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0, "bytes": 0}))
    by_op: dict = dataclasses.field(default_factory=_tally)
    groups: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0, "bytes": 0}))
    by_product: dict = dataclasses.field(default_factory=_tally)

    def scaled_sum(self, other: "StepRecord", k: float) -> "StepRecord":
        """self + k * other, field by field."""
        out = StepRecord(self.flops + k * other.flops,
                         self.bytes + k * other.bytes,
                         int(self.ops + k * other.ops))
        for rec, f in ((self, 1), (other, k)):
            for mine, theirs in ((out.collectives, rec.collectives),
                                 (out.groups, rec.groups)):
                for kind, v in theirs.items():
                    mine[kind]["count"] += int(f * v["count"])
                    mine[kind]["bytes"] += int(f * v["bytes"])
            for mine, theirs in ((out.by_op, rec.by_op),
                                 (out.by_product, rec.by_product)):
                for name, v in theirs.items():
                    for key in v:
                        mine[name][key] += f * v[key]
        return out

    def negative(self) -> bool:
        """Whether any count is below zero (a difference of two records
        that do not differ by whole layers)."""
        return (self.flops < 0 or self.bytes < 0 or self.ops < 0
                or any(v["count"] < 0 or v["bytes"] < 0
                       for d in (self.collectives, self.groups)
                       for v in d.values()))

    def top_ops(self, key: str = "flops", n: int = 8,
                by: str = "by_op") -> list:
        """The ``n`` operations (of ``by``: ``by_op`` or ``by_product``)
        with the most ``key``: [name, count, flops, bytes] each."""
        items = sorted(getattr(self, by).items(),
                       key=lambda kv: -kv[1][key])[:n]
        return [[k, int(v["count"]), v["flops"], v["bytes"]]
                for k, v in items if v[key] > 0]

    def snapshot(self):
        return (self.flops, self.bytes, self.ops,
                {k: dict(v) for k, v in self.collectives.items()},
                {k: dict(v) for k, v in self.by_op.items()},
                {k: dict(v) for k, v in self.groups.items()},
                {k: dict(v) for k, v in self.by_product.items()})

    def restore(self, snap) -> None:
        """Back to ``snapshot()``'s state: the operations of an attempt
        that was discarded are not the step's."""
        self.flops, self.bytes, self.ops, coll, by_op, groups, prods = snap
        for mine, saved in ((self.collectives, coll), (self.by_op, by_op),
                            (self.groups, groups), (self.by_product, prods)):
            mine.clear()
            mine.update(saved)


def _signature(name: str, args) -> str:
    """``name`` and its tensor operands' shapes: ``mm (512,24)x(24,3)``."""
    shapes = ["(" + ",".join(str(d) for d in a.shape) + ")" for a in args
              if isinstance(a, torch.Tensor)]
    return f"{name} {'x'.join(shapes)}"


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepRecorder(TorchDispatchMode):
    """Records every local operation run under it into ``self.record``;
    the collectives' groups are named by the dims of ``mesh`` (a
    DeviceMesh) where it is given."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self._labels: dict = {}     # group name -> mesh dims
        from torch.utils.flop_counter import FlopCounterMode
        self.record = StepRecord()
        self._flop = dict(FlopCounterMode(display=False).flop_registry)
        # matrix-vector products are dots too (XLA's dot covers them)
        aten = torch.ops.aten
        self._flop[aten.mv] = lambda a, v, out_val=None: 2 * a.numel()
        self._flop[aten.dot] = lambda a, b, out_val=None: 2 * a.numel()
        self._propagating = 0

    def __enter__(self):
        # DTensor's sharding propagation runs each new operation once on
        # fake GLOBAL tensors to learn its output's shape; that run is not
        # the rank's work and is not recorded
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        self._orig = orig
        recorder = self

        def propagate(prop, *a, **k):
            recorder._propagating += 1
            try:
                return orig(prop, *a, **k)
            finally:
                recorder._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def _group(self, args) -> str:
        """The mesh dims a collective's group spans: a functional
        collective names its group last, a c10d one passes it boxed."""
        import torch.distributed as dist
        from ..distributed.sharding import group_dims
        group = None
        for a in args:
            if isinstance(a, str):
                group = a
            elif isinstance(a, torch.ScriptObject):
                try:
                    group = dist.ProcessGroup.unbox(a)
                except RuntimeError:   # a reduce op, not a group
                    continue
        if group is None:
            return "an unnamed group"
        key = group if isinstance(group, str) else group.group_name
        if key not in self._labels:
            self._labels[key] = (group_dims(self.mesh, group)
                                 if self.mesh is not None else key)
        return self._labels[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it; its shards come back
        out = func(*args, **kwargs)
        if self._propagating or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        rec = self.record
        name = func._overloadpacket.__name__
        kind = _KINDS.get(name) if func.namespace in (
            "c10d", "_c10d_functional", "c10d_functional") else None
        if kind is not None:
            size = sum(_nbytes(t) for t in tree_leaves(out)) or \
                _nbytes(tree_leaves(args)[0])
            if name in ("_allgather_base_", "_reduce_scatter_base_"):
                size = _nbytes(args[0])     # the output buffer is arg 0
            size *= 2 if kind == "all-reduce" else 1
            for d, key in ((rec.collectives, kind),
                           (rec.groups, f"{kind} over {self._group(args)}")):
                d[key]["count"] += 1
                d[key]["bytes"] += size
            return out
        rec.ops += 1
        flops = nbytes = 0
        if func._overloadpacket in self._flop:
            flops = self._flop[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if name not in _FREE and func.namespace == "aten":
            nbytes = sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
            if not func._schema.is_mutable:
                nbytes += sum(_nbytes(t) for t in tree_leaves(out))
        rec.flops += flops
        rec.bytes += nbytes
        tallies = [rec.by_op[name]]
        if flops:
            tallies.append(rec.by_product[_signature(name, args)])
        for tally in tallies:
            tally["count"] += 1
            tally["flops"] += flops
            tally["bytes"] += nbytes
        return out


def trace(fn, *args, **kwargs):
    """(fn's result, its :class:`StepRecord`)."""
    with StepRecorder() as r:
        out = fn(*args, **kwargs)
    return out, r.record


def collective_groups(record: StepRecord) -> dict:
    """{"<kind> over <mesh dims>": {count, bytes}}, sorted."""
    return {k: dict(record.groups[k]) for k in sorted(record.groups)}


def collective_bytes(record: StepRecord) -> dict:
    """{kind: {count, bytes}, 'total_bytes': b}, the JAX package's keys;
    only the kinds the step ran appear."""
    result = {k: dict(record.collectives[k]) for k in COLLECTIVES
              if k in record.collectives}
    result["total_bytes"] = sum(v["bytes"] for v in result.values())
    return result


def hlo_cost(record: StepRecord) -> dict:
    """{'flops': f, 'bytes': b} per device, every loop trip counted."""
    return {"flops": float(record.flops), "bytes": float(record.bytes)}
