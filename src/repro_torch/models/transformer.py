"""Decoder-only LM transformer of the port: dense and MoE (GQA, RoPE,
optional QKV bias, RMSNorm or LayerNorm, SwiGLU or GELU MLP, tied or
separate head), for serving and for training.

Mirrors ``repro.models.transformer`` function for function, with PyTorch in
place of JAX:
  * Parameters are stacked over layers, as in the reference, and the layer
    loop is a Python loop over the stacked tensors' first axis (the
    reference's ``lax.scan``). ``remat`` has no effect: autograd keeps
    every layer's activations for the backward.
  * Attention is ``attn_impl``: "chunked" (the online-softmax double loop),
    "dense" (the oracle) or "flash" (the hand-written CUDA kernel on the
    card, its plain PyTorch version on the CPU).
  * Activations run in ``cfg.dtype`` (bf16 by default) and parameters are
    kept in fp32; every weight is cast to ``cfg.dtype`` where it is used,
    norms compute in fp32. :func:`cast_params` makes that cast once, ahead
    of serving: the values are bit-identical and each step then reads the
    weights in ``cfg.dtype`` instead of casting the fp32 masters anew.
  * A forward with a KV cache writes the new K/V into the cache in place
    and returns it (the reference returns an updated copy).
  * MoE is the reference's sort-based top-k dispatch into (E, C) capacity
    buffers, with its order and ties (a stable sort gives the lower
    expert index first on equal router logits), computed without a
    scatter: each buffer slot gathers its token, and each token sums its
    k expert outputs in ascending expert order, the order of the
    reference's sequential scatter-add, so the card gives the same
    rounding on every run.
  * ``loss_fn`` is the reference's sequence-chunked cross-entropy;
    gradients come from ``torch.autograd`` (``train.loop``).

Mesh forms (``cfg.mesh``, a ``DeviceMesh`` over the current process
group): every rank runs the same forward on the full activations, and the
reference's shard_map blocks become per-rank programs on each rank's block
(``distributed.sharding.local_block``) that meet in ``torch.distributed``
collectives and hand back the full tensor: the sequence-sharded decode
attention (:func:`_dist_decode_attention`) and the expert-parallel MoE
(:func:`_moe_block_shard_map`). Given DTensors (the dry-run), the same
blocks are the DTensors' local shards and the results DTensors again; the
residual stream keeps its batch split (``sharding.keep_batch``), the
embedding and the loss's gold logits are masked gathers from the
vocab-split tables (``sharding.take_sharded``), and attention and the MoE
block, independent per batch row and head or per group, run on each rank's
blocks (:func:`_attend`, :func:`_moe_block_shards`); on plain tensors none
of them changes a value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import (as_dtensor, block_index, keep_batch,
                                    keep_split, on_shards, reduce_partial,
                                    take_sharded)
from ..kernels.flash_attention.ops import flash_attention
from . import params_from_arrays  # noqa: F401  (re-exported)

Params = dict


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "tiny"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1000
    # MoE (n_experts=0 -> dense)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # variants
    qkv_bias: bool = False
    mlp: str = "swiglu"              # "swiglu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # execution
    d_head: int = 0                  # 0 -> d_model // n_heads
    attn_impl: str = "chunked"       # "chunked" | "dense" | "flash"
    q_chunk: int = 512
    kv_chunk: int = 1024
    attn_window: int = 0             # >0 -> sliding-window attention (opt-in)
    remat: bool = True
    dtype: Any = torch.bfloat16
    ce_chunk: int = 256              # cross-entropy sequence chunking
    moe_groups: int = 1              # dispatch groups
    # distribution hooks (set by launch/specs.py; None/empty for local runs)
    mesh: Any = None                 # DeviceMesh for the per-rank paths
    mesh_dp: tuple = ()              # data-parallel axis names
    kv_seq_shard: str = ""           # mesh axis sharding the KV-cache seq dim
    moe_ep_axis: str = ""            # mesh axis of the experts (EP)
    moe_impl: str = "gspmd"          # "gspmd" | "shard_map"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        d, h, kv, dh, f, v, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.head_dim, self.d_ff, self.vocab, self.n_layers)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.qkv_bias:
            attn += (h + 2 * kv) * dh
        n_mats = 3 if self.mlp == "swiglu" else 2
        if self.is_moe:
            mlp = self.n_experts * n_mats * d * f + d * self.n_experts
        else:
            mlp = n_mats * d * f
        per_layer = attn + mlp + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.mlp == "swiglu" else 2
        inactive = self.n_layers * n_mats * d * f * (self.n_experts - self.top_k)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    """fp32 parameters stacked over layers, drawn from ``gen`` on
    ``gen.device`` (the counterpart of the reference's ``init_params``:
    same shapes and scales, other random numbers)."""
    d, h, kv, dh, f, v, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.n_layers)
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    def norm_init(*shape, scale=None):
        return normal(*shape, scale=shape[-2] ** -0.5 if scale is None
                      else scale)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    layer = {
        "wq": norm_init(L, d, h * dh),
        "wk": norm_init(L, d, kv * dh),
        "wv": norm_init(L, d, kv * dh),
        "wo": norm_init(L, h * dh, d),
        "ln1": const(1.0, L, d),
        "ln2": const(1.0, L, d),
    }
    if cfg.qkv_bias:
        layer["bq"] = const(0.0, L, h * dh)
        layer["bk"] = const(0.0, L, kv * dh)
        layer["bv"] = const(0.0, L, kv * dh)
    if cfg.norm == "layernorm":
        layer["ln1_b"] = const(0.0, L, d)
        layer["ln2_b"] = const(0.0, L, d)
    experts = (cfg.n_experts,) if cfg.is_moe else ()
    if cfg.is_moe:
        layer["router"] = norm_init(L, d, cfg.n_experts)
    layer["w_in"] = norm_init(L, *experts, d, f)
    if cfg.mlp == "swiglu":
        layer["w_gate"] = norm_init(L, *experts, d, f)
    layer["w_out"] = norm_init(L, *experts, f, d, scale=f ** -0.5)

    params = {
        "embed": normal(v, d, scale=0.02),
        "ln_f": const(1.0, d),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        params["head"] = norm_init(d, v)
    return params


def cast_params(params: Params, cfg: TransformerConfig) -> Params:
    """The serving copy of fp32 parameters: every weight that the forward
    casts to ``cfg.dtype`` where it is used is cast here once; the norm
    weights (``ln*``) and the MoE router stay fp32, as the forward uses
    them (the router's logits, and so the routing, come from the fp32
    master). The forward gives bit-identical results on either copy."""
    def cast(name, t):
        return t if name.startswith("ln") or name == "router" \
            else t.to(cfg.dtype)
    out = {k: cast(k, t) for k, t in params.items() if k != "layers"}
    out["layers"] = {k: cast(k, t) for k, t in params["layers"].items()}
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _norm(x, w, b=None):
    xf = x.float()
    if b is None:  # rmsnorm
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
    y = y * w
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def _rope(x, positions, theta):
    """x: (B, S, H, Dh); positions: (B, S). Computed in fp32 (a bf16 x
    times the fp32 tables promotes to fp32, as in jnp), cast back."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _positions_mask(lengths, S, Skv, k0, kc, causal, window, q0=0, qc=None):
    """Mask (B,1,1,qc,kc) of keys k0..k0+kc for the queries q0..q0+qc of a
    context of ``lengths`` tokens whose last S sit at the end."""
    dev = lengths.device
    qc = S if qc is None else qc
    lens = lengths[:, None, None, None, None]
    kpos = k0 + torch.arange(kc, device=dev)[None, None, None, None, :]
    qpos = lens - S + q0 + torch.arange(qc, device=dev)[None, None, None, :,
                                                         None]
    mask = kpos < lens
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def _dense_attention(q, k, v, lengths, causal, window=0):
    """q: (B,H,S,D), k/v: (B,Hk,Skv,D). Oracle / small-shape path."""
    B, H, S, D = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    g = H // Hk
    qg = q.reshape(B, Hk, g, S, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(), k.float()) * D ** -0.5
    mask = _positions_mask(lengths, S, Skv, 0, Skv, causal, window)
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask  # fully-masked rows -> exactly zero output
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def _chunked_attention(q, k, v, lengths, causal, q_chunk, kv_chunk, window=0):
    """Flash-style online-softmax double loop over query and KV chunks.
    Memory per step is O(B*H*qc*kc) instead of O(B*H*S*Skv). P is rounded
    to V's dtype before P.V, as the reference does."""
    B, H, S, D = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    g = H // Hk
    qc = min(q_chunk, S)
    kc = min(kv_chunk, Skv)
    qpad, kpad = (-S) % qc, (-Skv) % kc
    q = F.pad(q, (0, 0, 0, qpad))
    k = F.pad(k, (0, 0, 0, kpad))
    v = F.pad(v, (0, 0, 0, kpad))
    nq, nk = (S + qpad) // qc, (Skv + kpad) // kc
    qr = q.reshape(B, Hk, g, nq, qc, D)
    kr = k.reshape(B, Hk, nk, kc, D)
    vr = v.reshape(B, Hk, nk, kc, D)
    scale = D ** -0.5

    outs = []
    for iq in range(nq):
        qblk = qr[:, :, :, iq].float()                           # (B,Hk,g,qc,D)
        m = torch.full((B, Hk, g, qc, 1), -1e30, device=q.device)
        l = torch.zeros((B, Hk, g, qc, 1), device=q.device)
        acc = torch.zeros((B, Hk, g, qc, D), device=q.device)
        for jk in range(nk):
            kblk, vblk = kr[:, :, jk], vr[:, :, jk]
            s = torch.einsum("bkgqd,bkcd->bkgqc", qblk, kblk.float()) * scale
            mask = _positions_mask(lengths, S, Skv, jk * kc, kc, causal,
                                   window, q0=iq * qc, qc=qc)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new) * mask
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgqc,bkcd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        o = acc / torch.where(l == 0.0, 1.0, l)
        outs.append(o.to(q.dtype))
    o = torch.stack(outs, 3)                                     # (B,Hk,g,nq,qc,D)
    return o.reshape(B, H, S + qpad, D)[:, :, :S]


def _write_cache(c, new, cache_lengths):
    """Write ``new`` (B, Hk, S, dh) into the layer cache ``c`` (B, Hk, M,
    dh) in place at per-row offsets ``cache_lengths``. The start is clamped
    into [0, M - S], as ``lax.dynamic_update_slice`` clamps it in the
    reference (torch indexing would raise instead). A DTensor cache is
    written shard by shard (:func:`_write_cache_shards`)."""
    if _is_dtensor(c):
        return _write_cache_shards(c, new, cache_lengths)
    B, _, M, _ = c.shape
    S = new.shape[2]
    start = cache_lengths.clamp(0, M - S)
    pos = start[:, None] + torch.arange(S, device=c.device)[None, :]
    rows = torch.arange(B, device=c.device)[:, None]
    c[rows, :, pos] = new.transpose(1, 2)       # indexed dims first: (B,S,Hk,dh)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _write_cache_shards(c, new, cache_lengths):
    """The cache write on each rank's shard of a DTensor cache ``c``
    sharded over batch, kv heads or positions: ``new`` and the lengths are
    brought to the cache's batch and head layout, and a rank whose
    position block holds none of a row's new positions writes nothing of
    it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    cpl = list(c.placements)
    npl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in cpl]
    lpl = [p if p == Shard(0) else Replicate() for p in cpl]
    cl = c.to_local()
    nl = as_dtensor(new, mesh).redistribute(mesh, npl).to_local()
    ll = as_dtensor(cache_lengths, mesh).redistribute(mesh, lpl).to_local()
    if Shard(2) not in cpl:
        _write_cache(cl, nl, ll)
        return c
    M = c.shape[2]
    Bl, _, Ml, _ = cl.shape
    S = nl.shape[2]
    pos = (ll.clamp(0, M - S)[:, None]
           + torch.arange(S, device=cl.device)) - block_index(c, 2) * Ml
    mine = (pos >= 0) & (pos < Ml)
    # positions of other blocks land in a spare slot past the block's end
    ext = torch.cat([cl, cl[:, :, :1]], 2)
    rows = torch.arange(Bl, device=cl.device)[:, None]
    ext[rows, :, torch.where(mine, pos, Ml)] = nl.transpose(1, 2)
    cl.copy_(ext[:, :, :Ml])
    return c


class Route(NamedTuple):
    """Top-k routing of one MoE layer over groups of T tokens (the
    reference's ``_moe_block`` up to its dispatch). Positions ``p`` index
    the (G, T*k) assignments sorted by expert, stably."""
    logits: torch.Tensor      # (G, T, E) fp32 router logits
    idx: torch.Tensor         # (G, T, k) chosen experts, best first
    capacity: int             # C: slots per expert and group
    order: torch.Tensor       # (G, T*k) flat assignment (t*k + i) at p
    sorted_e: torch.Tensor    # (G, T*k) expert at p
    sorted_gate: torch.Tensor  # (G, T*k) gate at p, cfg.dtype
    seg_start: torch.Tensor   # (G, E) first p of each expert
    seg_end: torch.Tensor     # (G, E) one past its last p
    pos: torch.Tensor         # (G, T*k) rank of p within its expert
    keep: torch.Tensor        # (G, T*k) pos < capacity


def _moe_route(x, router_w, cfg: TransformerConfig) -> Route:
    """Route x (G, T, d): fp32 logits, then the top-k experts (lower
    expert first on ties, as ``lax.top_k``)."""
    logits = x.float() @ router_w.float()
    idx = torch.sort(logits, stable=True, dim=-1, descending=True)[1]
    return _route(logits, idx[..., :cfg.top_k], cfg)


def _route(logits, idx, cfg: TransformerConfig) -> Route:
    """The dispatch of the experts ``idx`` (G, T, k) chosen from the
    router ``logits`` (G, T, E): gates (softmax over the chosen logits),
    the stable sort by expert and the capacity cut."""
    G, T, k = idx.shape
    E = cfg.n_experts
    C = max(int(math.ceil(T * k / E * cfg.capacity_factor)), 1)
    gates = torch.softmax(logits.gather(-1, idx), -1).to(cfg.dtype)
    flat_e = idx.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    experts = torch.arange(E, device=idx.device).expand(G, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts)
    seg_end = torch.searchsorted(sorted_e, experts, right=True)
    pos = (torch.arange(T * k, device=idx.device)[None]
           - seg_start.gather(-1, sorted_e))
    return Route(logits, idx, C, order, sorted_e,
                 gates.reshape(G, T * k).gather(-1, order), seg_start,
                 seg_end, pos, pos < C)


def _moe_block(x, router_w, w_in, w_gate, w_out, cfg: TransformerConfig):
    """Sort-based top-k MoE over x (G, T, d); returns ((G, T, d), aux).
    Dispatch: buffer slot (e, c) holds the token at sorted position
    seg_start[e] + c when c < the expert's count, else zeros (the
    reference's scatter of the kept rows). Combine: each token's k expert
    outputs times their gates, summed in ascending expert order in
    ``cfg.dtype``."""
    if _is_dtensor(x):
        return _moe_block_shards(x, router_w, w_in, w_gate, w_out, cfg)
    r = _moe_route(x, router_w, cfg)
    out = _moe_experts(x, r, w_in, w_gate, w_out, cfg, 0)
    return out, _moe_aux(r, cfg)


def _moe_block_shards(x, router_w, w_in, w_gate, w_out,
                      cfg: TransformerConfig):
    """:func:`_moe_block` on DTensors, as GSPMD partitions it: routing is
    independent per group, so each rank routes the groups of its block of
    ``x`` (G split over the data axes) and runs its block of the experts
    (E, or else their hidden dim, split over 'model'); the output is a
    partial sum over the experts' mesh dims (:func:`on_shards`). The
    balance loss's two means leave the ranks as partial sums and meet
    before their product, so ``aux`` is the whole batch's, as
    :func:`_moe_aux`'s."""
    E, n, F_ = cfg.n_experts, x.shape[0] * x.shape[1], cfg.d_ff

    def block(xl, rl, wi, wg, wo):
        base = block_index(w_in, 0) * wi.shape[0] if wi.shape[0] < E else 0
        # ranks holding other blocks of the same experts route alike:
        # each adds its share of the means
        share = wi.shape[0] * wi.shape[2] / (E * F_)
        r = _moe_route(xl, rl, cfg)
        first = r.idx[..., :1] == torch.arange(E, device=xl.device)
        return (_moe_experts(xl, r, wi, wg, wo, cfg, base),
                first.float().sum((0, 1)) * share,
                torch.softmax(r.logits, -1).sum((0, 1)) * share)

    w = ("expert", None, "hidden")
    out, me, ce = on_shards(
        block, (x, router_w, w_in, w_gate, w_out),
        (("group", None, None), (None, None), w, w,
         ("expert", "hidden", None)),
        (("group", None, None), (None,), (None,)))
    # each mean reduced at once over every mesh dim that holds its shares
    return out, E * ((reduce_partial(me) / n)
                     * (reduce_partial(ce) / n)).sum()


def _moe_experts(x, r: Route, w_in, w_gate, w_out, cfg: TransformerConfig,
                 base: int):
    """The routed tokens' outputs through the experts base..base+E_l
    (``w_in`` holds E_l of them): each token's kept assignments to those
    experts, times their gates, summed in ascending expert order; the
    others add nothing."""
    G, T, d = x.shape
    k, E_l = cfg.top_k, w_in.shape[0]
    C, dt, dev = r.capacity, cfg.dtype, x.device

    c = torch.arange(C, device=dev)
    seg_start = r.seg_start[:, base:base + E_l]
    src = seg_start[..., None] + c                             # (G, E_l, C)
    filled = c < (r.seg_end[:, base:base + E_l] - seg_start)[..., None]
    src = torch.where(filled, src, 0).reshape(G, E_l * C)
    tok = (r.order.gather(-1, src) // k)                       # (G, E_l*C)
    rows = torch.arange(G, device=dev)[:, None]
    xe = torch.where(filled.reshape(G, E_l * C, 1), x[rows, tok], 0)
    xe = _ep_constraint(xe.reshape(G, E_l, C, d), cfg, expert_sharded=True)

    h = xe @ w_in.to(dt)                                       # (G, E_l, C, f)
    if w_gate is not None:
        h = F.silu(xe @ w_gate.to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    ye = _ep_constraint(h @ w_out.to(dt), cfg, expert_sharded=False)
    ye = ye.reshape(G, E_l * C, d)

    # position of each flat assignment in the sorted order; a token's k
    # positions, ascending, are its experts in ascending order
    at = torch.empty_like(r.order).scatter_(
        -1, r.order, torch.arange(T * k, device=dev).expand(G, T * k))
    at = at.reshape(G, T, k).sort(-1).values.reshape(G, T * k)
    mine = r.keep
    if E_l != cfg.n_experts:
        mine = mine & (r.sorted_e >= base) & (r.sorted_e < base + E_l)
    slot = torch.where(mine, (r.sorted_e - base) * C + r.pos, 0).gather(-1, at)
    gate = torch.where(mine, r.sorted_gate, 0).gather(-1, at)
    parts = (ye[rows, slot] * gate[..., None]).reshape(G, T, k, d)
    out = parts[:, :, 0]
    for i in range(1, k):
        out = out + parts[:, :, i]
    return out


def _moe_aux(r: Route, cfg: TransformerConfig):
    """Load-balancing auxiliary loss (Switch): E * sum(fraction * prob)."""
    E = cfg.n_experts
    first = r.idx[..., :1] == torch.arange(E, device=r.idx.device)
    me = first.float().mean((0, 1))
    ce = torch.softmax(r.logits, -1).mean((0, 1))
    return E * (me * ce).sum()


def _shard_out(o, like, mesh, spec):
    """The full result of the per-rank blocks ``o`` under ``spec``: a
    DTensor of them when the input ``like`` was one, else the blocks
    gathered over the axes of ``spec``'s first entry (the batch's)."""
    from ..distributed.sharding import all_gather, from_blocks
    if _is_dtensor(like):
        return from_blocks(o, mesh, spec)
    return all_gather(o, mesh, spec[0], dim=0)


def _moe_block_shard_map(x, router_w, w_in, w_gate, w_out,
                         cfg: TransformerConfig):
    """Expert-parallel MoE as a per-rank program. The activations are
    replicated over the expert axis ``cfg.moe_ep_axis``, so each rank
    routes its data block's tokens itself and keeps the assignments to its
    own E/n experts (zero dispatch traffic); the one collective is the SUM
    of the (G, T, d) partial outputs over the expert axis. ``aux`` is
    averaged over the data-parallel axes. Capacity comes from the group's T,
    as in :func:`_moe_block`."""
    from ..distributed.sharding import (P, axis_index, local_block, pmean,
                                        psum)

    mesh, axis = cfg.mesh, cfg.moe_ep_axis
    dp = tuple(cfg.mesh_dp) or None
    xl = local_block(x, mesh, P(dp, None, None))
    w = [None if t is None else local_block(t, mesh, P(axis, None, None))
         for t in (w_in, w_gate, w_out)]
    base = axis_index(mesh, axis) * w[0].shape[0]
    r = _moe_route(xl, local_block(router_w, mesh, P()), cfg)
    out = psum(_moe_experts(xl, r, *w, cfg, base), mesh, axis)
    aux = _moe_aux(r, cfg)
    if dp:
        aux = pmean(aux, mesh, dp)     # average the balance stat over DP
    return _shard_out(out, x, mesh, P(dp, None, None)), aux


def _ep_constraint(x, cfg: TransformerConfig, expert_sharded: bool):
    """(G, E, C, d) layout pin: G over DP; E over the EP axis pre-einsum,
    replicated (token layout) post-einsum. It moves a DTensor to that
    layout and changes no value; a plain tensor passes unchanged."""
    if not cfg.moe_ep_axis or cfg.mesh is None or not _is_dtensor(x):
        return x
    from ..distributed.sharding import P, placements
    spec = P(tuple(cfg.mesh_dp) or None,
             cfg.moe_ep_axis if expert_sharded else None, None, None)
    return x.redistribute(cfg.mesh, placements(spec, cfg.mesh))


def _dist_decode_attention(q, k, v, lengths, cfg: TransformerConfig):
    """Decode attention with the KV cache's SEQUENCE dim sharded over
    ``cfg.kv_seq_shard``, as a per-rank program: each rank computes the
    partial online-softmax stats (m, l, acc) of its KV block, and the
    ranks merge them with one MAX and two SUM all-reduces over that axis
    (a row no rank attends to gives zeros).

    q: (B, H, S, dh) batch-sharded over ``cfg.mesh_dp``; k/v: (B, Hk, M,
    dh) batch- and seq-sharded; lengths: (B,). The key at local position
    j of rank r sits at global position r * M_local + j."""
    from ..distributed.sharding import (P, axis_index, local_block, pmax,
                                        psum)

    mesh, axis = cfg.mesh, cfg.kv_seq_shard
    dp = tuple(cfg.mesh_dp) or None
    B, H, S, Dh = q.shape
    Hk = k.shape[1]
    g = H // Hk
    qb = local_block(q, mesh, P(dp, None, None, None))
    kb = local_block(k, mesh, P(dp, None, axis, None))
    vb = local_block(v, mesh, P(dp, None, axis, None))
    lb = local_block(lengths, mesh, P(dp))
    Bl, Ml, dev = qb.shape[0], kb.shape[2], qb.device

    qg = qb.reshape(Bl, Hk, g, S, Dh)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(), kb.float()) * Dh ** -0.5
    kpos = axis_index(mesh, axis) * Ml + torch.arange(Ml, device=dev)
    lb_b = lb[:, None, None, None, None]
    qpos = lb_b - S + torch.arange(S, device=dev)[:, None]
    mask = (kpos < lb_b) & (qpos >= kpos)
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgqc,bkcd->bkgqd", p.to(vb.dtype).float(), vb.float())
    m_g = pmax(m, mesh, axis)
    corr = torch.exp(m - m_g)
    l_g = psum(l * corr, mesh, axis)
    acc_g = psum(acc * corr, mesh, axis)
    o = (acc_g / torch.where(l_g == 0.0, 1.0, l_g)).reshape(Bl, H, S, Dh)
    return _shard_out(o.to(qb.dtype), q, mesh, P(dp, None, None, None))


def _attend(fn, q, k, v, lengths):
    """``fn(q, k, v, lengths)``. Attention is independent per batch row and
    per head, so on DTensors it runs on each rank's blocks
    (:func:`on_shards`): over the mesh dims that split q, k and v alike on
    the batch or the heads; the others are replicated."""
    heads = ("batch", "head", None, None)
    return on_shards(fn, (q, k, v, lengths),
                     (heads, heads, heads, ("batch",)), heads)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            lengths: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None,
            cache_lengths: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """tokens: (B, S). Training/prefill: cache=None, returns (logits,
    aux_loss), aux_loss the layer mean of the MoE load-balancing loss (0
    for a dense model). Decode: pass ``cache`` {k,v: (L, B, Hk, S_max,
    dh)} and ``cache_lengths`` (B,) = tokens already in cache; the new K/V
    are written into ``cache`` in place and (logits, cache) returned.

    An MoE layer routes the B*S tokens in ``min(moe_groups, B)`` groups,
    with the capacity of each group's expert taken from its token count,
    so the rows of a batch share capacity (a decode step routes every
    slot's token together), as in the reference.

    ``attn_window`` masks the dense and chunked attention; the flash
    kernel takes no window and attends to the whole causal prefix, as the
    reference's flash path does.

    Token ids must lie in [0, vocab): the embedding gather raises on
    others, where the reference's ``jnp.take`` does not (greedy ids are
    always in range)."""
    B, S = tokens.shape
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    dev = tokens.device
    dt = cfg.dtype
    x = keep_batch(take_sharded(lambda t, i: t[i], params["embed"], 0,
                                tokens)).to(dt)

    if cache is not None:
        positions = cache_lengths[:, None] + torch.arange(S, device=dev)[None]
        total_lengths = cache_lengths + S
    else:
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        total_lengths = lengths

    layers = params["layers"]
    auxes = []
    for li in range(cfg.n_layers):
        lp = {name: t[li] for name, t in layers.items()}

        xa = _norm(x, lp["ln1"], lp.get("ln1_b"))
        q = xa @ lp["wq"].to(dt)
        kk = xa @ lp["wk"].to(dt)
        vv = xa @ lp["wv"].to(dt)
        if cfg.qkv_bias:
            q = q + lp["bq"].to(dt)
            kk = kk + lp["bk"].to(dt)
            vv = vv + lp["bv"].to(dt)
        q = _rope(q.reshape(B, S, h, dh), positions, cfg.rope_theta)
        kk = _rope(kk.reshape(B, S, cfg.n_kv_heads, dh), positions,
                   cfg.rope_theta)
        vv = vv.reshape(B, S, cfg.n_kv_heads, dh)
        q = q.transpose(1, 2)               # (B, H, S, dh): views
        kk = kk.transpose(1, 2)
        vv = vv.transpose(1, 2)

        if cache is not None:
            katt, vatt = cache["k"][li], cache["v"][li]
            _write_cache(katt, kk, cache_lengths)
            _write_cache(vatt, vv, cache_lengths)
        else:
            katt, vatt = kk, vv

        if cache is not None and cfg.kv_seq_shard:
            o = _dist_decode_attention(q, katt, vatt, total_lengths, cfg)
        elif cfg.attn_impl == "dense":
            o = _attend(lambda *a: _dense_attention(*a, True, cfg.attn_window),
                        q, katt, vatt, total_lengths)
        elif cfg.attn_impl == "flash":
            o = _attend(lambda *a: flash_attention(*a, causal=True),
                        q, katt, vatt, total_lengths)
        else:
            o = _attend(lambda *a: _chunked_attention(
                *a, True, cfg.q_chunk, cfg.kv_chunk, cfg.attn_window),
                q, katt, vatt, total_lengths)
        o = o.transpose(1, 2).reshape(B, S, h * dh)
        x = keep_batch(x + o @ lp["wo"].to(dt))

        xm = _norm(x, lp["ln2"], lp.get("ln2_b"))
        if cfg.is_moe:
            G = max(1, min(cfg.moe_groups, B))
            block = (_moe_block_shard_map
                     if cfg.moe_impl == "shard_map" and cfg.moe_ep_axis
                     else _moe_block)
            y, aux = block(xm.reshape(G, B * S // G, d), lp["router"],
                           lp["w_in"], lp.get("w_gate"), lp["w_out"], cfg)
            auxes.append(aux)
            x = keep_batch(x + y.reshape(B, S, d))
        else:
            hmid = xm @ lp["w_in"].to(dt)
            if cfg.mlp == "swiglu":
                hmid = F.silu(xm @ lp["w_gate"].to(dt)) * hmid
            else:
                hmid = F.gelu(hmid, approximate="tanh")  # jax.nn.gelu's
            x = keep_batch(x + hmid @ lp["w_out"].to(dt))

    x = _norm(x, params["ln_f"])
    aux_loss = (torch.stack(auxes).mean() if auxes else
                torch.zeros((), dtype=torch.float32, device=dev))
    if return_hidden:
        return x, aux_loss
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    logits = x @ head.to(dt)
    if cache is not None:
        return logits, cache
    return logits, aux_loss


# ---------------------------------------------------------------------------
# Train / serve steps
# ---------------------------------------------------------------------------


def loss_fn(params, batch, cfg: TransformerConfig):
    """Cross-entropy over ``batch`` {"tokens", "labels": (B, S)}, labels
    -1 masked, with the logits made and reduced ``ce_chunk`` positions at
    a time so the full (B, S, V) block never exists at once. Returns
    (nll + 0.01 * aux, nll)."""
    hidden, aux = forward(params, batch["tokens"], cfg, return_hidden=True)
    labels = batch["labels"]
    S = labels.shape[1]
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    head = head.to(cfg.dtype)

    c = min(cfg.ce_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        lab = labels[:, s0:s0 + c].long()
        # batch and vocab splits kept, as the head's product leaves them
        logits = keep_split((hidden[:, s0:s0 + c] @ head).float(), (0, 2))
        logz = torch.logsumexp(logits, -1)
        gold = take_sharded(lambda t, i: t.gather(-1, i), logits, -1,
                            lab.clamp_min(0)[..., None])[..., 0]
        mask = (lab >= 0).float()
        tot = tot + ((logz - gold) * mask).sum()
        cnt = cnt + mask.sum()
    nll = tot / cnt.clamp_min(1)
    return nll + 0.01 * aux, nll


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Params:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def serve_step(params, cache, tokens, cache_lengths, cfg: TransformerConfig):
    """One decode step: tokens (B, 1) new tokens; returns (next_token_logits,
    cache)."""
    logits, cache = forward(params, tokens, cfg, cache=cache,
                            cache_lengths=cache_lengths)
    return logits[:, -1], cache
