"""EquiformerV2 [arXiv:2306.12059] of the port: equivariant graph
attention with eSCN SO(2) convolutions.

Mirrors ``repro.models.gnn.equiformer_v2`` (see its docstring for the eSCN
structure: rotate into the edge frame, per-|m| SO(2) mixing up to m_max,
rotate back, attention over incoming edges). The reference's
``.at[].set`` block writes become out-of-place ops: per-l blocks are
concatenated, and the SO(2) outputs are placed into fresh zeros with
``index_copy`` (rows above m_max stay zero), so autograd never meets an
in-place write. The per-edge Wigner blocks are computed once per forward,
as in the reference.

``channel_shard_axis`` (the reference's channel sharding over a mesh
axis) pins the node features' channel dim to that axis of their mesh when
they are DTensors (the dry-run); it changes no value, and plain tensors
pass unchanged.

On DTensors (the dry-run's layouts, as GSPMD lays out the reference's
step): the edges over the data axes, the node features whole over them
and their channels over 'model'. The per-edge Wigner matrices are built
on each rank's edges, whole over 'model'; the rotations into and out of
the edge frame run on each rank's edges and channels; the SO(2) mixing
gathers each edge's channels over 'model' (the reference's all-gather)
and mixes them into each rank's block of the weights' columns; the
node-wise FFN and the readout run on each data rank's block of the nodes,
as the reference's do on two pods.

Config (assigned): n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ...distributed.sharding import (keep_batch, keep_split, on_shards,
                                     split_over, whole)
from .. import params_from_arrays  # noqa: F401  (re-exported)
from . import so3
from .common import (GraphBatch, mlp_apply, mlp_params, rows_of,
                     scatter_softmax, scatter_sum)
from .mace import _bessel, _blocks


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_species: int = 16
    n_rbf: int = 8
    r_cut: float = 5.0
    # pin the irrep features' channel dim to this mesh axis (``_cshard``),
    # as the reference's channel sharding does
    channel_shard_axis: str = ""

    @property
    def sh_dim(self) -> int:
        return so3.sh_dim(self.l_max)


def _m_index_sets(l_max: int, m_max: int):
    """For each |m| <= m_max: (rows_cos, rows_sin) index lists into the
    (l_max+1)^2 irrep vector; m=0 -> (rows, None)."""
    sets = []
    for m in range(m_max + 1):
        cos_rows = [l * l + l + m for l in range(m, l_max + 1)]
        sin_rows = [l * l + l - m for l in range(m, l_max + 1)] if m else None
        sets.append((cos_rows, sin_rows))
    return sets


@functools.lru_cache(maxsize=None)
def _m_index_tensors(l_max: int, m_max: int, device: torch.device):
    """``_m_index_sets`` as index tensors on ``device``, and every row they
    name, in the order ``_so2_conv`` concatenates its outputs."""
    sets, order = [], []
    for rows_c, rows_s in _m_index_sets(l_max, m_max):
        sets.append((torch.tensor(rows_c, device=device),
                     None if rows_s is None
                     else torch.tensor(rows_s, device=device)))
        order += rows_c + (rows_s or [])
    return sets, torch.tensor(order, device=device)


def init_params(gen: torch.Generator, cfg: EquiformerV2Config):
    C, H = cfg.channels, cfg.n_heads
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    layers = []
    for _ in range(cfg.n_layers):
        so2 = []
        for rows_c, rows_s in _m_index_sets(cfg.l_max, cfg.m_max):
            fan = len(rows_c) * C
            so2.append({"wr": normal(fan, fan, scale=fan ** -0.5),
                        "wi": (normal(fan, fan, scale=fan ** -0.5)
                               if rows_s else None)})
        layers.append({
            "so2": so2,
            "radial": mlp_params(gen, [cfg.n_rbf, 64, C]),
            "attn": mlp_params(gen, [2 * C, C, H]),
            "w_val": normal(C, C, scale=C ** -0.5),
            "ffn_gate": mlp_params(gen, [C, C * 2]),
            "ffn_mix": normal(cfg.l_max + 1, C, C, scale=C ** -0.5),
            "ln": torch.ones((cfg.l_max + 1, C), device=dev),
        })
    return {
        "species_embed": normal(cfg.n_species, C, scale=0.3),
        "layers": layers,
        "readout": mlp_params(gen, [C, 64, 1]),
    }


def _irrep_norm(h, gains, l_max):
    """Per-l RMS norm over (m, channel)."""
    out = []
    for l, sl in enumerate(_blocks(l_max)):
        blk = h[:, sl, :]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True)
                         + 1e-6)
        out.append(blk / rms * gains[l])
    return torch.cat(out, 1)


def _so2_conv(feat_edge, so2_w, radial, msets, order, C):
    """feat_edge: (E, dim, C) in edge frame. Per-|m| dense mixing over
    (l-stack x channels); radial (E, C) modulates channels. ``msets`` and
    ``order`` from ``_m_index_tensors``: rows above m_max stay zero. The
    mixing is independent per edge and per output column, so on DTensors
    (``sharding.on_shards``) each rank mixes its edges into its block of
    the weights' columns, as the reference splits the weights' last dim
    over 'model'; the blocks are gathered over 'model' before the
    (l, channel) reshape, which a column split cannot follow, and the
    radial gate and placement run on each rank's edges."""
    ws = [w[k] for w in so2_w for k in ("wr", "wi")]

    def mix(f, *ws):
        return _so2_mix(f, ws, msets, C)

    n_out = sum(1 if rows_s is None else 2 for _, rows_s in msets)
    cols = on_shards(mix, (keep_split(feat_edge, (0,)), *ws),
                     (("edge", None, None),) + ((None, "col"),) * len(ws),
                     (("edge", "col"),) * n_out)
    cols = tuple(keep_split(o, (0,)) for o in cols)

    def place(r, *cols):
        return _so2_place(cols, r, msets, order, C, feat_edge.shape[1])

    return on_shards(place, (radial, *cols),
                     (("edge", None),) + (("edge", None),) * n_out,
                     ("edge", None, None))


def _so2_mix(feat_edge, ws, msets, C):
    """The per-|m| products: (E, nl * C) each, m = 0's one and a (cos, sin)
    pair for each m > 0, in ``msets``' order; ``ws`` the (wr, wi) of each
    |m| in turn (wi None for m = 0)."""
    outs = []
    for (rows_c, rows_s), wr, wi in zip(msets, ws[::2], ws[1::2]):
        nl = rows_c.numel()
        fc = feat_edge.index_select(1, rows_c).reshape(-1, nl * C)
        if rows_s is None:
            outs.append(fc @ wr)
        else:
            fs = feat_edge.index_select(1, rows_s).reshape(-1, nl * C)
            outs.append(fc @ wr - fs @ wi)
            outs.append(fc @ wi + fs @ wr)
    return tuple(outs)


def _so2_place(cols, radial, msets, order, C, dim):
    """The products of :func:`_so2_mix` gated by ``radial`` and placed at
    their rows of a (E, dim, C) block, the rows above m_max zero."""
    nls = [rows_c.numel() for rows_c, rows_s in msets
           for _ in range(1 if rows_s is None else 2)]
    blk = torch.cat([o.reshape(-1, nl, C) * radial[:, None, :]
                     for o, nl in zip(cols, nls)], 1)
    return blk.new_zeros((blk.shape[0], dim, C)).index_copy(1, order, blk)


def _ffn(h, lp, l_max, C):
    """The equivariant FFN's update of ``h`` (N, dim, C): the per-l norm,
    the scalars' gate (SiLU for l = 0, a sigmoid for the others) and the
    per-l channel mixing. Per node, so on DTensors each data rank runs its
    block of the nodes with all their channels, the gate whole over
    'model' as the reference's, into its block of the output channels
    (``sharding.on_shards``: no DTensor slices a split tensor), and the
    result is gathered over the data axes."""
    (gl,) = lp["ffn_gate"]
    blocks = _blocks(l_max)

    def update(x, gains, gw, gb, mix, cols):
        xn = _irrep_norm(x, gains, l_max)
        gate = xn[:, 0, :] @ gw + gb                      # (n, 2C)
        g1, g2 = gate[:, cols], gate[:, C + cols]
        return torch.cat([
            torch.einsum("nmc,cd->nmd", xn[:, sl, :], mix[l])
            * (F.silu(g1) if l == 0 else torch.sigmoid(g2))[:, None, :]
            for l, sl in enumerate(blocks)], 1)

    x = whole(split_over(h, 0, ("pod", "data")), (0,))
    cols = torch.arange(C, device=h.device)   # cut to each rank's channels
    out = on_shards(update, (x, whole(lp["ln"]), whole(gl["w"]),
                             whole(gl["b"]), lp["ffn_mix"], cols),
                    (("node", None, None), (None, None), (None, None),
                     (None,), (None, None, "col"), ("col",)),
                    ("node", None, "col"))
    return keep_split(out, (2,))


def _rotate(D, feat):
    """``D @ feat`` per edge: (E, dim, dim) by (E, dim, C). Independent per
    edge and channel, so on DTensors each rank rotates its edges' block of
    channels (``sharding.on_shards``)."""
    return on_shards(torch.bmm, (D, feat),
                     (("edge", None, None), ("edge", None, "channel")),
                     ("edge", None, "channel"))


def _cshard(cfg: EquiformerV2Config, x):
    """Layout pin: the last (channel) dim over ``channel_shard_axis``."""
    from torch.distributed.tensor import DTensor
    if not cfg.channel_shard_axis or not isinstance(x, DTensor):
        return x
    from ...distributed.sharding import P, placements
    spec = P(*([None] * (x.ndim - 1) + [cfg.channel_shard_axis]))
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def forward(params, g: GraphBatch, cfg: EquiformerV2Config):
    N = g.n_nodes
    C, dim, H = cfg.channels, cfg.sh_dim, cfg.n_heads
    dev = g.pos.device
    msets, order = _m_index_tensors(cfg.l_max, cfg.m_max, dev)

    emb = params["species_embed"][g.species]
    h = _cshard(cfg, torch.cat([emb[:, None, :],
                                emb.new_zeros((N, dim - 1, C))], 1))

    vec = rows_of(g.pos, g.dst) - rows_of(g.pos, g.src)
    r = torch.linalg.norm(vec + 1e-12, dim=-1)
    r_hat = vec / (r[:, None] + 1e-9)
    rbf = _bessel(r, cfg.n_rbf, cfg.r_cut)
    edge_valid = (r > 1e-6).float()                  # zero-length edges are
    if g.edge_mask is not None:                      # frame-degenerate: drop
        edge_valid = edge_valid * g.edge_mask

    # (E, dim, dim), fp32 as in the reference, promoted to the features'
    # dtype as the reference's einsum promotes it
    D = on_shards(lambda r: so3.edge_frame_wigner(r, cfg.l_max), (r_hat,),
                  (("edge", None),), ("edge", None, None)).to(h.dtype)
    Dt = D.transpose(1, 2)

    for lp in params["layers"]:
        # pinned: the gradients the edges scatter into the nodes are
        # reduced over the data axes once, not per l-block of the norm
        hn = keep_split(_irrep_norm(h, lp["ln"], cfg.l_max), (2,))
        radial = mlp_apply(lp["radial"], rbf) * edge_valid[:, None]  # (E, C)

        # eSCN message: rotate -> per-m SO(2) mixing -> rotate back. The
        # rotations run on each rank's edges and channels, D whole over
        # 'model'; the mixing gathers each edge's channels
        src_feat = _rotate(D, rows_of(hn, g.src))
        msg_edge = _so2_conv(src_feat, lp["so2"], radial, msets, order, C)
        msg = _rotate(Dt, split_over(msg_edge, 2, "model"))  # back to global

        # attention over incoming edges from invariant channels
        inv = torch.cat([rows_of(hn, g.dst)[:, 0, :], msg[:, 0, :]], -1)
        logits = mlp_apply(lp["attn"], keep_batch(inv))   # (E, H)
        if g.edge_mask is not None:
            logits = torch.where(g.edge_mask[:, None] > 0, logits, -1e30)
        att = scatter_softmax(logits, g.dst, N)           # (E, H)
        # heads gate channel groups
        # the gate pinned to its edge split (its gradient's view into the
        # heads' channel groups cannot follow a channel split); the value
        # product on each rank's edges and block of the weight's columns,
        # as the reference splits them over 'model' (its gradient's views
        # cannot follow DTensor's layout of the saved message)
        att_c = keep_batch(torch.repeat_interleave(att, C // H, dim=-1))
        val = on_shards(lambda m, w: torch.einsum("eic,cd->eid", m, w),
                        (keep_split(msg, (0,)), lp["w_val"]),
                        (("edge", None, None), (None, "col")),
                        ("edge", None, "col"))
        # nodes whole, channels as split, as the reference's specs lay out
        # the node features
        h = keep_split(h + _cshard(cfg, scatter_sum(val * att_c[:, None, :],
                                                    g.dst, N)), (2,))

        # equivariant FFN: scalars gate all l-blocks
        h = keep_split(h + _cshard(cfg, _ffn(h, lp, cfg.l_max, C)), (2,))

    node_e = mlp_apply(params["readout"],
                       split_over(h[:, 0, :], 0, ("pod", "data")))[:, 0]
    if g.node_mask is not None:
        node_e = node_e * g.node_mask
    gid = (g.graph_id if g.graph_id is not None
           else torch.zeros((N,), dtype=torch.int32, device=dev))
    return scatter_sum(node_e, gid, g.n_graphs)


def loss_fn(params, g: GraphBatch, energy_labels, cfg: EquiformerV2Config):
    pred = forward(params, g, cfg)
    return torch.mean((pred - energy_labels) ** 2)
