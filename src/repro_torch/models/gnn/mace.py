"""MACE [arXiv:2206.07697] of the port: higher-order equivariant message
passing via the ACE product basis.

Mirrors ``repro.models.gnn.mace`` (see its docstring for the structure:
per-path CG A-basis, iterated CG B-basis up to correlation order 3,
Bessel radial basis). The reference's ``.at[].add``/``.at[].set`` block
writes become out-of-place ops: each l-block of an irrep tensor is summed
(in the reference's path order) or computed on its own, and the blocks
are concatenated, so autograd never meets an in-place write.

On DTensors (the dry-run's layouts, as GSPMD lays out the reference's
step): the edges over the data axes, the nodes whole, the channels over
'model'. The spherical harmonics and the A-basis CG products run on each
rank's edges and channels; the channel mixing (``w_msg``, ``w_self``)
runs on each data rank's nodes and mixes all their channels into each
rank's block of the weights' columns, so the B-basis CG products stay on
each rank's channels (with whole channels on every 'model' rank they did
12 times the reference's products per device at the production 16x16
mesh).

Config (assigned): n_layers=2, d_hidden=128 channels, l_max=2,
correlation_order=3, n_rbf=8, E(3)-equivariant (tested by rotation).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...distributed.sharding import keep_split, on_shards, split_over, whole
from .. import params_from_arrays  # noqa: F401  (re-exported)
from . import so3
from .common import GraphBatch, mlp_apply, mlp_params, rows_of, scatter_sum


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    n_species: int = 16
    r_cut: float = 5.0

    @property
    def sh_dim(self) -> int:
        return so3.sh_dim(self.l_max)


def _paths(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def init_params(gen: torch.Generator, cfg: MACEConfig):
    C, L = cfg.channels, cfg.n_layers
    n_paths = len(_paths(cfg.l_max))
    dev = gen.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    params = {
        "species_embed": normal(cfg.n_species, C, scale=0.3),
        "layers": [],
        "readouts": [],
    }
    for _ in range(L):
        params["layers"].append({
            "radial": mlp_params(gen, [cfg.n_rbf, 64, n_paths * C]),
            "w_msg": normal(cfg.l_max + 1, C, C, scale=C ** -0.5),
            "w_p2": normal(n_paths, C, scale=0.3),
            "w_p3": normal(n_paths, C, scale=0.3),
            "w_self": normal(cfg.l_max + 1, C, C, scale=C ** -0.5),
            "w_comb": normal(3, cfg.l_max + 1, C, scale=0.5),
        })
        params["readouts"].append(mlp_params(gen, [C, 64, 1]))
    return params


def _bessel(r, n_rbf, r_cut):
    """Bessel radial basis with smooth polynomial cutoff."""
    x = torch.clamp(r / r_cut, 1e-4, 1.0)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * x[..., None]) / (
        x[..., None] * r_cut)
    u = 1 - 10 * x ** 3 + 15 * x ** 4 - 6 * x ** 5   # C2 cutoff poly
    return rb * u[..., None]


def _blocks(l_max: int):
    """The slice of each l-block of a (l_max+1)^2 irrep axis."""
    return [slice(l * l, l * l + 2 * l + 1) for l in range(l_max + 1)]


def _path_sum(contribs: dict, like: torch.Tensor, l_max: int):
    """(..., dim, C) irreps whose l-block is the sum, in path order, of the
    (..., 2l+1, C) blocks in ``contribs[l]`` (zeros where none): the
    reference's ``zeros.at[block].add`` per path."""
    out = []
    for l, sl in enumerate(_blocks(l_max)):
        blk = like.new_zeros(like.shape[:-2] + (sl.stop - sl.start,
                                                like.shape[-1]))
        for c in contribs.get(l, ()):
            blk = blk + c
        out.append(blk)
    return torch.cat(out, dim=-2)


def _channel_mix(x, w):
    """``einsum("nmc,cd->nmd", x, w)``: each node's channels mixed. On
    DTensors each rank mixes all of ``x``'s channels, on its block of the
    nodes where they are split, into its block of ``w``'s columns, as the
    reference's specs split ``w``'s last dim over 'model'
    (``sharding.on_shards``), so the result keeps the channel split that
    the CG products run on."""
    return on_shards(lambda x, w: torch.einsum("nmc,cd->nmd", x, w),
                     (whole(x, (0,)), w),
                     (("node", None, None), (None, "col")),
                     ("node", None, "col"))


def _cg_combine(a, b, l_max, path_w, paths):
    """a, b: (B, dim, C) irreps; path_w: (n_paths, C) or per-path list.
    Returns (B, dim, C) = sum over paths of weighted CG products. The
    products are independent per node and channel, so on DTensors each
    rank combines its blocks (``sharding.on_shards``)."""
    irreps = ("node", None, "channel")
    return on_shards(lambda a, b, w: _cg_terms(a, b, l_max, w, paths),
                     (a, b, path_w), (irreps, irreps, (None, "channel")),
                     irreps)


def _cg_terms(a, b, l_max, path_w, paths):
    contribs: dict = {}
    for pi, (l1, l2, l3) in enumerate(paths):
        Ct = so3.real_cg_tensor(l1, l2, l3, a.device, a.dtype)
        s1, s2 = l1 * l1, l2 * l2
        blk = torch.einsum("...ic,...jc,ijk->...kc",
                           a[..., s1:s1 + 2 * l1 + 1, :],
                           b[..., s2:s2 + 2 * l2 + 1, :], Ct)
        contribs.setdefault(l3, []).append(blk * path_w[pi])
    return _path_sum(contribs, a, l_max)


def forward(params, g: GraphBatch, cfg: MACEConfig):
    """Returns per-graph energies (n_graphs,)."""
    N = g.n_nodes
    C, dim = cfg.channels, cfg.sh_dim
    paths = _paths(cfg.l_max)
    blocks = _blocks(cfg.l_max)
    dev = g.pos.device

    # node irreps: scalars initialized from species embedding
    emb = params["species_embed"][g.species]
    h = torch.cat([emb[:, None, :], emb.new_zeros((N, dim - 1, C))], 1)

    vec = rows_of(g.pos, g.dst) - rows_of(g.pos, g.src)
    r = torch.linalg.norm(vec + 1e-12, dim=-1)
    r_hat = vec / (r[:, None] + 1e-9)
    Y = on_shards(lambda r: so3.real_sph_harm(r, cfg.l_max), (r_hat,),
                  (("edge", None),), ("edge", None))          # (E, dim)
    rbf = _bessel(r, cfg.n_rbf, cfg.r_cut)           # (E, n_rbf)
    edge_valid = (r > 1e-6).float()                  # zero-length edges are
    if g.edge_mask is not None:                      # frame-degenerate: drop
        edge_valid = edge_valid * g.edge_mask
    gid = (g.graph_id if g.graph_id is not None
           else torch.zeros((N,), dtype=torch.int32, device=dev))

    energies = 0.0
    for lp, readout in zip(params["layers"], params["readouts"]):
        radial = on_shards(lambda r: r.reshape(-1, len(paths), C),
                           (mlp_apply(lp["radial"], rbf)
                            * edge_valid[:, None],),
                           (("edge", None),), ("edge", None, None))

        # --- A-basis: per-path CG of Y (as (E, dim, 1)) with h_src ---
        contribs: dict = {}
        h_src = rows_of(h, g.src)
        for pi, (l1, l2, l3) in enumerate(paths):
            Ct = so3.real_cg_tensor(l1, l2, l3, dev, h.dtype)
            s1, s2 = l1 * l1, l2 * l2
            # per edge and channel, so on DTensors on each rank's edges and
            # channels: DTensor's own einsum views a dim split over two
            # mesh dims, which torch 2.11 cannot
            msg = on_shards(
                lambda y, hs, Ct=Ct: torch.einsum("ei,ejc,ijk->ekc", y, hs,
                                                  Ct),
                (Y[:, s1:s1 + 2 * l1 + 1], h_src[:, s2:s2 + 2 * l2 + 1, :]),
                (("edge", None), ("edge", None, "channel")),
                ("edge", None, "channel"))
            msg = msg * radial[:, pi, None, :]
            contribs.setdefault(l3, []).append(scatter_sum(msg, g.dst, N))
        # nodes whole, channels split, as the reference's specs lay them
        # out; the channel mixing on each data rank's nodes
        A = split_over(keep_split(_path_sum(contribs, h, cfg.l_max), (2,)),
                       0, ("pod", "data"))
        # per-l channel mixing of the aggregated A-basis
        A = keep_split(torch.cat([_channel_mix(A[:, sl, :], lp["w_msg"][l])
                                  for l, sl in enumerate(blocks)], 1), (2,))

        # --- B-basis: iterated CG products (correlation order 3) ---
        B2 = _cg_combine(A, A, cfg.l_max, lp["w_p2"], paths)
        B3 = _cg_combine(B2, A, cfg.l_max, lp["w_p3"], paths)

        # --- update: per-l self-interaction + weighted B-basis sum ---
        hs = split_over(h, 0, ("pod", "data"))
        h = keep_split(torch.cat([
            keep_split(_channel_mix(hs[:, sl, :], lp["w_self"][l]), (2,))
            + lp["w_comb"][0, l] * A[:, sl, :]
            + lp["w_comb"][1, l] * B2[:, sl, :]
            + lp["w_comb"][2, l] * B3[:, sl, :]
            for l, sl in enumerate(blocks)], 1), (2,))

        # --- readout from invariants ---
        node_e = mlp_apply(readout, h[:, 0, :])[:, 0]     # (N,)
        if g.node_mask is not None:
            node_e = node_e * g.node_mask
        energies = energies + scatter_sum(node_e, gid, g.n_graphs)
    return energies


def loss_fn(params, g: GraphBatch, energy_labels, cfg: MACEConfig):
    pred = forward(params, g, cfg)
    return torch.mean((pred - energy_labels) ** 2)
