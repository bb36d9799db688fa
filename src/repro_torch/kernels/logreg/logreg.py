"""Wrapper of the one-launch logistic-regression gradient CUDA kernel
(``csrc/logreg.cu``) — the REGRESSION GCDA operator's inner loop.

A call is one ``ctypes`` call and one launch. The row tile comes from the
shape (:func:`plan`, cached). The ticket counters and the partials live in
a workspace cached per (device, stream) (``_lib.workspace``), grown when a
larger shape arrives: the tickets in a tensor of their own, zeroed once
when it is allocated and left at 0 by every call (a partial of one shape
must never land on a ticket of another)."""
from __future__ import annotations

import functools

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper

# Shared memory a block's row tile may take (floats): two blocks per SM fit.
TILE_BUDGET = 24 * 1024
BLOCKS_PER_SM = 2
GROUP_BLOCKS = 16     # blocks whose partials the first reduction level sums
# Below this many partial floats (32 loads a thread in one round) a single
# level sums them all.
ONE_LEVEL_FLOATS = 32 * 256


def plan(n: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """(rows per block, blocks, lanes per row, blocks per reduction group)
    for an (n, d) call on a card with ``sms`` SMs: at least
    ``BLOCKS_PER_SM`` blocks per SM, fewer rows where d-wide rows would not
    fit ``TILE_BUDGET``, a power of two near d lanes per row (at most a
    warp), and ``GROUP_BLOCKS`` blocks per group of the first reduction
    level, or all of them (one level) where the partials are few."""
    rows = max(1, min(n // (BLOCKS_PER_SM * sms), TILE_BUDGET // d))
    lanes = 1      # lanes per row: the tile's rows in one or two passes
    while lanes < min(d, 32) and 2 * lanes * rows <= 256:
        lanes *= 2
    blocks = -(-n // rows)
    one_level = blocks * (d + 1) <= ONE_LEVEL_FLOATS
    return rows, blocks, lanes, blocks if one_level else GROUP_BLOCKS


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(n: int, d: int, index: int) -> tuple[int, int, int, int]:
    return plan(n, d, _sms(index))


def logreg_grad(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, d), y: (n,) in {0,1}, w: (d,), contiguous float32 on the card.
    Returns (grad (d,), mean loss ()) — the same bits on every call (no
    floating-point atomics)."""
    global launches
    _lib.require_cuda("logreg_grad", x, y, w)
    for name, t in (("x", x), ("y", y), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"logreg_grad: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"logreg_grad: {name} must be contiguous")
    if x.dim() != 2 or y.shape != (x.shape[0],) or w.shape != (x.shape[1],):
        raise ValueError(f"logreg_grad: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}, w {tuple(w.shape)}")
    n, d = x.shape
    if n == 0 or d == 0:
        raise ValueError("logreg_grad: needs at least one row and column")
    dev = x.device
    rows, blocks, lanes, group_blocks = _plan(n, d, dev.index)
    groups = -(-blocks // group_blocks)
    out = torch.empty((d + 1,), dtype=torch.float32, device=dev)
    with _lib.on_device(dev):
        stream = _lib.stream_of(x)
        tickets, part = _lib.workspace(
            "logreg_grad", dev, stream,
            ((1 + groups, torch.int32, True),
             ((blocks + groups) * (d + 1), torch.float32, False)))
        _lib.launch("gredo_logreg_f32", x.data_ptr(), y.data_ptr(),
                    w.data_ptr(), tickets.data_ptr(), part.data_ptr(),
                    out.data_ptr(), n, d, rows, lanes, group_blocks, stream)
    launches += 1
    return out[:d], out[d]
