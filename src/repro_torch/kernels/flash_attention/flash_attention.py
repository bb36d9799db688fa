"""Wrapper of the flash attention CUDA kernel (``csrc/flash_attention.cu``)
— the attention of every LM prefill and decode step."""
from __future__ import annotations

import math

import torch

from .. import _lib

launches = 0          # wrapper calls that launched the kernel (a split
                      # call launches the combine kernel too)

_ENTRY = {torch.float32: "gredo_flash_f32",
          torch.bfloat16: "gredo_flash_bf16"}
MAX_HEAD_DIM = 128
BLOCK_ROWS = 64       # packed query rows (i * G + g) per block
BLOCK_KEYS = 64       # split granularity: the fp32 kernel's KV tile,
                      # two of the bf16 kernel's
TARGET_BLOCKS = 132   # one block per SM of the H100


def num_splits(b: int, h: int, hk: int, sq: int, skv: int) -> int:
    """How many blocks share each row tile's KV axis: enough for
    ``TARGET_BLOCKS`` blocks in all, at most one per KV tile, and 1 when
    the row tiles alone fill the card. A function of the shapes only, so
    choosing never reads ``lengths`` and never synchronises."""
    tiles = b * hk * math.ceil(h // hk * sq / BLOCK_ROWS)
    kv_tiles = math.ceil(skv / BLOCK_KEYS)
    if tiles == 0 or tiles >= TARGET_BLOCKS or kv_tiles <= 1:
        return 1
    per_split = math.ceil(kv_tiles / math.ceil(TARGET_BLOCKS / tiles))
    return math.ceil(kv_tiles / per_split)


def split_size(skv: int, splits: int) -> int:
    """Keys per split: whole KV tiles, so that no split is empty by shape."""
    return BLOCK_KEYS * math.ceil(math.ceil(skv / BLOCK_KEYS) / splits)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor | None = None, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, h, sq, dh); k/v: (b, hk, skv, dh), h a multiple of hk (query
    head i reads KV head i // (h // hk)); lengths: (b,) valid KV prefix per
    batch row (default skv), the queries at positions [length - sq,
    length). float32 or bfloat16, fp32 accumulation, output in q's dtype.

    q, k and v are read in place through their strides: any layout whose
    last dim is contiguous, such as the transposed (b, s, h, dh) views the
    transformer passes and the per-layer views of its KV cache, so no
    input is copied. dh <= 128 and a multiple of 8 (bf16) or 4 (fp32), and
    every k/v row starts on a 16-byte boundary. The output has q's layout
    (``torch.empty_like``). ``lengths`` is converted to int32 if needed.

    When the row tiles alone would leave the card's SMs idle (decode), the
    KV axis is split over ``num_splits`` blocks per row tile and a second
    kernel combines their partials (the plain version of that is
    ``ref.flash_attention_split_ref``)."""
    global launches
    _lib.require_cuda("flash_attention", q, k, v,
                      *(() if lengths is None else (lengths,)))
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, dh = q.shape
    _, hk, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}: batch and head dim must "
                         f"agree and h be a multiple of hk")
    vec = 16 // q.element_size()
    if not 0 < dh <= MAX_HEAD_DIM or dh % vec:
        raise ValueError(f"flash_attention: head dim {dh} must be a multiple "
                         f"of {vec} and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name}'s rows must start on "
                             f"16-byte boundaries")
    if b > 65535 or hk > 65535:
        raise ValueError(f"flash_attention: batch {b} or KV heads {hk} "
                         f"above the grid limit 65535")
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    elif lengths.shape != (b,):
        raise ValueError(f"flash_attention: lengths {tuple(lengths.shape)} "
                         f"for batch {b}")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits = num_splits(b, h, hk, sq, skv)
    # partial (m, l, acc) of every packed row and split, for the combine
    part = (torch.empty(splits * b * h * sq * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        _lib.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), b, h, hk, sq,
                    skv, dh, int(causal), splits, split_size(skv, splits),
                    dh ** -0.5, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *out.stride()[:3], _lib.stream_of(q))
    launches += 1
    return out
