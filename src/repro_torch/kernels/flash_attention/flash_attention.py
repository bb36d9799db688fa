"""Wrapper of the flash attention CUDA kernel (``csrc/flash_attention.cu``)
— the attention of every LM prefill and decode step."""
from __future__ import annotations

import torch

from .. import _lib

launches = 0          # kernel launches made through this wrapper

_ENTRY = {torch.float32: "gredo_flash_f32",
          torch.bfloat16: "gredo_flash_bf16"}
MAX_HEAD_DIM = 128


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
    (``torch.empty_like``). ``lengths`` is converted to int32 if needed."""
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
    with torch.cuda.device(q.device):
        _lib.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
                    hk, sq, skv, dh, int(causal), dh ** -0.5,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], _lib.stream_of(q))
    launches += 1
    return out
