"""Serving launcher: batched autoregressive decoding with a KV cache.

``python -m repro_torch.launch.serve --arch qwen2-1.5b --batch 4
--prompt-len 32 --gen 32`` runs prefill + decode on the smoke config
(fp32) or the published config (``--preset full``, bf16), on the CUDA card
by default (it raises without one) or on the CPU with ``--device cpu``.
On the card attention is the flash kernel (``attn_impl="flash"``); on the
CPU it stays the reference's chunked attention. Weights and prompts are
random, from seeded ``torch.Generator``s on the serving device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core.engine import resolve_device


def build(arch: str, preset: str, device):
    """(cfg, params): the arch's smoke or full config for ``device``, and
    its random weights from ``torch.Generator(device).manual_seed(0)``,
    cast once to the serving dtype (:func:`transformer.cast_params`)."""
    from .. import configs
    from ..models import transformer as tfm

    device = torch.device(device)
    mod = configs.get(arch)
    cfg = mod.config() if preset == "full" else mod.smoke_config()
    if preset == "smoke":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator(device).manual_seed(0)
    return cfg, tfm.cast_params(tfm.init_params(gen, cfg), cfg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, gen: int):
    """Greedy prefill of ``prompts`` (B, P) on a fresh cache of P + gen
    positions, then gen - 1 decode steps. Returns (tokens (B, gen), timing)
    with timing = {"prefill_s", "decode_s", "decode_tok_s"}, each phase
    ending in a device synchronise."""
    from ..models import transformer as tfm

    device = prompts.device
    B, P = prompts.shape
    cache = tfm.init_cache(cfg, B, P + gen, device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = tfm.forward(
        params, prompts, cfg, cache=cache,
        cache_lengths=torch.zeros((B,), dtype=torch.int32, device=device))
    next_tok = torch.argmax(logits[:, -1], -1)[:, None]
    _sync(device)
    t1 = time.perf_counter()

    lengths = torch.full((B,), P, dtype=torch.int32, device=device)
    out = [next_tok]
    for _ in range(gen - 1):
        logits, cache = tfm.serve_step(params, cache, next_tok, lengths, cfg)
        next_tok = torch.argmax(logits, -1)[:, None]
        lengths = lengths + 1
        out.append(next_tok)
    _sync(device)
    t2 = time.perf_counter()
    return torch.cat(out, dim=1), {
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "decode_tok_s": B * (gen - 1) / max(t2 - t1, 1e-9)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, who="serve")
    cfg, params = build(args.arch, args.preset, device)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab, (B, P), device=device,
                            generator=torch.Generator(device).manual_seed(1))
    toks, t = generate(params, cfg, prompts, G)
    print(f"[serve] {cfg.name}: prefill {B}x{P} in {t['prefill_s']:.2f}s; "
          f"decoded {G} tokens in {t['decode_s']:.2f}s "
          f"({t['decode_tok_s']:.1f} tok/s)")
    print("[serve] sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
