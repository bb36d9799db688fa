"""Training launcher: ``python -m repro_torch.launch.train --arch qwen2-1.5b
--steps 200 [--preset smoke|full] [--batch B --seq S] [--device cpu]``.

The LM training path over the port's ``Trainer``: the smoke preset (fp32)
by default, ``--preset full`` for the published config (bf16). It runs on
the CUDA card unless ``--device cpu`` is given (without a card and without
``--device`` it raises). Weights come from ``torch.Generator(device)
.manual_seed(0)``; data from ``data.lm.TokenStream``. Checkpoints go under
``--ckpt-dir`` (default ``build/repro_torch/train_ckpt``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..core.engine import resolve_device
from ..train.optimizer import tree_leaves


def build(arch: str, preset: str, device):
    """(cfg, fp32 params) of an LM arch's smoke or full config."""
    from .. import configs
    from ..models import transformer as tfm

    mod = configs.get(arch)
    if mod.FAMILY != "lm":
        raise SystemExit(f"train.py drives LM archs; {arch} is {mod.FAMILY}")
    cfg = mod.config() if preset == "full" else mod.smoke_config()
    if preset == "smoke":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device).manual_seed(0)
    return cfg, tfm.init_params(gen, cfg)


def run(cfg, params, *, steps: int, batch: int, seq: int,
        microbatch: int = 1, ckpt_dir: str = "build/repro_torch/train_ckpt",
        ckpt_every: int = 50, lr: float = 3e-4) -> dict:
    """Train ``params`` for ``steps`` steps on the TokenStream batches, on
    the params' device; the Trainer's result ({"metrics", "stragglers"})."""
    from ..data.lm import TokenStream
    from ..models import transformer as tfm
    from ..train.loop import Trainer, TrainerConfig
    from ..train.optimizer import AdamWConfig

    device = tree_leaves(params)[0].device
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq)

    def data_at(step):
        b = stream.batch_at(step)
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    trainer = Trainer(
        lambda p, b: tfm.loss_fn(p, b, cfg), params, data_at,
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                      ckpt_dir=ckpt_dir, microbatch=microbatch),
        opt_cfg=AdamWConfig(lr=lr))
    return trainer.run_with_restarts()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/repro_torch/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, who="train")
    cfg, params = build(args.arch, args.preset, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")
    result = run(cfg, params, steps=args.steps, batch=args.batch,
                 seq=args.seq, microbatch=args.microbatch,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 lr=args.lr)
    for m in result["metrics"]:
        print(f"[train] step {m['step']:5d} loss {m['loss']:.4f} "
              f"({m['seconds'] * 1e3:.0f} ms)")
    print(json.dumps({"final_loss": result["metrics"][-1]["loss"],
                      "stragglers": result["stragglers"]}))


if __name__ == "__main__":
    main()
