"""LLM training CLI of the port (counterpart of ``repro.launch.train``),
on the GPU.

Usage (smoke scale; ``--device cpu`` runs the plain PyTorch versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
      --smoke --steps 20 --batch 2 --seq 128 [--device cuda|cpu]

The port trains every architecture: dense (qwen3_4b, llama3_8b,
minitron_8b, chatglm3_6b), moe (granite_moe_1b_a400m, mixtral_8x7b), vlm
(internvl2_1b), audio (whisper_medium: the batch carries its stub frame
embeddings), hybrid (zamba2_7b) and ssm (rwkv6_7b: both through the
reference's chunked training scans).
``--ckpt PATH`` saves the trained parameters (``checkpoint.ckpt.save``:
PATH.npz and its PATH.json manifest), which ``ckpt.restore`` reads back.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ARCH_IDS, TrainConfig, get_config
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.models import model as MODEL
from repro_torch.models import steps as STEPS
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d<=256)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="",
                    help="save the trained parameters here (npz + json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(2, args.steps // 10), remat=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = MODEL.init_params(cfg, gen, device, train=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"(analytic {cfg.param_count()/1e6:.1f}M full) on {device}")
    opt = adamw.init(dict(params.named_parameters()))
    step_fn = STEPS.make_train_step(cfg, tcfg)

    batches = synthetic_token_batches(cfg, args.batch, args.seq,
                                      seed=args.seed, device=device)
    losses = []
    t0 = time.time()
    for i, batch in zip(range(args.steps), batches):
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
    first = np.mean(losses[:5]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.ckpt:
        ckpt.save(args.ckpt, dict(params.named_parameters()),
                  step=args.steps)
        print("checkpoint ->", args.ckpt)
    return losses


if __name__ == "__main__":
    main()
