"""Train a small LLM of the architecture zoo with the PyTorch port (twin
of ``llm_smoke_train.py``) on the synthetic token pipeline and watch the
loss decrease: the same train step, AdamW, remat and data path that the
full-width runs use.

  PYTHONPATH=src python examples/torch_llm_smoke_train.py
      [--arch mixtral_8x7b] [--device cuda|cpu]

Every architecture whose family the port trains (dense, moe, vlm) runs at
its smoke variant (2 layers, d <= 256, <= 4 experts). ``--steps`` shrinks
the run (default 60). The loss must fall.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ARCH_IDS, ATTENTION_FAMILIES,
                                      NOT_PORTED, TrainConfig, get_config)
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.models import model as MODEL
from repro_torch.models import steps as STEPS
from repro_torch.optim import adamw

TRAINABLE = [a for a in ARCH_IDS if a not in NOT_PORTED
             and get_config(a).family in ATTENTION_FAMILIES]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_8b", choices=TRAINABLE)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).smoke_variant()
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                       warmup_steps=5)
    params = MODEL.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device, train=True)
    opt = adamw.init(dict(params.named_parameters()))
    step = STEPS.make_train_step(cfg, tcfg)

    losses = []
    t0 = time.time()
    for i, batch in zip(range(args.steps),
                        synthetic_token_batches(cfg, batch=4, seq=128,
                                                device=device)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"{cfg.name} on {device}: loss {first:.3f} -> {last:.3f} in "
          f"{time.time()-t0:.0f}s")
    assert last < first, "loss must decrease"
    print("OK")
    return losses


if __name__ == "__main__":
    main()
