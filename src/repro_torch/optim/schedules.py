"""Learning-rate schedules (warmup + cosine decay, constant, rsqrt); port
of ``repro/optim/schedules.py``. Each maps a step (an int) to a 0-dim f32
tensor, computed in f32 as the reference computes it."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(tcfg: TrainConfig):
    def lr(step):
        step = _f32(step)
        warm = tcfg.learning_rate * step / max(tcfg.warmup_steps, 1)
        prog = torch.clamp((step - tcfg.warmup_steps) /
                           max(tcfg.total_steps - tcfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * tcfg.learning_rate * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


def constant(tcfg: TrainConfig):
    return lambda step: torch.tensor(tcfg.learning_rate, dtype=torch.float32)


def rsqrt(tcfg: TrainConfig):
    def lr(step):
        step = torch.clamp(_f32(step), min=1.0)
        scale = torch.minimum(step / max(tcfg.warmup_steps, 1),
                              torch.sqrt(tcfg.warmup_steps / step))
        return tcfg.learning_rate * scale
    return lr
