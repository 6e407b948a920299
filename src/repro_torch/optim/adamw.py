"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro/optim/adamw.py``).

Plain tensor code: the reference has no kernel here. Its state is a pytree
shaped like the parameters; the port's keys ``mu`` and ``nu`` by parameter
name (``dict(model.named_parameters())``), f32, and counts ``step`` as a
Python int. Unlike the reference's pure functions, ``clip_by_global_norm``
scales the gradients and ``apply`` updates the parameters and both moments
in place, which saves a copy of each; the arithmetic is the reference's,
in the same order, in f32.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments, f32, beside each named parameter."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}

    return AdamWState(step=0, mu=zeros(), nu=zeros())


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32 (0-dim)."""
    sq = sum(x.detach().float().square().sum() for x in tensors)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place by min(1, max_norm / max(norm, 1e-9));
    returns (grads, the norm before scaling)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: AdamWState,
          tcfg: TrainConfig, lr) -> AdamWState:
    """One AdamW update at learning rate ``lr`` (a number or 0-dim tensor,
    the schedule already applied). Updates ``params`` and the moments in
    place and returns the state with ``step`` advanced."""
    step = state.step + 1
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    stepf = torch.tensor(float(step), dtype=torch.float32)
    f32 = torch.float32
    bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** stepf)
    bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** stepf)
    lr = float(lr)
    for name, p in params.items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        delta.add_(p.float() * wd)
        p.copy_(p.float() - delta.mul_(lr))
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
