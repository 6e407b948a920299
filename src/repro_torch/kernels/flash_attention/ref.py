"""Plain PyTorch version of kernel L1: full masked softmax attention with
GQA, causal and sliding-window options.

Port of ``repro/kernels/flash_attention/ref.py``. It forms the whole
(B, Sq, Hkv, group, Skv) f32 score tensor, so it is the CPU path of
``ops.flash_attention`` and the kernel's oracle on the card, never a
path for long sequences on the card.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd). Query position i attends
    to key position j iff (not causal or j <= i) and (window == 0 or
    j > i - window); positions start at 0 on both sides. A row with no
    key gets zeros. Returns (B, Sq, H, hd) f32."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    mask = mask[None, :, None, None, :]
    s.masked_fill_(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = (s - m).exp_()
    del s
    p.masked_fill_(~mask, 0.0)
    p /= p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd)
