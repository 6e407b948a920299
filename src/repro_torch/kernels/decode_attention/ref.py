"""Plain PyTorch version of kernel L3: one-token GQA attention over a
(ring) KV cache, masked by each slot's absolute position.

Port of ``repro/kernels/decode_attention/ref.py``; the CPU path of
``ops.decode_attention`` and the kernel's oracle on the card.
"""
from __future__ import annotations

import math

import torch


def slot_valid(kv_pos, q_pos, window: int = 0):
    """(S,) bool: the slot is filled, causal, and inside the window."""
    valid = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window > 0:
        valid &= kv_pos > q_pos - window
    return valid


def decode_attention_ref(q, k, v, kv_pos, q_pos, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, Hkv, hd); kv_pos: (S,) absolute position
    of each slot (-1 = empty); q_pos: the query's absolute position.
    Returns (B, H, hd) f32; zeros where no slot is valid."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    valid = slot_valid(kv_pos, q_pos, window)[None, None, None, :]
    s.masked_fill_(~valid, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = (s - m).exp_()
    p.masked_fill_(~valid, 0.0)
    p /= p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, hd)
