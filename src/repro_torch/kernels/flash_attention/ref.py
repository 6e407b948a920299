"""Plain PyTorch versions of kernels L1 (flash attention, forward) and L2
(its backward): full masked softmax attention with GQA, causal and
sliding-window options.

Port of ``repro/kernels/flash_attention/ref.py``, plus the backward pass
of ``kernel_bwd.py`` by the same formulas. Both form whole (Sq, Skv) f32
score tiles per head ((B, Sq, Hkv, group, Skv) tensors), so they are the
CPU paths of ``ops.flash_attention`` / ``ops.flash_bwd`` and the kernels'
oracles on the card, never a path for long sequences on the card.
``flash_attention_ref`` is also differentiable by autograd.
"""
from __future__ import annotations

import math

import torch


def attention_mask(Sq: int, Skv: int, causal: bool, window: int, device,
                   q_offset: int = 0):
    """(Sq, Skv) bool: query i sees key j iff (not causal or j <= i) and
    (window == 0 or j > i - window); key positions start at 0, query
    positions at ``q_offset`` (the last rows of a longer prompt)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False, q_offset: int = 0):
    """q: (B, Sq, H, hd) at positions q_offset …; k/v: (B, Skv, Hkv, hd).
    A row with no key gets zeros. Returns (B, Sq, H, hd) f32 and, with
    ``return_lse``, the per-row logsumexp (B, Sq, H) f32 as L1 writes it:
    m + log(max(l, 1e-30)) with m := 0 where the row saw no key."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, group, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    mask = attention_mask(Sq, Skv, causal, window, q.device, q_offset)
    s.masked_fill_(~mask[None, :, None, None, :], -math.inf)
    # the row max only steadies the exponent: no gradient flows through it
    m = s.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = (s - m).exp_()          # masked entries: exp(-inf) = 0
    del s
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p / l, v.float())
    o = o.reshape(B, Sq, H, hd)
    if not return_lse:
        return o
    return o, (m + torch.log(l)).reshape(B, Sq, H)


def flash_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                  window: int = 0):
    """The backward pass of ``flash_attention_ref`` from the forward's
    output ``o`` and row logsumexp ``lse`` (B, Sq, H), as kernel L2
    computes it: p = exp(q·kᵀ·scale − lse) (masked), D = rowsum(do ⊙ o),
    dv = pᵀ·do, ds = p ⊙ (do·vᵀ − D), dq = ds·k·scale, dk = dsᵀ·q·scale,
    with dk/dv summed over each GQA group. Returns f32 dq (B, Sq, H, hd)
    and dk, dv (B, Skv, Hkv, hd)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    shape5 = (B, Sq, Hkv, group, hd)
    qf = q.float().reshape(shape5)
    dof = do.float().reshape(shape5)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    p = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf).mul_(scale)
    p.sub_(lse.float().reshape(B, Sq, Hkv, group, 1)).exp_()
    p.masked_fill_(~mask[None, :, None, None, :], 0.0)
    D = (dof * o.float().reshape(shape5)).sum(-1, keepdim=True)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
    ds = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf).sub_(D).mul_(p)
    del p
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf).mul_(scale)
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf).mul_(scale)
    return dq.reshape(B, Sq, H, hd), dk, dv
