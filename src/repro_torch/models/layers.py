"""Transformer layers of the attention families (port of
``repro/models/layers.py``).

Conventions, as in the reference:
- matmul weights are stored (d_in, d_out) and applied as ``x @ w``, in the
  compute dtype (``cfg.dtype``); norm scales, biases and other small
  parameters may stay f32 (``model.CAST_MIN_SIZE``);
- norms, RoPE, SiLU, GELU, softmax statistics and logits are computed in
  f32 and cast back to the activation dtype where the reference casts
  back; biases are cast to the activation dtype before they are added.

Parameters are plain ``nn.Parameter``s: training keeps them in f32 and
casts the matrices at use (``w.to(x.dtype)``), so autograd returns f32
gradients through the cast, as the reference's ``_cast_tree`` does;
serving stores them in ``cfg.dtype`` without gradient
(``model.init_params``).

Attention dispatches to the port's kernels: a prompt with no cache goes
to ``flash_attention`` (L1) or, when a gradient is needed, to
``flash_attention_trainable`` (L1 with its lse, backward L2); one token
against a cache goes to ``decode_attention`` (L3). Their plain versions
run only through those wrappers, for CPU tensors. The matrix products
outside the kernels stay ``torch.matmul``, as the reference leaves them
to XLA. The audio family (whisper) uses layernorm, absolute sinusoidal
positions in place of RoPE, a GELU MLP with biases, and cross-attention
(``Attention.cross``) from the decoder to the encoder's output: L1
(non-causal, Sq != Skv) over the encoder's K/V for a prompt, L3 over the
layer's cross cache for one token.

One token against an int8 cache goes to ``flash_attend``, a plain
chunked online-softmax attention that dequantizes K/V chunk by chunk, on
the CPU and on the GPU alike: the reference routes an int8 cache so too
(its ``attention_apply`` hands the Pallas decode kernel only a cache
without scales, and reads the int8 one through its ``_flash_attend``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_trainable)
from repro_torch.models.kvcache import attn_cache_update


# ---------------------------------------------------------------------------
# Norm, RoPE, MLP, embedding
# ---------------------------------------------------------------------------


def rmsnorm(scale, x, eps: float):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def layernorm(scale, bias, x, eps: float):
    """f32 mean and biased variance over the last axis, f32 scale and
    bias, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor, eps: float):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)
        self.eps = eps

    def forward(self, x):
        return layernorm(self.scale, self.bias, x, self.eps)


def make_norm(cfg: ArchConfig, param, name: str) -> nn.Module:
    """The family's norm (the reference's ``make_norm``): layernorm for
    the audio family (whisper), RMSNorm for the rest, with its parameters
    from ``param(name + ".scale" / ".bias", (d,))``."""
    d = cfg.d_model
    if cfg.family == "audio":
        return LayerNorm(param(name + ".scale", (d,)),
                         param(name + ".bias", (d,)), cfg.norm_eps)
    return RMSNorm(param(name + ".scale", (d,)), cfg.norm_eps)


def sinusoidal_positions(n_pos: int, d: int, device=None):
    """(n_pos, d) f32 absolute position embeddings, interleaved as the
    reference's: sin at the even columns, cos at the odd ones, of
    pos / 10000^(2i / d)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((n_pos, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def rope_frequencies(head_dim: int, rope_partial: float, theta: float,
                     device=None):
    """(inv_freq (rot_dim / 2,) f32, rot_dim): ChatGLM's partial RoPE
    rotates only the first ``rope_partial`` of each head. theta ** exps is
    rounded once from f64, as the reference's f32 power is: torch's f32
    power missed it by an ulp at one of Qwen3-4B's 64 frequencies, which
    at position 524,287 turns the angle by 1.5e-5 rad."""
    rot_dim = int(head_dim * rope_partial)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps.double()).float(), rot_dim


def rope_angles(positions, inv_freq):
    """cos and sin of positions × inv_freq, each (S, rot_dim / 2) f32;
    computed once per call and shared by every layer."""
    angles = positions[:, None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin, rot_dim: int):
    """x: (B, S, H, hd); cos/sin: (S, rot_dim / 2) from ``rope_angles``."""
    if rot_dim == 0:
        return x
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


class SwiGLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (
            nn.Parameter(w_gate), nn.Parameter(w_up), nn.Parameter(w_down))

    def hidden(self, x):
        """silu(x @ w_gate) * (x @ w_up): what ``w_down`` takes."""
        g = x @ self.w_gate.to(x.dtype)
        u = x @ self.w_up.to(x.dtype)
        return F.silu(g.float()).to(x.dtype) * u

    def forward(self, x):
        return self.hidden(x) @ self.w_down.to(x.dtype)


class GeluMLP(nn.Module):
    """The audio family's MLP: x @ w_in + b_in, tanh-approximated GELU in
    f32 (``jax.nn.gelu``'s default), @ w_out + b_out."""

    def __init__(self, w_in, b_in, w_out, b_out):
        super().__init__()
        self.w_in, self.b_in, self.w_out, self.b_out = (
            nn.Parameter(w_in), nn.Parameter(b_in), nn.Parameter(w_out),
            nn.Parameter(b_out))

    def hidden(self, x):
        """gelu(x @ w_in + b_in): what ``w_out`` takes."""
        h = x @ self.w_in.to(x.dtype) + self.b_in.to(x.dtype)
        return F.gelu(h.float(), approximate="tanh").to(x.dtype)

    def forward(self, x):
        return (self.hidden(x) @ self.w_out.to(x.dtype)
                + self.b_out.to(x.dtype))


def embed(table, tokens, dtype):
    return F.embedding(tokens, table).to(dtype)


def unembed(w, x, cfg: ArchConfig, first: int = 0):
    """x: (B, S, d) @ w (d, n) -> f32 logits of the vocabulary columns
    first … first + n − 1 (all Vp of them, or one shard's); the padded
    vocabulary columns are set to -1e9."""
    logits = (x @ w.to(x.dtype)).float()
    if first + w.shape[-1] > cfg.vocab_size:
        logits[..., max(cfg.vocab_size - first, 0):] = -1e9
    return logits


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# one layer's (k, v, kv_pos, ring), and for an int8 cache its (k_scale,
# v_scale) after them
LayerCache = Tuple
# slots per chunk of ``flash_attend`` (the reference's default ``chunk``)
ATTEND_CHUNK = 1024


def flash_attend(q, k, v, k_scale, v_scale, *, window: int, q_offset: int,
                 kv_positions, kv_valid):
    """The reference's ``_flash_attend`` over an int8 cache: causal
    chunked online-softmax attention in f32. q: (B, Sq, H, hd) at
    positions q_offset … q_offset + Sq − 1; k/v: (B, Skv, Hkv, hd) int8,
    in ATTEND_CHUNK-slot chunks, each dequantized with its slots'
    ``k_scale`` / ``v_scale`` (B, Skv, Hkv) f32; kv_positions (Skv,) the
    slots' positions, kv_valid (Skv,) bool. A slot counts iff valid, at or
    before the query, and within ``window`` > 0 of it. Returns (B, Sq, H,
    hd) in q's dtype; a row with no valid key returns 0.

    The reference's arithmetic with fewer launches (on the GPU each chunk
    costs its ops' host time): the mask is made once, not per chunk; a
    row with no valid key yet gets a finite stand-in for its running max
    (the reference's guard sets 0), so that exp gives the masked scores 0
    and the correction factor 0 without the reference's two ``where``s.
    The values are the reference's up to the order of the products'
    sums."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    # each KV head's Sq * G queries as one (Sq * G, hd) matrix
    qh = (q.float() * (1.0 / math.sqrt(hd))).reshape(
        B, Sq, Hkv, G, hd).transpose(1, 2).reshape(B, Hkv, Sq * G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    mask = kv_valid[None, :] & (kv_positions[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (kv_positions[None, :] > q_pos[:, None] - window)
    masked = ~mask.repeat_interleave(G, dim=0)               # (Sq * G, Skv)
    inf, lowest = float("inf"), torch.finfo(torch.float32).min
    m = torch.full((B, Hkv, Sq * G), -inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, Sq * G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, Sq * G, hd), dtype=torch.float32, device=dev)
    for lo in range(0, Skv, ATTEND_CHUNK):
        hi = min(lo + ATTEND_CHUNK, Skv)
        # int8 * f32: the values exact in f32, times the scale
        kb, vb = (t[:, lo:hi].transpose(1, 2)
                  * sc[:, lo:hi].transpose(1, 2)[..., None]
                  for t, sc in ((k, k_scale), (v, v_scale)))
        s = (qh @ kb.transpose(-1, -2)).masked_fill_(masked[:, lo:hi], -inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = m_new.clamp(min=lowest)
        p = s.sub_(m_safe[..., None]).exp_()
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Hkv, Sq, G, hd).transpose(1, 2).reshape(
        B, Sq, H, hd).to(q.dtype)


def _prompt_attention(q, k, v, causal: bool, window: int = 0):
    """``flash_attention``, or ``flash_attention_trainable`` when autograd
    records a graph that needs q/k/v's gradient."""
    trainable = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    attend = flash_attention_trainable if trainable else flash_attention
    return attend(q, k, v, causal=causal, window=window)


class Attention(nn.Module):
    """GQA self-attention with optional qk-norm and (partial) RoPE
    (``rot_dim`` 0: none, as for the audio family), and the audio
    family's cross-attention (``cross_kv``, ``cross``)."""

    def __init__(self, cfg: ArchConfig, wq, wk, wv, wo, q_norm=None,
                 k_norm=None):
        super().__init__()
        self.cfg = cfg
        self.wq, self.wk, self.wv, self.wo = (
            nn.Parameter(wq), nn.Parameter(wk), nn.Parameter(wv),
            nn.Parameter(wo))
        self.q_norm = None if q_norm is None else RMSNorm(q_norm,
                                                          cfg.norm_eps)
        self.k_norm = None if k_norm is None else RMSNorm(k_norm,
                                                          cfg.norm_eps)

    def project(self, x, rope, rot_dim: int):
        """This call's q (B, S, H, hd) and k, v (B, S, Hkv, hd), normed and
        rotated."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        q, k, v = (t.reshape(B, S, n, hd) for t, n in zip(
            self.columns(x), (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)))
        return self.norm_rope(q, k, v, rope, rot_dim)

    def columns(self, x):
        """x @ wq, x @ wk, x @ wv: (B, S, columns) each."""
        return tuple(x @ w.to(x.dtype) for w in (self.wq, self.wk, self.wv))

    def norm_rope(self, q, k, v, rope, rot_dim: int):
        """q, k, v (B, S, heads, hd) after the q/k norms and the rotation,
        contiguous."""
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        cos, sin = rope
        q = apply_rope(q, cos, sin, rot_dim).contiguous()
        k = apply_rope(k, cos, sin, rot_dim).contiguous()
        return q, k, v.contiguous()

    def forward(self, x, rope, rot_dim: int, *, pos: int = 0,
                causal: bool = True, window: int = 0,
                cache: Optional[LayerCache] = None):
        """x: (B, S, d) at absolute positions pos … pos + S − 1.

        Without ``cache`` (a prompt): attention over x itself through
        ``flash_attention``, or ``flash_attention_trainable`` when autograd
        records a graph that needs q/k/v's gradient. With ``cache`` =
        (k, v, kv_pos, ring) of one layer, and (k_scale, v_scale) after
        them for an int8 cache (one token, S == 1): the token's K/V are
        written into the cache in place, then ``decode_attention`` reads
        the cache, or ``flash_attend`` an int8 one.
        Returns (out (B, S, d), (k, v) of this call)."""
        B, S, _ = x.shape
        q, k, v = self.project(x, rope, rot_dim)
        if cache is None:
            o = _prompt_attention(q, k, v, causal, window)
        else:
            if S != 1:
                raise NotImplementedError(
                    "the cache path takes one token per call (decode)")
            ck, cv, kv_pos, ring, *scales = cache
            attn_cache_update(ck, cv, kv_pos, k, v, pos, ring, *scales)
            if ck.dtype == torch.int8:
                o = flash_attend(q, ck, cv, *scales, window=window,
                                 q_offset=pos, kv_positions=kv_pos,
                                 kv_valid=kv_pos >= 0)
            else:
                o = decode_attention(q[:, 0], ck, cv, kv_pos, pos,
                                     window=window)[:, None]
        out = o.reshape(B, S, -1) @ self.wo.to(x.dtype)
        return out, (k, v)

    def cross_kv(self, enc):
        """The encoder output's (B, F, d) K and V for this layer's
        cross-attention, each (B, F, Hkv, hd): plain projections, no norm
        and no positions (the reference's ``_cross_kv``)."""
        cfg = self.cfg
        B, F_, _ = enc.shape
        shape = (B, F_, cfg.n_kv_heads, cfg.resolved_head_dim)
        return ((enc @ self.wk.to(enc.dtype)).reshape(shape),
                (enc @ self.wv.to(enc.dtype)).reshape(shape))

    def cross(self, x, k, v, kv_pos=None):
        """Cross-attention of x (B, S, d) to the encoder's K/V (B, F, Hkv,
        hd), unmasked, with no positions. Without ``kv_pos`` (a prompt, or
        training): ``flash_attention`` (non-causal, Sq = S, Skv = F), or
        ``flash_attention_trainable`` when autograd records a graph that
        needs q/k/v's gradient. With ``kv_pos`` (one token over the
        layer's cross cache; ``arange(F)`` int32, built once per cache):
        ``decode_attention`` at query position F - 1, so that every slot
        counts (L3 counts slot s iff kv_pos[s] <= q_pos).
        Returns (B, S, d)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = (x @ self.wq.to(x.dtype)).reshape(B, S, cfg.n_heads,
                                             cfg.resolved_head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
        q = q.contiguous()
        if kv_pos is None:
            o = _prompt_attention(q, k, v, causal=False)
        else:
            if S != 1:
                raise NotImplementedError(
                    "the cross cache path takes one token per call (decode)")
            o = decode_attention(q[:, 0], k, v, kv_pos,
                                 k.shape[1] - 1)[:, None]
        return o.reshape(B, S, -1) @ self.wo.to(x.dtype)
