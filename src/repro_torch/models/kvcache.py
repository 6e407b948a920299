"""Serving state of the dense, moe, vlm, hybrid and ssm families (port of
``repro/models/kvcache.py``).

The cache is a dict like the reference's pytree, with ``pos`` (the number
of positions consumed, a Python int so that no step reads the device)
and:
- dense, moe, vlm: ``"attn": {"k", "v": (L, B, max_len, Hkv, hd), "kv_pos":
  (L, max_len) int32}``; ``kv_pos`` holds each slot's absolute position
  (-1 = empty), so the attention mask stays exact in a ring buffer
  (sliding window: ``max_len == window``, slot ``pos % window``); a vlm
  prompt's image positions take slots like its text;
- hybrid (zamba2): ``"mamba"`` per-layer mixer states (``conv_x``,
  ``conv_B``, ``conv_C`` histories (L, B, W-1, ·) in the cache dtype,
  ``ssm`` (L, B, H, P, N) f32) and ``"attn"``, a ring of
  ``min(seq_len, 4096)`` slots (or the window) for each of the
  ceil(L / period) shared-attention applications; the ring's size is the
  shared block's attention window;
- ssm (rwkv6): ``"wkv"`` (L, B, H, N, N) f32 and the token shifts
  ``shift_att`` / ``shift_ffn`` (L, B, d) in the cache dtype.
The recurrent states do not grow with ``seq_len``.

Where the reference is functional and returns a new cache, the port
writes in place (``attn_cache_update``, ``model.prefill``,
``model.decode_step``): that saves a copy of the whole cache on every
step. The int8 cache (``kv_quant``) and the audio family's cross-attention
state are not ported yet (ROADMAP A.20).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTENTION_FAMILIES, ArchConfig


def attn_cache_init(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "kv_pos": torch.full((n_layers, max_len), -1, dtype=torch.int32,
                             device=dev),
    }


def attn_cache_update(cache_layer_k, cache_layer_v, kv_pos, k_new, v_new,
                      pos: int, ring: bool):
    """Write one token (k_new/v_new: (B, 1, Hkv, hd)) of one layer at
    absolute position ``pos``, in place (cast to the cache dtype): at slot
    ``pos % max_len`` in a ring, else at ``pos`` clamped to the last slot,
    as the reference's ``dynamic_update_slice`` clamps it."""
    max_len = cache_layer_k.shape[1]
    slot = pos % max_len if ring else min(pos, max_len - 1)
    cache_layer_k[:, slot].copy_(k_new[:, 0])
    cache_layer_v[:, slot].copy_(v_new[:, 0])
    kv_pos[slot] = pos


def serve_cache_init(cfg: ArchConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16,
                     window_override: Optional[int] = None, device=None):
    """The serving state of ``cfg``'s family for a context of ``seq_len``
    tokens: a dense model gets ``seq_len`` slots, or ``window`` slots (a
    ring) under sliding-window attention; recurrent layers get constant
    state."""
    from repro_torch.models.mamba2 import mamba2_state_init
    window = (window_override if window_override is not None
              else cfg.sliding_window)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        N = cfg.wkv_head_dim
        L, d = cfg.n_layers, cfg.d_model
        return {"pos": 0,
                "wkv": torch.zeros((L, batch, d // N, N, N),
                                   dtype=torch.float32, device=dev),
                "shift_att": torch.zeros((L, batch, d), dtype=dtype,
                                         device=dev),
                "shift_ffn": torch.zeros((L, batch, d), dtype=dtype,
                                         device=dev)}
    if cfg.family == "hybrid":
        n_attn = -(-cfg.n_layers // cfg.shared_attn_period)
        ring = window if window > 0 else min(seq_len, 4096)
        return {"pos": 0,
                "mamba": mamba2_state_init(cfg, batch, dtype, dev,
                                           n_layers=cfg.n_layers),
                "attn": attn_cache_init(cfg, n_attn, batch, ring, dtype,
                                        device=dev)}
    if cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family} serving state is not ported yet; the port serves "
            "the dense, moe, vlm, hybrid and ssm families")
    max_len = window if window > 0 else seq_len
    return {"pos": 0,
            "attn": attn_cache_init(cfg, cfg.n_layers, batch, max_len, dtype,
                                    device=dev)}
