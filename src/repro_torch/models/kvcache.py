"""Serving state of the dense, moe, vlm, audio, hybrid and ssm families
(port of ``repro/models/kvcache.py``).

The cache is a dict like the reference's pytree, with ``pos`` (the number
of positions consumed, a Python int so that no step reads the device)
and:
- dense, moe, vlm: ``"attn": {"k", "v": (L, B, max_len, Hkv, hd), "kv_pos":
  (L, max_len) int32}``; ``kv_pos`` holds each slot's absolute position
  (-1 = empty), so the attention mask stays exact in a ring buffer
  (sliding window: ``max_len == window``, slot ``pos % window``); a vlm
  prompt's image positions take slots like its text;
- audio (whisper): the decoder's ``"attn"`` as above for the text, and
  the cross-attention state ``cross_k`` / ``cross_v`` (L, B, F, Hkv, hd)
  in the cache dtype (F = ``n_audio_frames``), which ``prefill`` fills
  from the encoder's output; beside them the port keeps ``cross_pos``,
  ``arange(F)`` int32 on the cache's device, the slot positions that
  ``decode_step`` hands L3 for every cross-attention call;
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
step.

The int8 cache (``kv_quant``, the dense, moe and vlm families): ``k`` and
``v`` int8 (L, B, max_len, Hkv, hd) with f32 ``k_scale`` / ``v_scale``
(L, B, max_len, Hkv), one scale per slot and head (``quantize_kv``).
Only ``model.decode_step`` fills it, one token at a time, as in the
reference, whose ``prefill`` casts K/V into it without scales.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTENTION_FAMILIES, ArchConfig


def attn_cache_init(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None, quant: bool = False):
    """Empty K/V of ``max_len`` slots per layer (``kv_pos`` -1); with
    ``quant`` int8 values and their f32 per (slot, head) scales."""
    dev = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    vdtype = torch.int8 if quant else dtype
    cache = {
        "k": torch.zeros(shape, dtype=vdtype, device=dev),
        "v": torch.zeros(shape, dtype=vdtype, device=dev),
        "kv_pos": torch.full((n_layers, max_len), -1, dtype=torch.int32,
                             device=dev),
    }
    if quant:
        cache.update(k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev),
                     v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev))
    return cache


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, (...) f32 scales): scale = max(amax
    over hd, 1e-6) / 127 in f32, values clip(round(x / scale), ±127),
    rounded half to even as ``jnp.round`` rounds."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cache_slot(max_len: int, pos: int, ring: bool) -> int:
    """The slot position ``pos`` is written to: ``pos % max_len`` in a
    ring, else ``pos`` clamped to the last slot."""
    return pos % max_len if ring else min(pos, max_len - 1)


def attn_cache_update(cache_layer_k, cache_layer_v, kv_pos, k_new, v_new,
                      pos: int, ring: bool, k_scale=None, v_scale=None):
    """Write one token (k_new/v_new: (B, 1, Hkv, hd)) of one layer at
    absolute position ``pos``, in place (cast to the cache dtype): at slot
    ``pos % max_len`` in a ring, else at ``pos`` clamped to the last slot,
    as the reference's ``dynamic_update_slice`` clamps it. An int8 cache
    takes ``quantize_kv``'s values, and its scales go to ``k_scale`` /
    ``v_scale`` (B, max_len, Hkv) at the same slot."""
    slot = cache_slot(cache_layer_k.shape[1], pos, ring)
    if cache_layer_k.dtype == torch.int8:
        for c, sc, new in ((cache_layer_k, k_scale, k_new),
                           (cache_layer_v, v_scale, v_new)):
            q, scale = quantize_kv(new[:, 0])
            c[:, slot].copy_(q)
            sc[:, slot].copy_(scale)
    else:
        cache_layer_k[:, slot].copy_(k_new[:, 0])
        cache_layer_v[:, slot].copy_(v_new[:, 0])
    kv_pos[slot] = pos


# the families whose reference decode reads an int8 cache: the audio
# family's decode unpacks its cross cache where the scales would be, and
# the hybrid and ssm families build no quantized cache
QUANT_FAMILIES = ("dense", "moe", "vlm")


def serve_cache_init(cfg: ArchConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16,
                     window_override: Optional[int] = None, device=None,
                     kv_quant: bool = False):
    """The serving state of ``cfg``'s family for a context of ``seq_len``
    tokens: a dense model gets ``seq_len`` slots, or ``window`` slots (a
    ring) under sliding-window attention; recurrent layers get constant
    state. ``kv_quant``: the int8 cache (``QUANT_FAMILIES`` only).
    ``device="meta"`` gives the state's shapes and dtypes without
    allocating it (``steps.cache_specs``)."""
    from repro_torch.models.mamba2 import mamba2_state_init
    if kv_quant and cfg.family not in QUANT_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family has no int8 cache: the reference's "
            "decode reads one only for the "
            f"{', '.join(QUANT_FAMILIES)} families (its audio decode "
            "unpacks the cross cache where the scales would be; its hybrid "
            "and ssm states build none)")
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
            "the dense, moe, vlm, audio, hybrid and ssm families")
    max_len = window if window > 0 else seq_len
    cache = {"pos": 0,
             "attn": attn_cache_init(cfg, cfg.n_layers, batch, max_len, dtype,
                                     device=dev, quant=kv_quant)}
    if cfg.is_encdec:
        F = cfg.n_audio_frames
        shape = (cfg.n_layers, batch, F, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache.update(
            cross_k=torch.zeros(shape, dtype=dtype, device=dev),
            cross_v=torch.zeros(shape, dtype=dtype, device=dev),
            cross_pos=torch.arange(F, dtype=torch.int32, device=dev))
    return cache
