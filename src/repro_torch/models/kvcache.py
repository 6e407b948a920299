"""KV cache of the dense family's serving path (port of
``repro/models/kvcache.py``, dense branch).

The cache is a dict like the reference's pytree: ``{"pos": int,
"attn": {"k", "v": (L, B, max_len, Hkv, hd), "kv_pos": (L, max_len)
int32}}``; ``kv_pos`` holds each slot's absolute position (-1 = empty), so
the attention mask stays exact in a ring buffer (sliding window:
``max_len == window``, slot ``pos % window``). ``pos`` is the number of
tokens consumed, a Python int so that no step reads the device.

Where the reference is functional and returns a new cache, the port
writes in place (``attn_cache_update``, ``model.prefill``): that saves a
copy of the whole cache on every step. The int8 cache (``kv_quant``) and
the recurrent states of the other families are not ported yet (ROADMAP
A.17, A.18, A.20).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


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
    """The serving state of a dense model: ``seq_len`` slots, or
    ``window`` slots (a ring) under sliding-window attention."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} serving state is not ported yet; the port serves "
            "the dense family")
    window = (window_override if window_override is not None
              else cfg.sliding_window)
    max_len = window if window > 0 else seq_len
    return {"pos": 0,
            "attn": attn_cache_init(cfg, cfg.n_layers, batch, max_len, dtype,
                                    device=device)}
