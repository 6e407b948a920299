"""Serving step functions of the dense family (port of the serving half of
``repro/models/steps.py``).

``make_prefill_step`` and ``make_serve_step`` close over the config, as
the reference's do, so a caller holds only params, batch and cache. The
loss, the train step and the optimizer come with the training slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model as MODEL
from repro_torch.models.kvcache import serve_cache_init


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      window_override: Optional[int] = None):
    def prefill_step(params, batch):
        """A fresh cache of ``shape.seq_len`` slots (bf16, on the tokens'
        device), filled from the prompt; returns (last logits, cache)."""
        tokens = batch["tokens"]
        cache = serve_cache_init(cfg, tokens.shape[0], shape.seq_len,
                                 window_override=window_override,
                                 device=tokens.device)
        return MODEL.prefill(params, cfg, batch, cache)

    return prefill_step


def make_serve_step(cfg: ArchConfig, window_override: Optional[int] = None):
    def serve_step(params, cache, tokens):
        return MODEL.decode_step(params, cfg, cache, tokens,
                                 window_override=window_override)

    return serve_step
