"""Synthetic token batches for the LLM stack (no dataset is downloaded).

Port of ``repro/data/tokens.py``: a deterministic mixture of periodic
repeats, arithmetic progressions mod V and bigram walks over a small
alphabet slice, drawn from ``numpy.random.default_rng(seed)`` in the same
order, so both packages yield identical tokens for one seed. A vlm batch
also carries stub image embeddings (``image_embeds`` (batch,
n_image_tokens, d_model) bf16), an audio batch stub frame embeddings
(``audio_embeds`` (batch, n_audio_frames, d_model) bf16), drawn from the
same generator after the tokens, as the reference draws them.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def synthetic_token_batches(cfg: ArchConfig, batch: int, seq: int,
                            seed: int = 0, device=None) -> Iterator[dict]:
    """``{"tokens": (batch, seq) int32}`` (and a vlm batch's
    ``image_embeds``, an audio batch's ``audio_embeds``) on ``device``
    (the GPU unless the caller names another), one batch per ``next``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size

    def make_seq():
        kind = rng.integers(0, 3)
        if kind == 0:        # periodic repeats
            period = int(rng.integers(2, 8))
            base = rng.integers(0, V, period)
            return np.tile(base, seq // period + 1)[:seq]
        if kind == 1:        # arithmetic progression mod V
            start = int(rng.integers(0, V))
            stride = int(rng.integers(1, 7))
            return (start + stride * np.arange(seq)) % V
        # Markov-ish bigram walk over a small alphabet slice
        lo = int(rng.integers(0, max(V - 64, 1)))
        out = [int(rng.integers(lo, lo + 64))]
        for _ in range(seq - 1):
            out.append(lo + (out[-1] - lo + int(rng.integers(0, 3))) % 64)
        return np.asarray(out)

    # the frontend stub's embeddings, drawn after the tokens
    stub = {"vlm": ("image_embeds", cfg.n_image_tokens),
            "audio": ("audio_embeds", cfg.n_audio_frames)}.get(cfg.family)
    while True:
        toks = np.stack([make_seq() for _ in range(batch)]).astype(np.int32)
        b = {"tokens": torch.from_numpy(toks).to(dev)}
        if stub is not None:
            key, n = stub
            emb = rng.normal(size=(batch, n, cfg.d_model))
            b[key] = torch.from_numpy(emb).to(torch.bfloat16).to(dev)
        yield b
