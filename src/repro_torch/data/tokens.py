"""Synthetic token batches for the LLM stack (no dataset is downloaded).

Port of ``repro/data/tokens.py``: a deterministic mixture of periodic
repeats, arithmetic progressions mod V and bigram walks over a small
alphabet slice, drawn from ``numpy.random.default_rng(seed)`` in the same
order, so both packages yield identical tokens for one seed.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def synthetic_token_batches(cfg: ArchConfig, batch: int, seq: int,
                            seed: int = 0, device=None) -> Iterator[dict]:
    """``{"tokens": (batch, seq) int32}`` on ``device`` (the GPU unless the
    caller names another), one batch per ``next``."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches carry stub embeddings; that family is not "
            "ported yet (ROADMAP A.20)")
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

    while True:
        toks = np.stack([make_seq() for _ in range(batch)]).astype(np.int32)
        yield {"tokens": torch.from_numpy(toks).to(dev)}
