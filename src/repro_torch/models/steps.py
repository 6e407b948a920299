"""Step functions (port of ``repro/models/steps.py``): the loss and the
train step of the dense, moe, vlm and audio families, and the serving
steps of every family.

The factories close over the configs, as the reference's do, so a caller
holds only params, optimizer state, batch and cache. ``make_train_step``'s
step updates the parameters (a ``CausalLM`` in the f32 training layout,
``model.init_params(..., train=True)``) and the AdamW state in place and
returns them with the step's metrics.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.models import model as MODEL
from repro_torch.models.kvcache import serve_cache_init
from repro_torch.optim import adamw, schedules

# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, mask):
    """logits: (B, S, V) f32; labels: (B, S) int; mask: (B, S) f32. The
    masked mean of logsumexp(logits) − logits[label].

    The reference takes the gold logit with a one-hot contraction: under
    GSPMD a gather along the vocabulary-sharded axis would all-gather the
    whole (B, S, V) tensor, while the contraction stays sharded. The port
    shards nothing, and ``torch.gather`` picks the same number (the other
    terms of the contraction are exact zeros) without a third (B, S, V)
    f32 tensor."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch, *, remat=True,
            remat_policy="full"):
    """Next-token cross entropy over the text stream ``batch["tokens"]``
    (B, S) (a vlm batch's image positions give no loss; an audio batch's
    ``audio_embeds`` feed the encoder and have no logits), plus 0.01 ×
    ``moe_aux`` for the moe family: returns (loss, metrics = {"loss":
    loss, **aux})."""
    logits, aux = MODEL.forward(params, cfg, batch, remat=remat,
                                remat_policy=remat_policy)
    tokens = batch["tokens"]
    S_text = tokens.shape[1]
    labels = tokens[:, 1:]
    pred = logits[:, -S_text:][:, :-1]
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    loss = cross_entropy(pred, labels, mask)
    if "moe_aux" in aux:
        loss = loss + 0.01 * aux["moe_aux"]
    return loss, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    lr_fn = schedules.warmup_cosine(tcfg)

    def train_step(params, opt_state: adamw.AdamWState, batch):
        """One AdamW update from ``batch`` (every entry split into
        ``tcfg.microbatches`` equal row chunks whose f32 gradients are
        summed, then averaged, as the reference's scan does), with global
        clipping and the 1-based lr step. Returns (params, opt_state,
        metrics with loss, grad_norm, lr and any aux, as 0-dim
        tensors)."""
        M = tcfg.microbatches
        rows = batch["tokens"].shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} rows does not "
                             f"split into {M} microbatches")
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        metrics = {}
        for i in range(M):
            chunk = {k: v[i * rows // M:(i + 1) * rows // M]
                     for k, v in batch.items()}
            loss, mb_metrics = loss_fn(params, cfg, chunk,
                                       remat=tcfg.remat,
                                       remat_policy=tcfg.remat_policy)
            loss.backward()       # accumulates f32 gradients in .grad
            for k, v in mb_metrics.items():
                v = v.detach()
                metrics[k] = metrics[k] + v if k in metrics else v
        grads = {n: p.grad for n, p in named.items()}
        if M > 1:
            for g in grads.values():
                g.div_(M)
            metrics = {k: v / M for k, v in metrics.items()}
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        lr = lr_fn(opt_state.step + 1)   # 1-based so warmup never yields 0
        opt_state = adamw.apply(named, grads, opt_state, tcfg, lr)
        for p in named.values():
            p.grad = None
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      window_override: Optional[int] = None):
    def prefill_step(params, batch):
        """A fresh cache of ``shape.seq_len`` slots (bf16, on the tokens'
        device; a vlm prompt's image positions take slots too; an audio
        model's cross state holds ``n_audio_frames``), filled from the
        prompt; returns (last logits, cache)."""
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
