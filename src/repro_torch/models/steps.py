"""Step functions (port of ``repro/models/steps.py``): the loss and the
train step of every family, and the serving steps of every family; and
the same steps as SPMD programs over a ('data', 'model') mesh
(``make_sharded_*``, ``models.sharded``: the counterparts of the
reference's steps jitted with its shardings).

The factories close over the configs, as the reference's do, so a caller
holds only params, optimizer state, batch and cache. ``make_train_step``'s
step updates the parameters (a ``CausalLM`` in the f32 training layout,
``model.init_params(..., train=True)``) and the AdamW state in place and
returns them with the step's metrics.

The input specs (``params_specs``, ``opt_specs``, ``batch_specs``,
``cache_specs``, ``cache_specs_quant``, ``decode_token_specs``) are the
structures the steps take, built on ``torch.device("meta")``: shapes and
dtypes with no storage, the counterpart of the reference's
``jax.eval_shape`` / ``ShapeDtypeStruct``. Nothing on ``meta`` launches or
plans a kernel. ``long_context_window`` gives the window a full-attention
model runs ``long_500k`` under.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.models import model as MODEL
from repro_torch.models.kvcache import serve_cache_init
from repro_torch.models.sharded import (  # noqa: F401  (the SPMD steps)
    make_sharded_prefill_step, make_sharded_serve_step,
    make_sharded_train_step)
from repro_torch.optim import adamw, schedules

# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, mask):
    """logits: (B, S, V) f32; labels: (B, S) int; mask: (B, S) f32. The
    masked mean of logsumexp(logits) − logits[label].

    The reference takes the gold logit with a one-hot contraction: under
    GSPMD a gather along the vocabulary-sharded axis would all-gather the
    whole (B, S, V) tensor, while the contraction stays sharded. Here the
    logits are whole, and ``torch.gather`` picks the same number (the
    other terms of the contraction are exact zeros) without a third (B, S,
    V) f32 tensor; the sharded steps (``models.sharded``) take each
    shard's logsumexp and the gold logit from the shard that owns it."""
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

    def train_step(params, opt_state: adamw.AdamWState, batch,
                   grads_out=None):
        """One AdamW update from ``batch`` (every entry split into
        ``tcfg.microbatches`` equal row chunks whose f32 gradients are
        summed, then averaged, as the reference's scan does), with global
        clipping and the 1-based lr step. Returns (params, opt_state,
        metrics with loss, grad_norm, lr and any aux, as 0-dim
        tensors). With ``grads_out`` (a dict) it also puts there a copy
        of the averaged gradients by name, before the clipping."""
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
        if grads_out is not None:
            grads_out.update({n: g.clone() for n, g in grads.items()})
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
        """A fresh cache of ``shape.seq_len`` slots, or of
        ``window_override`` (a ring; the prompt still attends with
        ``cfg.sliding_window``, as in the reference: only the cache's size
        follows the override), bf16 on the tokens' device (a vlm prompt's
        image positions take slots too; an audio model's cross state holds
        ``n_audio_frames``), filled from the prompt; returns (last logits,
        cache)."""
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


# ---------------------------------------------------------------------------
# Input specs (on the meta device: no allocation)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def params_specs(cfg: ArchConfig) -> MODEL.CausalLM:
    """``cfg``'s ``CausalLM`` on ``meta`` with ``model.init_params``'s
    names and shapes, f32 for every family: the reference's
    ``init_params`` layout (its master weights; the port's
    ``init_params(..., train=True)``)."""
    return MODEL.build(
        cfg, lambda name, shape: _meta(shape, torch.float32)
    ).requires_grad_(False)


def opt_specs(cfg: ArchConfig) -> adamw.AdamWState:
    """The AdamW state of ``params_specs(cfg)`` on ``meta``: f32 moments
    by parameter name, ``step`` 0."""
    return adamw.init(dict(params_specs(cfg).named_parameters()))


def batch_specs(cfg: ArchConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """The training / prefill batch of one (arch, shape) on ``meta``:
    tokens (B, S) int32; a vlm batch's text is S − n_image_tokens long
    beside its bf16 ``image_embeds``; an audio batch carries bf16
    ``audio_embeds`` (B, n_audio_frames, d)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        return {"tokens": _meta((B, S - n_img), torch.int32),
                "image_embeds": _meta((B, n_img, cfg.d_model),
                                      torch.bfloat16)}
    if cfg.family == "audio":
        return {"tokens": _meta((B, S), torch.int32),
                "audio_embeds": _meta((B, cfg.n_audio_frames, cfg.d_model),
                                      torch.bfloat16)}
    return {"tokens": _meta((B, S), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: InputShape,
                window_override: Optional[int] = None) -> Dict[str, Any]:
    """``serve_cache_init``'s state for one (arch, shape) on ``meta``
    (``pos`` stays the Python int 0)."""
    return serve_cache_init(cfg, shape.global_batch, shape.seq_len,
                            window_override=window_override, device=META)


def cache_specs_quant(cfg: ArchConfig, shape: InputShape,
                      window_override: Optional[int] = None
                      ) -> Dict[str, Any]:
    """The int8 cache's state (``kv_quant=True``) on ``meta``."""
    return serve_cache_init(cfg, shape.global_batch, shape.seq_len,
                            window_override=window_override, device=META,
                            kv_quant=True)


def decode_token_specs(shape: InputShape) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def long_context_window(cfg: ArchConfig, shape: InputShape
                        ) -> Optional[int]:
    """The window override of a full-attention dense, vlm or moe model at
    long_500k (``model.LONG_CONTEXT_WINDOW``; DESIGN.md §4), else None."""
    if (shape.name == "long_500k" and cfg.family in ("dense", "vlm", "moe")
            and cfg.sliding_window == 0):
        return MODEL.LONG_CONTEXT_WINDOW
    return None
