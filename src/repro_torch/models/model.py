"""Dense-family model: init, forward (with gradient and remat), prefill and
decode (port of ``repro/models/model.py``, dense branch).

embed -> one ``DenseBlock`` per layer (attention + SwiGLU, pre-norm) ->
final norm -> unembed. A Python loop over ``nn.Module`` blocks takes the
place of the reference's ``lax.scan`` over stacked (L, …) weights; the
stacked layout survives only in ``convert.llm_params_from_numpy``.

Serving keeps the reference's semantics: ``prefill`` attends with
``cfg.sliding_window`` (not a window override) and keeps the last
``max_len`` positions at ring-aligned slots; ``decode_step`` treats the
cache as a ring iff ``window > 0 and max_len <= window``. Two places differ
on purpose, for the same result:
- ``decode_step`` projects the new token's q/k/v once; the reference calls
  attention once more only to obtain K/V and lets ``jit`` drop the unused
  output, which an eager port would launch.
- ``prefill`` writes each layer's K/V straight into its cache slots
  instead of stacking all layers' K/V first ((L, B, S, Hkv, hd), 4.7 GB at
  Qwen3-4B with B = 8, S = 4000).
``forward`` is differentiable: with ``remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` around the scanned block, so its
activations are recomputed in the backward pass; ``remat_policy="dots"``
keeps the matrix products' outputs (``dots_saveable``) through selective
checkpointing. ``prefill`` and ``decode_step`` run without gradient.
Families other than dense raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as CKPT

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

# the reference's _cast_tree: float arrays with ndim >= 2 and more than this
# many elements are kept in the compute dtype, the rest in f32
CAST_MIN_SIZE = 16384


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_dense(cfg: ArchConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs the "
            "dense family (see ROADMAP section A)")


class DenseBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, ln1, attn: L.Attention, ln2,
                 mlp: L.SwiGLU):
        super().__init__()
        self.ln1 = L.RMSNorm(ln1, cfg.norm_eps)
        self.attn = attn
        self.ln2 = L.RMSNorm(ln2, cfg.norm_eps)
        self.mlp = mlp

    def forward(self, x, rope, rot_dim, *, pos=0, window=0, cache=None):
        a, kv = self.attn(self.ln1(x), rope, rot_dim, pos=pos, window=window,
                          cache=cache)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv


class DenseLM(nn.Module):
    """Parameters of a dense model: ``table`` (Vp, d), ``unembed`` (d, Vp)
    unless the embeddings are tied, ``final_norm`` and ``blocks``."""

    def __init__(self, cfg: ArchConfig, table, unembed, final_norm,
                 blocks):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.unembed = None if unembed is None else nn.Parameter(unembed)
        self.final_norm = L.RMSNorm(final_norm, cfg.norm_eps)
        self.blocks = nn.ModuleList(blocks)

    def unembed_weight(self):
        return self.table.T if self.unembed is None else self.unembed

    def rope(self, pos: int, S: int):
        cfg = self.cfg
        inv_freq, rot_dim = L.rope_frequencies(
            cfg.resolved_head_dim, cfg.rope_partial, cfg.rope_theta,
            device=self.table.device)
        positions = torch.arange(pos, pos + S, device=self.table.device)
        return L.rope_angles(positions, inv_freq), rot_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, *, train: bool = False) -> DenseLM:
    """Seeded random weights, made per tensor on ``device`` (the GPU unless
    the caller names another): matmul weights are normal × 1/√fan_in and
    embeddings normal × 0.02; norm scales are ones in f32. ``generator``
    must live on ``device``; both storages draw the same numbers.

    ``train=False`` (serving) stores the matrices and embeddings in
    ``cfg.dtype`` without gradient: the layout the reference computes with
    after ``_cast_tree``, and no f32 copy of the whole model exists at any
    time. ``train=True`` keeps every parameter in f32 with a gradient: the
    reference's own master layout, which ``forward`` casts at use."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = torch.float32 if train else compute_dtype(cfg)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=dev)
        return w.mul_(scale).to(dt)

    def dense(shape):
        return normal(shape, 1.0 / math.sqrt(shape[0]))

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    d, hd, Vp = cfg.d_model, cfg.resolved_head_dim, cfg.padded_vocab_size
    table = normal((Vp, d), 0.02)
    unembed = None if cfg.tie_embeddings else dense((d, Vp))
    blocks = []
    for _ in range(cfg.n_layers):
        attn = L.Attention(
            cfg, dense((d, cfg.n_heads * hd)), dense((d, cfg.n_kv_heads * hd)),
            dense((d, cfg.n_kv_heads * hd)), dense((cfg.n_heads * hd, d)),
            ones(hd) if cfg.qk_norm else None,
            ones(hd) if cfg.qk_norm else None)
        mlp = L.SwiGLU(dense((d, cfg.d_ff)), dense((d, cfg.d_ff)),
                       dense((cfg.d_ff, d)))
        blocks.append(DenseBlock(cfg, ones(d), attn, ones(d), mlp))
    return DenseLM(cfg, table, unembed, ones(d), blocks).requires_grad_(train)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def _final_logits(params: DenseLM, x):
    x = params.final_norm(x)
    return L.unembed(params.unembed_weight(), x, params.cfg)


def _block_out(block, x, rope, rot_dim, window):
    return block(x, rope, rot_dim, window=window)[0]


# the projections' and the MLP's products ((B, S, d) @ (d, n) folds to mm);
# attention is one opaque kernel call, recomputed, as the reference's Pallas
# call is (its plain CPU version's batched products are not saved either)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_saveable``: keep matrix-product outputs,
    recompute everything else."""
    return (CKPT.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CKPT.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(policy: str):
    """The block wrapper for ``remat_policy`` (the reference's
    ``_remat_policy``): "full" recomputes the whole block, "dots" keeps
    the matmul outputs."""
    if policy in (None, "full"):
        return functools.partial(CKPT.checkpoint, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            CKPT.checkpoint, use_reentrant=False,
            context_fn=functools.partial(
                CKPT.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(policy)


def forward(params: DenseLM, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward: ``batch["tokens"]`` (B, S) -> (logits
    (B, S, Vp) f32, aux = {}). Differentiable; with ``remat`` (and autograd
    recording) each block is checkpointed as ``remat_policy`` says."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed(params.table, tokens, compute_dtype(cfg))
    rope, rot_dim = params.rope(0, tokens.shape[1])
    window = cfg.sliding_window
    run = (_remat(remat_policy) if remat and torch.is_grad_enabled()
           else None)
    for block in params.blocks:
        if run is None:
            x = _block_out(block, x, rope, rot_dim, window)
        else:
            x = run(_block_out, block, x, rope, rot_dim, window)
    return _final_logits(params, x), {}


@torch.no_grad()
def prefill(params: DenseLM, cfg: ArchConfig, batch, cache):
    """Consume the prompt ``batch["tokens"]`` (B, S), fill ``cache`` in
    place and return (last-token logits (B, 1, Vp) f32, cache).

    Each layer's K/V of the last ``keep = min(S, max_len)`` positions go
    to slots ``position % max_len``, so decode-time ring writes evict the
    oldest entry; other slots are zeroed and marked empty, as the
    reference's fresh cache."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(params.table, tokens, compute_dtype(cfg))
    rope, rot_dim = params.rope(0, S)
    ck, cv, kv_pos = (cache["attn"][n] for n in ("k", "v", "kv_pos"))
    max_len = ck.shape[2]
    keep = min(S, max_len)
    pos_kept = torch.arange(S - keep, S, dtype=torch.int32, device=x.device)
    slots = (pos_kept % max_len).long()
    for li, block in enumerate(params.blocks):
        x, (k1, v1) = block(x, rope, rot_dim, window=cfg.sliding_window)
        for c, new in ((ck, k1), (cv, v1)):
            c[li].index_copy_(1, slots, new[:, S - keep:].to(c.dtype))
            if keep < max_len:
                c[li, :, keep:].zero_()
    kv_pos.fill_(-1)
    kv_pos[:, slots] = pos_kept
    cache["pos"] = S
    return _final_logits(params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: DenseLM, cfg: ArchConfig, cache, tokens,
                window_override=None):
    """One autoregressive step: ``tokens`` (B, 1) at position
    ``cache["pos"]``. Writes the token's K/V into ``cache`` in place and
    returns (logits (B, 1, Vp) f32, cache) with ``pos`` advanced."""
    _check_dense(cfg)
    pos = cache["pos"]
    window = (window_override if window_override is not None
              else cfg.sliding_window)
    ck, cv, kv_pos = (cache["attn"][n] for n in ("k", "v", "kv_pos"))
    ring = window > 0 and ck.shape[2] <= window
    x = L.embed(params.table, tokens, compute_dtype(cfg))
    rope, rot_dim = params.rope(pos, 1)
    for li, block in enumerate(params.blocks):
        x, _ = block(x, rope, rot_dim, pos=pos, window=window,
                     cache=(ck[li], cv[li], kv_pos[li], ring))
    cache["pos"] = pos + 1
    return _final_logits(params, x), cache
