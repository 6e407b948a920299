"""Model assembly for the dense, moe, vlm, hybrid and ssm families: init,
forward, prefill and decode (port of ``repro/models/model.py``).

- dense  (qwen3, llama3, minitron, chatglm3): embed -> one ``DenseBlock``
  per layer (attention + SwiGLU, pre-norm) -> final norm -> unembed.
- moe    (granite-moe, mixtral): the same with the MoE MLP
  (``moe.MoE``); ``forward`` returns the layers' mean ``moe_aux`` and
  ``moe_dropped``.
- vlm    (internvl2): the dense stack over the stub image embeddings
  (``batch["image_embeds"]`` (B, n_image_tokens, d)) placed before the
  text in ``forward`` and ``prefill``; it decodes as dense.
- hybrid (zamba2): embed -> groups of ``shared_attn_period`` Mamba2 layers
  (``MambaBlock``), each full group followed by the one weight-tied
  ``DenseBlock`` ``shared_attn`` -> final norm -> unembed. A remainder
  group gets no attention.
- ssm (rwkv6): embed -> one ``RwkvBlock`` per layer (time-mix +
  channel-mix, pre-norm) -> final norm -> unembed.

A Python loop over ``nn.Module`` blocks takes the place of the
reference's ``lax.scan`` over stacked (L, …) weights; the stacked layout
survives only in ``convert``.

Serving keeps the reference's semantics: the dense ``prefill`` attends
with ``cfg.sliding_window`` (not a window override) and keeps the last
``max_len`` positions at ring-aligned slots; the dense ``decode_step``
treats the cache as a ring iff ``window > 0 and max_len <= window``. The
hybrid family's shared block always attends with the ring's size as its
window, in prefill and decode, and its ring is always a ring. The
recurrent states (conv histories, SSD and WKV states, token shifts) carry
over from the cache into ``prefill`` as in the reference, and every state
is updated in place. Two places differ on purpose, for the same result:
- ``decode_step`` projects the new token's q/k/v once; the reference calls
  attention once more only to obtain K/V and lets ``jit`` drop the unused
  output, which an eager port would launch.
- ``prefill`` writes each layer's K/V straight into its cache slots
  instead of stacking all layers' K/V first ((L, B, S, Hkv, hd), 4.7 GB at
  Qwen3-4B with B = 8, S = 4000); the hybrid cache keeps all
  ceil(n_layers / period) ring layers it allocated and writes the first
  n_layers // period, where the reference returns only those.
``forward`` is differentiable: with ``remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` around the scanned block, so its
activations are recomputed in the backward pass; ``remat_policy="dots"``
keeps the matrix products' outputs (``dots_saveable``) through selective
checkpointing. The hybrid and ssm scans (kernels L4, L5) are
forward-only, so those families do not train yet (ROADMAP A.20);
``init_params(..., train=True)`` takes the dense, moe and vlm families.
``prefill`` and ``decode_step`` run without gradient. The audio family
raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as CKPT

from repro_torch import resolve_device
from repro_torch.configs.base import ATTENTION_FAMILIES, FAMILIES, ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6

# the reference's _cast_tree: float arrays with ndim >= 2 and more than this
# many elements are kept in the compute dtype, the rest in f32
CAST_MIN_SIZE = 16384


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs the "
            f"{', '.join(FAMILIES)} families (see ROADMAP section A)")


class DenseBlock(nn.Module):
    """Pre-norm attention and MLP (SwiGLU, or the moe family's MoE), each
    with a residual. Returns (x, this call's (k, v), aux): aux is the MoE's
    ``{"moe_aux", "moe_dropped"}``, else empty."""

    def __init__(self, cfg: ArchConfig, ln1, attn: L.Attention, ln2, mlp):
        super().__init__()
        self.ln1 = L.RMSNorm(ln1, cfg.norm_eps)
        self.attn = attn
        self.ln2 = L.RMSNorm(ln2, cfg.norm_eps)
        self.mlp = mlp
        self.moe = cfg.is_moe      # the MoE returns (y, aux)

    def forward(self, x, rope, rot_dim, *, pos=0, window=0, cache=None):
        a, kv = self.attn(self.ln1(x), rope, rot_dim, pos=pos, window=window,
                          cache=cache)
        x = x + a
        m = self.mlp(self.ln2(x))
        m, aux = m if self.moe else (m, {})
        return x + m, kv, aux


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 mixer with a residual."""

    def __init__(self, cfg: ArchConfig, ln, mixer: M2.Mamba2Mixer):
        super().__init__()
        self.ln = L.RMSNorm(ln, cfg.norm_eps)
        self.mixer = mixer

    def forward(self, x, state):
        a, state = self.mixer(self.ln(x), state)
        return x + a, state


class RwkvBlock(nn.Module):
    """Pre-norm time-mix and channel-mix, each with a residual."""

    def __init__(self, cfg: ArchConfig, ln1, att: R6.TimeMix, ln2,
                 ffn: R6.ChannelMix):
        super().__init__()
        self.ln1 = L.RMSNorm(ln1, cfg.norm_eps)
        self.att = att
        self.ln2 = L.RMSNorm(ln2, cfg.norm_eps)
        self.ffn = ffn

    def forward(self, x, wkv, shift_att, shift_ffn):
        """Returns (x, (wkv, the time-mix's last normed token, the
        channel-mix's))."""
        a, sh_a, wkv = self.att(self.ln1(x), shift_att, wkv)
        x = x + a
        f, sh_f = self.ffn(self.ln2(x), shift_ffn)
        return x + f, (wkv, sh_a, sh_f)


class CausalLM(nn.Module):
    """Parameters of a model: ``table`` (Vp, d), ``unembed`` (d, Vp)
    unless the embeddings are tied, ``final_norm``, ``blocks`` (one module
    per layer) and, for the hybrid family, ``shared_attn``."""

    def __init__(self, cfg: ArchConfig, table, unembed, final_norm,
                 blocks, shared_attn=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.unembed = None if unembed is None else nn.Parameter(unembed)
        self.final_norm = L.RMSNorm(final_norm, cfg.norm_eps)
        self.blocks = nn.ModuleList(blocks)
        self.shared_attn = shared_attn

    def unembed_weight(self):
        return self.table.T if self.unembed is None else self.unembed

    def rope(self, pos: int, S: int):
        cfg = self.cfg
        inv_freq, rot_dim = L.rope_frequencies(
            cfg.resolved_head_dim, cfg.rope_partial, cfg.rope_theta,
            device=self.table.device)
        positions = torch.arange(pos, pos + S, device=self.table.device)
        return L.rope_angles(positions, inv_freq), rot_dim


def hybrid_groups(cfg: ArchConfig):
    """The hybrid family's layer groups as (lo, hi, full): a full group of
    ``shared_attn_period`` layers is followed by the shared block."""
    period, n = cfg.shared_attn_period, cfg.n_layers
    return [(lo, min(lo + period, n), lo + period <= n)
            for lo in range(0, n, period)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def serve_dtype(shape, cfg: ArchConfig, n_stack: int = 0) -> torch.dtype:
    """The reference's ``_cast_tree`` rule for a float array of ``shape``,
    applied as the reference applies it: to the stacked (n_stack, *shape)
    array of a per-layer parameter (``n_stack`` = the layer count), or to
    the array itself (``n_stack`` = 0)."""
    full = ((n_stack,) if n_stack else ()) + tuple(shape)
    return (compute_dtype(cfg) if len(full) >= 2
            and math.prod(full) > CAST_MIN_SIZE else torch.float32)


# leaf name -> how ``init_params`` makes it: "fan_in" (normal × 1/√fan_in,
# or × the given scale), "normal" (× the given scale) or a constant; the
# reference's ``init_params`` makes each the same way. The fan-in of a
# matrix (d_in, d_out) or of a stack of experts' matrices (E, d_in, d_out)
# is d_in: the reference draws each expert's with ``_dense_init`` under
# ``vmap``
_FAN_IN = {n: None for n in (
    "unembed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_z",
    "w_x", "w_B", "w_C", "w_dt", "out_proj", "wr", "wg", "w_in", "w_out")}
_FAN_IN.update(decay_A=0.01, decay_B=0.01, router=0.02)
_NORMAL = {"table": 0.02, "conv_x": 0.2, "conv_B": 0.2, "conv_C": 0.2}
_CONST = {"scale": 1.0, "D": 1.0, "conv_bias_x": 0.0, "conv_bias_B": 0.0,
          "conv_bias_C": 0.0, "dt_bias": -2.0, "mix_base": 0.5,
          "decay_w0": -6.0, "bonus_u": 0.0}


def build(cfg: ArchConfig, param) -> CausalLM:
    """The model of ``cfg``'s family with each parameter taken from
    ``param(name, shape)``, ``name`` its ``named_parameters`` name (the
    reference's pytree path, with ``blocks.<i>.`` for layer i). Parameters
    are made in a fixed order."""
    _check_family(cfg)
    d, Vp = cfg.d_model, cfg.padded_vocab_size
    table = param("table", (Vp, d))
    unembed = None if cfg.tie_embeddings else param("unembed", (d, Vp))

    def dense_block(pre):
        hd = cfg.resolved_head_dim
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        attn = L.Attention(
            cfg, param(pre + "attn.wq", (d, nq)),
            param(pre + "attn.wk", (d, nkv)), param(pre + "attn.wv", (d, nkv)),
            param(pre + "attn.wo", (nq, d)),
            *((param(pre + "attn.q_norm.scale", (hd,)),
               param(pre + "attn.k_norm.scale", (hd,))) if cfg.qk_norm
              else ()))
        f = cfg.d_ff
        if cfg.family == "moe":
            E = cfg.n_experts
            mlp = MOE.MoE(cfg, *(param(pre + "mlp." + n, shape)
                                 for n, shape in (
                                     ("router", (d, E)), ("w_gate", (E, d, f)),
                                     ("w_up", (E, d, f)),
                                     ("w_down", (E, f, d)))))
        else:
            mlp = L.SwiGLU(*(param(pre + "mlp." + n, shape)
                             for n, shape in (("w_gate", (d, f)),
                                              ("w_up", (d, f)),
                                              ("w_down", (f, d)))))
        return DenseBlock(cfg, param(pre + "ln1.scale", (d,)), attn,
                          param(pre + "ln2.scale", (d,)), mlp)

    def mamba_block(pre):
        d_in, H, N, P = M2.mamba2_dims(cfg)
        W = cfg.ssm_conv_width
        shapes = dict(w_z=(d, d_in), w_x=(d, d_in), w_B=(d, N), w_C=(d, N),
                      w_dt=(d, H), conv_x=(W, d_in), conv_B=(W, N),
                      conv_C=(W, N), conv_bias_x=(d_in,), conv_bias_B=(N,),
                      conv_bias_C=(N,), A_log=(H,), D=(H,), dt_bias=(H,),
                      out_proj=(d_in, d))
        mixer = M2.Mamba2Mixer(
            cfg, {n: param(pre + "mixer." + n, shapes[n])
                  for n in M2.PARAM_NAMES},
            param(pre + "mixer.norm.scale", (d_in,)))
        return MambaBlock(cfg, param(pre + "ln.scale", (d,)), mixer)

    def rwkv_block(pre):
        f = cfg.d_ff
        shapes = dict(mix_base=(5, d), wr=(d, d), wk=(d, d), wv=(d, d),
                      wg=(d, d), wo=(d, d), decay_w0=(d,),
                      decay_A=(d, R6.LORA_R), decay_B=(R6.LORA_R, d),
                      bonus_u=(d,))
        att = R6.TimeMix(cfg, {n: param(pre + "att." + n, shapes[n])
                               for n in R6.TIMEMIX_NAMES},
                         param(pre + "att.ln_out.scale", (d,)))
        shapes = dict(mix_base=(1, d), w_in=(d, f), w_out=(f, d))
        ffn = R6.ChannelMix(cfg, {n: param(pre + "ffn." + n, shapes[n])
                                  for n in R6.CHANNELMIX_NAMES})
        return RwkvBlock(cfg, param(pre + "ln1.scale", (d,)), att,
                         param(pre + "ln2.scale", (d,)), ffn)

    make = {"dense": dense_block, "moe": dense_block, "vlm": dense_block,
            "hybrid": mamba_block, "ssm": rwkv_block}[cfg.family]
    blocks = [make(f"blocks.{i}.") for i in range(cfg.n_layers)]
    shared = dense_block("shared_attn.") if cfg.family == "hybrid" else None
    return CausalLM(cfg, table, unembed, param("final_norm.scale", (d,)),
                    blocks, shared)


def check_trainable(cfg: ArchConfig, train: bool):
    if train and cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family} family is not ported: its scan "
            "kernel has no backward (ROADMAP A.20)")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, *, train: bool = False) -> CausalLM:
    """Seeded random weights, made per tensor on ``device`` (the GPU unless
    the caller names another) as the reference's ``init_params`` makes
    them: matmul weights normal × 1/√fan_in, embeddings normal × 0.02,
    norm scales ones, the mixers' other parameters as in ``mamba2_init``
    and ``timemix_init``. ``generator`` must live on ``device``; both
    storages draw the same numbers.

    ``train=False`` (serving) stores every parameter without gradient in
    the dtype the reference computes with after ``_cast_tree``
    (``serve_dtype``), and no f32 copy of the whole model exists at any
    time (a stack of experts is one tensor). ``train=True`` (the dense, moe
    and vlm families) keeps every parameter in f32 with a gradient: the
    reference's own master layout, which ``forward`` casts at use."""
    _check_family(cfg)
    check_trainable(cfg, train)
    dev = resolve_device(device)

    def param(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _FAN_IN or leaf in _NORMAL:
            scale = (_NORMAL.get(leaf) or _FAN_IN[leaf]
                     or 1.0 / math.sqrt(shape[-2]))
            w = torch.randn(shape, generator=generator, device=dev)
            w.mul_(scale)
        elif leaf == "A_log":
            w = torch.log(torch.linspace(1.0, 16.0, shape[0], device=dev))
        else:
            w = torch.full(shape, _CONST[leaf], dtype=torch.float32,
                           device=dev)
        n_stack = cfg.n_layers if name.startswith("blocks.") else 0
        return w.to(torch.float32 if train
                    else serve_dtype(shape, cfg, n_stack))

    return build(cfg, param).requires_grad_(train)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def _final_logits(params: CausalLM, x):
    x = params.final_norm(x)
    return L.unembed(params.unembed_weight(), x, params.cfg)


# the projections' and the MLP's products ((B, S, d) @ (d, n) folds to mm);
# attention is one opaque kernel call, recomputed, as the reference's Pallas
# call is (its plain CPU version's batched products are not saved either,
# and it writes them in place). The moe family's expert products are bmm
# too, so they are recomputed where the reference's policy keeps them: the
# same values, for more recompute
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


def _embed_inputs(params: CausalLM, cfg: ArchConfig, batch, dtype):
    """The token embeddings, with a vlm batch's ``image_embeds`` placed
    before the text."""
    x = L.embed(params.table, batch["tokens"], dtype)
    if cfg.family == "vlm" and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(dtype), x], dim=1)
    return x


def _mean_aux(auxs):
    """The layers' MoE aux values, each averaged over the layers."""
    if not auxs or not auxs[0]:
        return {}
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def forward(params: CausalLM, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward: ``batch["tokens"]`` (B, S) (and a vlm
    batch's ``image_embeds``) -> (logits (B, S_total, Vp) f32, aux): aux
    holds the moe family's layer means of ``moe_aux`` and ``moe_dropped``,
    else is empty. The recurrent families start from zero states and the
    hybrid shared block attends with ``cfg.sliding_window``, as in the
    reference. Differentiable; with ``remat`` (and autograd recording)
    each block is checkpointed as ``remat_policy`` says."""
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    x = _embed_inputs(params, cfg, batch, dtype)
    B, S = x.shape[:2]
    run = (_remat(remat_policy) if remat and torch.is_grad_enabled()
           else None)

    def call(block, *args, keep=(0,), **kw):
        """The block's outputs at ``keep`` (by default its activations)."""
        def fn(*a, **k):
            out = block(*a, **k)
            return tuple(out[i] for i in keep)
        out = fn(*args, **kw) if run is None else run(fn, *args, **kw)
        return out if len(keep) > 1 else out[0]

    window = cfg.sliding_window
    if cfg.family == "ssm":
        N = cfg.wkv_head_dim
        zero_prev = torch.zeros((B, cfg.d_model), dtype=dtype,
                                device=x.device)
        state0 = torch.zeros((B, cfg.d_model // N, N, N),
                             dtype=torch.float32, device=x.device)
        for block in params.blocks:
            x = call(block, x, state0, zero_prev, zero_prev)
        return _final_logits(params, x), {}

    rope, rot_dim = params.rope(0, S)
    if cfg.family in ATTENTION_FAMILIES:
        auxs = []
        for block in params.blocks:
            x, aux = call(block, x, rope, rot_dim, window=window,
                          keep=(0, 2))
            auxs.append(aux)
        return _final_logits(params, x), _mean_aux(auxs)

    state = M2.mamba2_state_init(cfg, B, dtype, x.device)
    for lo, hi, full in hybrid_groups(cfg):
        for block in params.blocks[lo:hi]:
            x = call(block, x, state)
        if full:
            x = call(params.shared_attn, x, rope, rot_dim, window=window)
    return _final_logits(params, x), {}


def _fill_ring(cache_attn, layer, k1, v1, S: int):
    """Write one layer's prompt K/V (B, S, Hkv, hd) into its ring: the last
    ``keep = min(S, max_len)`` positions at slots ``position % max_len``
    (so decode-time writes evict the oldest entry); other slots are zeroed
    and marked empty, as in the reference's fresh cache."""
    ck, cv, kv_pos = (cache_attn[n] for n in ("k", "v", "kv_pos"))
    max_len = ck.shape[2]
    keep = min(S, max_len)
    pos_kept = torch.arange(S - keep, S, dtype=torch.int32, device=ck.device)
    slots = (pos_kept % max_len).long()
    for c, new in ((ck, k1), (cv, v1)):
        c[layer].index_copy_(1, slots, new[:, S - keep:].to(c.dtype))
        if keep < max_len:
            c[layer, :, keep:].zero_()
    kv_pos[layer].fill_(-1)
    kv_pos[layer, slots] = pos_kept


def _mamba_layer(block, x, states, li):
    """One Mamba block over the cache's layer ``li`` state, in place."""
    x, new = block(x, {n: t[li] for n, t in states.items()})
    for n, t in states.items():
        t[li].copy_(new[n])
    return x


def _rwkv_layer(block, x, cache, li, shift_att, shift_ffn):
    """One RWKV block over the cache's layer ``li`` state, in place."""
    x, (wkv, sh_a, sh_f) = block(x, cache["wkv"][li], shift_att, shift_ffn)
    cache["wkv"][li].copy_(wkv)
    cache["shift_att"][li].copy_(sh_a)
    cache["shift_ffn"][li].copy_(sh_f)
    return x


@torch.no_grad()
def prefill(params: CausalLM, cfg: ArchConfig, batch, cache):
    """Consume the prompt ``batch["tokens"]`` (B, S) (a vlm batch's
    ``image_embeds`` before it, so that S counts the image positions too),
    fill ``cache`` in place and return (last-token logits (B, 1, Vp) f32,
    cache).

    Attention layers keep their K/V of the last ``min(S, max_len)``
    positions at ring-aligned slots (``_fill_ring``); recurrent layers
    run the prompt from the cache's state and store the final one."""
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    x = _embed_inputs(params, cfg, batch, dtype)
    B, S = x.shape[:2]
    if cfg.family == "ssm":
        zero_prev = torch.zeros((B, cfg.d_model), dtype=dtype,
                                device=x.device)
        for li, block in enumerate(params.blocks):
            x = _rwkv_layer(block, x, cache, li, zero_prev, zero_prev)
    elif cfg.family in ATTENTION_FAMILIES:
        rope, rot_dim = params.rope(0, S)
        for li, block in enumerate(params.blocks):
            x, (k1, v1), _ = block(x, rope, rot_dim,
                                   window=cfg.sliding_window)
            _fill_ring(cache["attn"], li, k1, v1, S)
    else:
        rope, rot_dim = params.rope(0, S)
        window = cache["attn"]["k"].shape[2]
        for g, (lo, hi, full) in enumerate(hybrid_groups(cfg)):
            for li in range(lo, hi):
                x = _mamba_layer(params.blocks[li], x, cache["mamba"], li)
            if full:
                x, (k1, v1), _ = params.shared_attn(x, rope, rot_dim,
                                                    window=window)
                _fill_ring(cache["attn"], g, k1, v1, S)
    cache["pos"] = S
    return _final_logits(params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: CausalLM, cfg: ArchConfig, cache, tokens,
                window_override=None):
    """One autoregressive step: ``tokens`` (B, 1) at position
    ``cache["pos"]``. Updates ``cache`` in place (the token's K/V, the
    recurrent states) and returns (logits (B, 1, Vp) f32, cache) with
    ``pos`` advanced. ``window_override`` applies to the dense family; the
    hybrid ring's size is its window. The moe family's decode groups are
    dropless (``moe.groups_and_capacity``)."""
    _check_family(cfg)
    pos = cache["pos"]
    x = L.embed(params.table, tokens, compute_dtype(cfg))
    if cfg.family == "ssm":
        for li, block in enumerate(params.blocks):
            x = _rwkv_layer(block, x, cache, li, cache["shift_att"][li],
                            cache["shift_ffn"][li])
    elif cfg.family in ATTENTION_FAMILIES:
        window = (window_override if window_override is not None
                  else cfg.sliding_window)
        ck, cv, kv_pos = (cache["attn"][n] for n in ("k", "v", "kv_pos"))
        ring = window > 0 and ck.shape[2] <= window
        rope, rot_dim = params.rope(pos, 1)
        for li, block in enumerate(params.blocks):
            x, _, _ = block(x, rope, rot_dim, pos=pos, window=window,
                            cache=(ck[li], cv[li], kv_pos[li], ring))
    else:
        ck, cv, kv_pos = (cache["attn"][n] for n in ("k", "v", "kv_pos"))
        window = ck.shape[2]
        rope, rot_dim = params.rope(pos, 1)
        for g, (lo, hi, full) in enumerate(hybrid_groups(cfg)):
            for li in range(lo, hi):
                x = _mamba_layer(params.blocks[li], x, cache["mamba"], li)
            if full:
                x, _, _ = params.shared_attn(
                    x, rope, rot_dim, pos=pos, window=window,
                    cache=(ck[g], cv[g], kv_pos[g], True))
    cache["pos"] = pos + 1
    return _final_logits(params, x), cache
