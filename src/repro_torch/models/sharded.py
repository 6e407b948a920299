"""The train, prefill and decode steps of every family (dense, vlm, moe,
audio, hybrid, ssm) as SPMD programs over a ('data', 'model') mesh (the
counterpart of the reference's sharded steps: ``jax.jit(step,
in_shardings=..., out_shardings=...)`` under the dry-run mesh, the
program GSPMD derives from ``sharding.partitioning``'s specs).

The port is single-controller: one process drives every slot of a
``launch.mesh.Mesh`` in lockstep, each slot's work on its own CUDA stream
(one card holds every slot), and the collectives run over the mesh's
axes. Each slot holds its shards (``partitioning.place``) as a
``CausalLM`` of the shards, and runs the model's own modules on them:
the norms, the projections (``Attention.columns``, ``norm_rope``,
``SwiGLU.hidden``, ``GeluMLP.hidden``, ``layers.unembed``), the MoE's
stages (``moe.dispatch``, ``expert_hidden``, ``combine``), the mixers'
``Mamba2Mixer.mix`` / ``TimeMix.mix`` / ``ChannelMix.hidden``, and the
kernels L1 (prompt and training forward), L2 (training backward), L3
(decode), L4 and L5 (a prompt's scans) on its heads. Only the block's
order (norm, attention or mixer, residual, [norm, cross-attention,
residual,] norm, MLP, residual) is spelt out again here, since
collectives fall between its pieces. The batch stays where
``batch_specs`` puts it, which is where the reference's carry constraint
keeps it (``ShardedLM.batch_spec`` checks it), so a block boundary moves
nothing. Where the placement demands it:

  - row-parallel outputs: ``wo``, ``mlp/w_down``, ``mlp/w_out``,
    ``mixer/out_proj``, ``att/wo`` and ``ffn/w_out`` give f32 partial
    products, summed over 'model' (``psum``) in f32 and cast once, as the
    unsharded product rounds once; a row-parallel bias (whisper's
    ``mlp/b_out``, replicated) is added once, after the sum;
  - vocab-parallel embedding: ``table`` is split over 'model' by rows, so
    a slot looks up the tokens in its rows (zeros elsewhere) and the
    partials are summed; tied embeddings unembed by the shard's
    transpose, so the logits come out vocab-sharded (``logits_spec``);
  - vocab-parallel loss: the logsumexp from the shards' logsumexps
    gathered over 'model', the gold logit from its owning shard (a psum);
    padded vocabulary columns are -1e9, as unsharded;
  - heads: q, k and v are split by heads where the head count is a
    multiple of 'model'; where a projection's columns are split inside a
    head (``_materialize`` shards ``wk`` by columns), the reference's
    ``constrain(k, batch, None, "model", None)`` leaves those heads
    replicated, so the columns are all-gathered over 'model'
    (``constraints.constrain`` on a ``Sharded`` value). A decode cache
    follows ``cache_specs``: by heads, else by head dim, in which case a
    layer's K/V are gathered over 'model' to whole heads before L3;
  - the int8 cache (dense, moe, vlm): each slot quantizes the token's K/V
    of the whole heads it holds (``quantize_kv``: one scale per head, the
    amax over the whole head dim, also where the cache keeps only part of
    it) and writes its part of the values and of the scales (by heads
    where Hkv divides 'model', else replicated); the layer's int8 K/V are
    gathered over 'model' like bf16 ones and read by the plain
    ``layers.flash_attend``, as unsharded. As unsharded, only decode
    fills it: the sharded prefill refuses one;
  - vlm: each slot puts its rows' ``image_embeds`` before their token
    embeddings; positions count the image prefix, the loss the text;
  - audio: every slot runs the encoder over its rows' ``audio_embeds``
    (non-causal L1 on its heads); cross-attention splits by heads like
    self-attention, its K/V projected from the slot's encoder output; the
    prefill fills each slot's ``cross_k`` / ``cross_v`` shard, decode runs
    L3 over it (``cross_pos`` replicated);
  - moe, expert-parallel where E divides 'model' (``w_*`` over 'model'
    by experts): the model slots of a data row hold the same tokens, so
    each slot routes all of them over all E experts (the capacity ranks
    are per expert, so its experts' are the unsharded ones), runs only
    the pairs of its E / M experts, and the f32 combine partials are
    summed over 'model' and cast once, as the unsharded f32 ``index_add``
    rounds once. Where E does not divide 'model' (the FSDP branch:
    ``w_gate`` / ``w_up`` (E, 'data', 'model'), ``w_down`` (E, 'model',
    'data')) each layer's expert weights are all-gathered over 'data'
    (their gradient comes back reduce-scattered by the gather's autograd
    transpose), every slot runs all experts on its d_ff columns, and
    ``w_down``'s f32 partials are summed over 'model' and cast once
    before the combine, as unsharded. The load-balance loss E · Σ
    frac_tokens · frac_probs is not linear in the tokens: its data slots'
    fractions are averaged over the data axes before the product, and it
    enters the loss once (through the first model slot of each data row,
    as the cross entropy does), so the router's gradient, summed over
    'model' with the other replicated parameters', counts it once;
  - hybrid (Mamba2 layers and the shared attention block): a slot holds
    H / M of the SSD heads (``w_z``, ``w_x``, ``w_dt``, ``conv_x`` and its
    bias, ``A_log``, ``D``, ``dt_bias`` and the gated norm's scale by
    columns or heads) and the whole ``B`` / ``C`` projections and
    convolutions (replicated), and runs L4 (a prompt), ``ssd_step`` (one
    token) or the training scan on its heads; the shared block is the
    dense path's, attending with the ring's size as its window in
    prefill and decode. The decode cache splits the ``conv_B`` /
    ``conv_C`` histories on N, where every slot convolves the whole B and
    C: they are gathered over 'model' before the layer, and each slot
    writes back its part; ``conv_x`` and ``ssm`` line up with its heads;
  - ssm (RWKV6): ``att/wr|wk|wv|wg`` and ``ffn/w_in`` column-parallel
    (whole WKV heads per slot, L5, ``wkv_step`` or the training scan on
    them), the decay, bonus and mixes replicated (a slot computes its
    columns of ``logw`` and ``u``); the token shift and the five mixes act
    on the whole replicated residual, so decode gathers the cache's
    ``shift_att`` / ``shift_ffn`` (split on d) over 'model', and each
    slot stores its part of the new ones; ``wkv`` splits by heads;
  - norms over a split dimension (the Mamba2 gated norm over d_inner,
    RWKV6's ``ln_out`` over d): each slot's f32 Σ y² over its columns is
    summed over 'model' (``psum``, whose autograd transpose sums the
    cotangents) and divided by the whole dimension, as the unsharded norm
    takes its mean;
  - data parallelism and ZeRO-1: microbatch i is the unsharded step's
    (rows i·B/M … (i + 1)·B/M − 1 of the batch), placed over the data
    slots; the f32 gradients are summed over 'model' where a parameter is
    replicated over it, then reduce-scattered over 'data' onto
    ``opt_specs``'s moment shards (all-reduced where a moment is not
    split; an FSDP weight's gradient is already its shard's sum); AdamW
    runs on the shard and the updated tiles are all-gathered over 'data'.
    The global gradient norm counts each distinct shard once.

Collectives add in slot order (``core.topology.Group``), so a rerun is
bitwise the same. A placement the port does not run (a head split
inside, a cache split over its slots) raises ``NotImplementedError``,
with no fall-back to the unsharded step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.kvcache import (attn_cache_update, cache_slot,
                                        quantize_kv, serve_cache_init)
from repro_torch.optim import adamw, schedules
from repro_torch.sharding import partitioning as PART
from repro_torch.sharding.constraints import batch_axes, constrain, use_mesh

META = torch.device("meta")


# ---------------------------------------------------------------------------
# f32 partial products
# ---------------------------------------------------------------------------

def _mm_f32_fwd(a, w):
    """a (n, k) @ w (k, n'), or per expert a (e, n, k) @ w (e, k, n'), with
    an f32 result."""
    if a.device.type == "cpu":
        return a.float() @ w.float()
    if a.dim() == 3:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.mm(a, w, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """a (…, k) @ w (k, n), or per expert a (e, n, k) @ w (e, k, n'), in
    a's dtype with an f32 result: each product and the sum in f32, no
    rounding to a's dtype (on the card cuBLAS's bf16 GEMM with an f32
    output, ``torch.mm`` / ``torch.bmm(..., out_dtype=float32)``; on the
    CPU the f32 product of the exact f32 copies). The backward pass is
    the half-precision one of ``a @ w``, which the unsharded model
    runs."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if w.dim() == 3:
            return _mm_f32_fwd(a, w)
        out = _mm_f32_fwd(a.reshape(-1, a.shape[-1]), w)
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = g @ w.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            gw = (a.transpose(1, 2) @ g if w.dim() == 3 else
                  a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1]))
        return ga, gw


def mm_f32(a, w):
    """a @ w (or per expert, ``torch.bmm(a, w)``) with an f32 result (a
    row-parallel partial product)."""
    if a.dtype == torch.float32:
        return a @ w.float()
    return _MatmulF32.apply(a, w)


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------


def _range(i: int, n: int, parts: int):
    size = n // parts
    return i * size, (i + 1) * size


def _self_attn(block):
    """A block's self-attention (``DenseBlock.attn``, the audio decoder's
    ``DecoderBlock.self_attn``)."""
    return block.self_attn if isinstance(block, MODEL.DecoderBlock) \
        else block.attn


_EXPERT_WEIGHTS = ("mlp.w_gate", "mlp.w_up", "mlp.w_down")


class ShardedLM:
    """The specs of ``cfg`` on ``mesh`` and where each slot's shards lie
    (the same in every layer, the audio encoder's and the cross-attention
    included), and the SPMD pieces of the model. A layer is given as
    ``get(slot)`` -> that slot's block module."""

    def __init__(self, cfg: ArchConfig, mesh):
        from repro_torch.models import steps as STEPS
        self.cfg, self.mesh = cfg, mesh
        self.meta_params = STEPS.params_specs(cfg)
        self.pspecs = PART.param_specs(self.meta_params, cfg, mesh)
        # parameters with a dim over 'data': the moe FSDP branch's experts
        self.fsdp = {n for n, sp in self.pspecs.items()
                     if any("data" in PART._axes_of(e) for e in sp)}
        if any(not (cfg.is_moe and n.endswith(_EXPERT_WEIGHTS))
               for n in self.fsdp):
            raise NotImplementedError("only the moe family's expert weights "
                                      "shard a dim over 'data'")
        self.M = mesh.axis_size("model")
        self.data = tuple(a for a in ("pod", "data") if a in mesh.shape)
        self.n_data = mesh.axis_size(self.data)
        sp = self.pspecs
        self.table_split = sp["table"][0] == "model"
        self.unembed_split = (self.table_split if cfg.tie_embeddings
                              else sp["unembed"][1] == "model")
        self.expert_split = self.expert_fsdp = False
        self.mixer_split = self.time_split = self.ffn_split = False
        if cfg.family in ("hybrid", "ssm"):
            self._recurrent_layout()
        if cfg.family == "ssm":       # attention-free
            self.hd = 0
            return
        self.hd = cfg.resolved_head_dim
        # the attention and MLP of the first block that has them (the
        # hybrid family's: the shared block)
        first = {"audio": "blocks.0.self_attn.",
                 "hybrid": "shared_attn.attn."}.get(cfg.family,
                                                    "blocks.0.attn.")
        mlp = ("shared_attn.mlp." if cfg.family == "hybrid"
               else "blocks.0.mlp.")
        self.q_cols = sp[first + "wq"][1] == "model"
        self.kv_cols = sp[first + "wk"][1] == "model"
        self.wo_rows = sp[first + "wo"][0] == "model"
        if cfg.is_moe:
            wg = sp[mlp + "w_gate"]
            self.expert_split = wg[0] == "model"     # expert-parallel
            self.expert_fsdp = wg[1] == "data"
            self.mlp_split = wg[2] == "model"        # d_ff over 'model'
        else:
            self.mlp_split = sp[mlp + ("w_out" if cfg.is_encdec
                                       else "w_down")][0] == "model"
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.q_split = self.q_cols and H % self.M == 0
        self.kv_split = self.kv_cols and Hkv % self.M == 0

    def _recurrent_layout(self):
        """The hybrid mixers' and the ssm time-mix's split, from the
        parameter specs: a slot runs whole heads, whose columns and cache
        states (split by the same rule) line up; the B / C histories
        (hybrid) and the token shifts (ssm), which every slot needs whole,
        the cache may split all the same (``bc_split``,
        ``shift_split``)."""
        cfg, sp, M = self.cfg, self.pspecs, self.M
        cspec = PART.cache_specs(serve_cache_init(cfg, 1, 1, device=META),
                                 cfg, None, self.mesh)
        if cfg.family == "hybrid":
            d_in, H, _, _ = M2.mamba2_dims(cfg)
            self.mixer_split = split = sp["blocks.0.mixer.w_x"][1] == "model"
            self.bc_split = cspec["mamba"]["conv_B"][3] == "model"
            what = f"d_inner ({d_in})", f"the {H} SSD heads"
        else:
            d, H = cfg.d_model, cfg.d_model // cfg.wkv_head_dim
            self.time_split = split = sp["blocks.0.att.wr"][1] == "model"
            self.ffn_split = sp["blocks.0.ffn.w_out"][0] == "model"
            self.shift_split = cspec["shift_att"][2] == "model"
            what = f"d ({d})", f"the {H} WKV heads"
        if split and H % M:
            raise NotImplementedError(
                f"'model' = {M} divides {what[0]} but not {what[1]}: a "
                f"slot would hold part of a head")

    # -- where a slot's shards lie ------------------------------------------

    def m(self, s) -> int:
        return self.mesh.coord(s, "model")

    def q_heads(self, s):
        H = self.cfg.n_heads
        return _range(self.m(s), H, self.M) if self.q_split else (0, H)

    def kv_heads(self, s):
        Hkv = self.cfg.n_kv_heads
        return _range(self.m(s), Hkv, self.M) if self.kv_split else (0, Hkv)

    def wo_rows_of(self, s):
        nq = self.cfg.n_heads * self.hd
        return _range(self.m(s), nq, self.M) if self.wo_rows else (0, nq)

    def vocab(self, s, split: bool):
        Vp = self.cfg.padded_vocab_size
        return _range(self.m(s), Vp, self.M) if split else (0, Vp)

    def batch_spec(self, tokens_spec):
        """The batch axes of a placement; the reference's carry
        constraint must keep it (a batch split over 'data' but not 'pod'
        would be regathered there, which the port does not run)."""
        ba = tokens_spec[0]
        want = constraint_batch(self.mesh, self.B_of(ba, 1))
        if PART._axes_of(ba) != PART._axes_of(want):
            raise NotImplementedError(
                f"batch placed over {ba} but constrained to {want}")
        return ba

    def B_of(self, ba, b_loc: int) -> int:
        return b_loc * (self.mesh.axis_size(PART._axes_of(ba))
                        if ba is not None else 1)

    # -- pieces --------------------------------------------------------------

    def embed(self, params, tokens, dtype):
        """The token embeddings of each slot's rows, replicated over
        'model' (a vocab-parallel lookup summed in f32)."""
        mesh = self.mesh

        def local(s, tok):
            table = params[s].table
            if not self.table_split:
                return L.embed(table, tok, dtype)
            va, vb = self.vocab(s, True)
            inside = (tok >= va) & (tok < vb)
            e = F.embedding((tok - va).clamp(0, vb - va - 1), table)
            return torch.where(inside[..., None], e.float(), 0.0)

        x = mesh.map(local, tokens)
        if not self.table_split:
            return x
        x = mesh.psum(x, "model")
        return mesh.map(lambda s, t: t.to(dtype), x)

    def embed_inputs(self, params, parts, dtype):
        """Each slot's input rows (``model._embed_inputs``): the token
        embeddings, a vlm batch's ``image_embeds`` before them, an audio
        batch's text with its sinusoidal positions."""
        cfg, mesh = self.cfg, self.mesh
        x = self.embed(params, _placed_tokens(parts), dtype)
        first = parts[mesh.slots[0]]
        if cfg.family == "vlm" and "image_embeds" in first:
            x = mesh.map(lambda s, xs, p: torch.cat(
                [p["image_embeds"].to(dtype), xs], dim=1), x, parts)
        if cfg.is_encdec:
            x = mesh.map(lambda s, xs: MODEL._with_positions(xs), x)
        return x

    def encode(self, params, parts, ba, dtype, run=None):
        """The audio encoder on every slot over its rows' ``audio_embeds``
        (``model._encode``): positions, the non-causal encoder blocks on
        the slot's heads, ``enc_final_norm``. ``run(layer, ins, policy)``
        runs each block (``_forward``'s, for remat)."""
        mesh = self.mesh
        x = mesh.map(lambda s, p: MODEL._with_positions(
            p["audio_embeds"].to(dtype)), parts)
        attend = self.prompt_attention(0, causal=False)
        for li in range(self.cfg.n_encoder_layers):

            def layer(xd, li=li):
                out = self.block(lambda s: params[s].enc_blocks[li], xd, ba,
                                 (None, None), 0, attend)
                return (out[0],)

            x = (run(layer, [x], "full") if run is not None
                 else layer(x))[0]
        return mesh.map(lambda s, xs: params[s].enc_final_norm(xs), x)

    def _to_heads(self, parts, n_heads, cols_split, ba, S):
        """A projection's (b, S, n) columns per slot as (b, S, heads, hd),
        placed as the reference's constraint names: heads over 'model'
        where the head count allows, else replicated (columns split
        inside a head are all-gathered first)."""
        mesh, hd = self.mesh, self.hd
        model = None
        if cols_split and n_heads % self.M:
            parts = mesh.all_gather(parts, "model", dim=2)
        elif cols_split:
            model = "model"
        b = next(iter(parts.values())).shape[0]
        parts = {s: p.reshape(p.shape[0], S, -1, hd)
                 for s, p in parts.items()}
        x = PART.Sharded(mesh, (ba, None, model, None),
                         (self.B_of(ba, b), S, n_heads, hd), parts)
        return constrain(x, batch_axes(), None, "model", None).parts

    def project(self, attn_of, h, ba, S, rope, rot_dim):
        """Each slot's q, k, v (b, S, heads, hd) of the attention
        ``attn_of(slot)``, normed and rotated as ``Attention.project``."""
        mesh, cfg = self.mesh, self.cfg

        qkv = mesh.map(lambda s, hs: attn_of(s).columns(hs), h)
        q, k, v = (self._to_heads({s: t[i] for s, t in qkv.items()}, n,
                                  cols, ba, S)
                   for i, n, cols in ((0, cfg.n_heads, self.q_cols),
                                      (1, cfg.n_kv_heads, self.kv_cols),
                                      (2, cfg.n_kv_heads, self.kv_cols)))

        out = mesh.map(lambda s, qs, ks, vs: attn_of(s).norm_rope(
            qs, ks, vs, rope, rot_dim), q, k, v)
        return tuple({s: t[i] for s, t in out.items()} for i in range(3))

    def cross_q(self, attn_of, h, ba):
        """Each slot's cross-attention queries (b, S, q heads, hd)
        (``Attention.cross``: no positions, the q norm if any)."""
        mesh, dtype = self.mesh, next(iter(h.values())).dtype
        S = next(iter(h.values())).shape[1]
        q = self._to_heads(mesh.map(lambda s, hs: hs @ attn_of(s).wq.to(
            dtype), h), self.cfg.n_heads, self.q_cols, ba, S)

        def norm(s, qs):
            qn = attn_of(s).q_norm
            return (qs if qn is None else qn(qs)).contiguous()

        return mesh.map(norm, q)

    def cross_kv(self, attn_of, enc, ba):
        """Each slot's cross K and V (b, F, heads, hd) from its encoder
        output (``Attention.cross_kv``), split as self-attention's."""
        mesh, cfg = self.mesh, self.cfg
        dtype, F_ = next(iter(enc.values())).dtype, cfg.n_audio_frames
        kv = mesh.map(lambda s, es: (es @ attn_of(s).wk.to(dtype),
                                     es @ attn_of(s).wv.to(dtype)), enc)
        return tuple(self._to_heads({s: t[i] for s, t in kv.items()},
                                    cfg.n_kv_heads, self.kv_cols, ba, F_)
                     for i in range(2))

    def cross_prompt(self, enc, ba, fill=None):
        """``cross(attn_of, h)`` for a prompt or training: each slot's q
        heads through L1 (non-causal, Sq = S, Skv = F) over the K/V it
        projects from its encoder output; ``fill(k, v)`` takes the
        slots' cross K/V (the prefill's cache)."""
        def cross(attn_of, h):
            q = self.cross_q(attn_of, h, ba)
            k, v = self.cross_kv(attn_of, enc, ba)
            if fill is not None:
                fill(k, v)

            def local(s, qs, ks, vs):
                ks, vs = self.kv_for_q(s, (ks, vs), self.kv_heads(s))
                return L._prompt_attention(qs, ks, vs, causal=False)

            return self.mesh.map(local, q, k, v)
        return cross

    def kv_for_q(self, s, ts, held):
        """The K/V heads the slot's q heads attend to, out of the heads
        ``held`` = (first, end) that each of ``ts`` (k and v (b, S, ·, hd),
        and an int8 cache's scales (b, S, ·)) holds on dim 2: a slice where
        the q heads' groups line up with it, else one K/V head per q head
        (group 1)."""
        G = self.cfg.n_heads // self.cfg.n_kv_heads
        qa, qb = self.q_heads(s)
        lo, hi = qa // G, -(-qb // G)
        if hi - lo == 1 or (qa % G == 0 and qb % G == 0):
            if (lo, hi) == held:
                return ts
            return tuple(t[:, :, lo - held[0]:hi - held[0]].contiguous()
                         for t in ts)
        idx = torch.arange(qa, qb, device=ts[0].device) // G - held[0]
        return tuple(t.index_select(2, idx) for t in ts)

    def out_proj(self, attn_of, o, dtype):
        """Each slot's attention output (b, S, heads·hd, its q heads'
        columns) through ``attn_of(slot).wo``: row-parallel partials
        summed over 'model' in f32, or the whole product where ``wo`` is
        replicated."""
        mesh, hd = self.mesh, self.hd

        def local(s, os_):
            wo = attn_of(s).wo.to(dtype)
            ra, rb = self.wo_rows_of(s)
            qa = self.q_heads(s)[0] * hd
            if (ra - qa, rb - qa) != (0, os_.shape[-1]):
                os_ = os_[..., ra - qa:rb - qa]
            return mm_f32(os_, wo) if self.wo_rows else os_ @ wo

        return self._reduce(mesh.map(local, o), self.wo_rows, dtype)

    def _reduce(self, parts, split, dtype):
        if not split:
            return parts
        parts = self.mesh.psum(parts, "model")
        return self.mesh.map(lambda s, t: t.to(dtype), parts)

    def mlp(self, get, h, dtype, aux=False):
        """Each slot's MLP output (SwiGLU, GELU or MoE) and, for the moe
        family with ``aux``, its (moe_aux, moe_dropped) (``moe``)."""
        if self.cfg.is_moe:
            return self.moe(get, h, dtype, aux)

        def local(s, hs):
            m = get(s).mlp
            if not self.mlp_split:
                return m(hs)
            w = m.w_out if isinstance(m, L.GeluMLP) else m.w_down
            return mm_f32(m.hidden(hs), w.to(dtype))

        y = self._reduce(self.mesh.map(local, h), self.mlp_split, dtype)
        if self.cfg.is_encdec and self.mlp_split:
            # the replicated b_out of a row-parallel product: once, after
            # the sum
            y = self.mesh.map(lambda s, t: t + get(s).mlp.b_out.to(dtype), y)
        return y, None

    def moe(self, get, h, dtype, aux):
        """The moe family's MLP on every slot (module docstring): each
        slot's y (b, S0, d), and with ``aux`` its (moe_aux, moe_dropped)
        as a (2,) f32 tensor, the same on every slot."""
        mesh, cfg = self.mesh, self.cfg
        E = cfg.n_experts
        if self.expert_split or not (self.mlp_split or self.expert_fsdp):

            def local(s, hs):
                m = get(s).mlp
                experts = (_range(self.m(s), E, self.M)
                           if self.expert_split else None)
                e_in, disp = MOE.dispatch(m.router, cfg, hs, experts)
                e_out = torch.bmm(MOE.expert_hidden(
                    e_in, m.w_gate.to(dtype), m.w_up.to(dtype)),
                    m.w_down.to(dtype))
                y = MOE.combine(e_out, disp)
                return (y if self.expert_split else y.to(dtype)), disp

            out = mesh.map(local, h)
            y = self._reduce({s: o[0] for s, o in out.items()},
                             self.expert_split, dtype)
        else:
            # the FSDP branch: the layer's experts gathered over 'data',
            # tensor-parallel over d_ff. The master shards are gathered and
            # cast after, so that the gather's backward reduce-scatters
            # their gradients over 'data' in f32, as ``_reduce`` sums every
            # other parameter's
            w = {n: mesh.map(lambda s: getattr(get(s).mlp, n))
                 for n in ("w_gate", "w_up", "w_down")}
            if self.expert_fsdp:
                w = {n: mesh.all_gather(t, "data", dim=2 if n == "w_down"
                                        else 1) for n, t in w.items()}

            def local(s, hs, wg, wu, wd):
                wg, wu, wd = (t.to(dtype) for t in (wg, wu, wd))
                e_in, disp = MOE.dispatch(get(s).mlp.router, cfg, hs)
                hid = MOE.expert_hidden(e_in, wg, wu)
                return (mm_f32(hid, wd) if self.mlp_split
                        else torch.bmm(hid, wd)), disp

            out = mesh.map(local, h, w["w_gate"], w["w_up"], w["w_down"])
            e_out = self._reduce({s: o[0] for s, o in out.items()},
                                 self.mlp_split, dtype)
            y = mesh.map(lambda s, e: MOE.combine(e, out[s][1]).to(dtype),
                         e_out)
        y = mesh.map(lambda s, t, hs: t.reshape(hs.shape), y, h)
        if not aux:
            return y, None
        K = cfg.experts_per_token
        stats = mesh.map(lambda s, o: torch.cat(
            [t.reshape(-1) for t in MOE.load_balance(o[1], K)]), out)
        if self.data:
            stats = mesh.psum(stats, self.data)
        n = self.n_data

        def terms(s, t):
            t = t / n
            return torch.stack([E * (t[:E] * t[E:2 * E]).sum(), t[2 * E]])

        return y, mesh.map(terms, stats)

    def prompt_attention(self, window: int, causal: bool = True):
        """``attend`` for a prompt: each slot's q heads through L1 (or its
        autograd Function) over their K/V heads."""
        def attend(q, k, v):
            def local(s, qs, ks, vs):
                ks, vs = self.kv_for_q(s, (ks, vs), self.kv_heads(s))
                return L._prompt_attention(qs, ks, vs, causal, window)
            return self.mesh.map(local, q, k, v)
        return attend

    def block(self, get, x, ba, rope, rot_dim, attend, *, cross=None,
              aux=False):
        """The layer ``get(slot)`` on every slot: pre-norm attention, the
        decoder's cross-attention (``cross(attn_of, h)`` maps each slot's
        normed x to its attention output (b, S, q heads, hd)), and the
        MLP, each with a residual. ``attend(q, k, v)`` maps each slot's
        q, k, v (b, S, heads, hd) to its attention output. Returns (x, k,
        v, the moe layer's (moe_aux, moe_dropped) with ``aux``, else None)
        per slot."""
        mesh = self.mesh
        dtype = next(iter(x.values())).dtype
        S = next(iter(x.values())).shape[1]

        def attn_of(s):
            return _self_attn(get(s))

        def add(a, b):
            return mesh.map(lambda s, t, u: t + u, a, b)

        def flat(o):
            return {s: t.reshape(t.shape[0], S, -1) for s, t in o.items()}

        h = mesh.map(lambda s, xs: get(s).ln1(xs), x)
        q, k, v = self.project(attn_of, h, ba, S, rope, rot_dim)
        x = add(x, self.out_proj(attn_of, flat(attend(q, k, v)), dtype))
        if cross is not None:
            def cross_of(s):
                return get(s).cross_attn
            h = mesh.map(lambda s, xs: get(s).ln_x(xs), x)
            x = add(x, self.out_proj(cross_of, flat(cross(cross_of, h)),
                                     dtype))
        h = mesh.map(lambda s, xs: get(s).ln2(xs), x)
        m, a = self.mlp(get, h, dtype, aux)
        return add(x, m), k, v, a

    # -- the recurrent families ----------------------------------------------

    def cols(self, s, n: int, split: bool):
        """The slot's (first, end) columns of a dimension of ``n`` split
        over 'model' (all of them where ``split`` is false)."""
        return _range(self.m(s), n, self.M) if split else (0, n)

    def mamba(self, get, x, states):
        """The Mamba2 layer ``get(slot)`` (a ``MambaBlock``) on every
        slot: x + the mixer of its normed x over the slot's heads
        (``Mamba2Mixer.mix``, from ``states``: each slot's conv_x and ssm
        of its heads, the whole conv_B / conv_C histories), the gated norm
        over the whole d_inner, the row-parallel ``out_proj``. Returns (x,
        each slot's new state) per slot."""
        mesh = self.mesh
        dtype = next(iter(x.values())).dtype
        out = mesh.map(lambda s, xs, st: get(s).mixer.mix(get(s).ln(xs), st),
                       x, states)
        y = self._norm_split({s: o[0] for s, o in out.items()},
                             lambda s: get(s).mixer.norm, self.mixer_split,
                             M2.mamba2_dims(self.cfg)[0])

        def proj(s, ys, o):
            m = get(s).mixer
            g = m.gate(ys, o[1])
            return (mm_f32(g, m.out_proj.to(dtype)) if self.mixer_split
                    else g @ m.out_proj.to(dtype))

        a = self._reduce(mesh.map(proj, y, out), self.mixer_split, dtype)
        return (mesh.map(lambda s, t, u: t + u, x, a),
                {s: o[2] for s, o in out.items()})

    def rwkv(self, get, x, wkv, shift_att, shift_ffn):
        """The RWKV6 layer ``get(slot)`` (an ``RwkvBlock``) on every slot:
        the time-mix of its normed x over the slot's heads (``TimeMix.mix``
        with its columns of the decay and bonus; ``wkv`` each slot's state
        of its heads, ``shift_att`` / ``shift_ffn`` the whole (b, d)
        previous tokens), ``ln_out`` over the whole d, the row-parallel
        ``wo``, then the channel-mix (``w_in`` column-, ``w_out``
        row-parallel), each with a residual. Returns (x, (wkv, the
        time-mix's last normed token, the channel-mix's), per slot)."""
        mesh, d = self.mesh, self.cfg.d_model
        dtype = next(iter(x.values())).dtype

        def att(s, xs, w, sa):
            blk = get(s)
            h = blk.ln1(xs)
            cols = self.cols(s, d, True) if self.time_split else None
            return blk.att.mix(h, sa, w, cols) + (h[:, -1],)

        out = mesh.map(att, x, wkv, shift_att)

        # ln_out's scale is replicated: a slot takes its columns
        y = self._norm_split({s: o[0] for s, o in out.items()},
                             lambda s: get(s).att.ln_out, self.time_split,
                             d, sliced=True)

        def wo(s, ys, o):
            t = get(s).att
            g = t.gate(ys, o[1])
            return (mm_f32(g, t.wo.to(dtype)) if self.time_split
                    else g @ t.wo.to(dtype))

        x = mesh.map(lambda s, t, u: t + u, x,
                     self._reduce(mesh.map(wo, y, out), self.time_split,
                                  dtype))

        def ffn(s, xs, sf):
            blk = get(s)
            h = blk.ln2(xs)
            hid, last = blk.ffn.hidden(h, sf)
            w = blk.ffn.w_out.to(dtype)
            return (mm_f32(hid, w) if self.ffn_split else hid @ w), last

        f = mesh.map(ffn, x, shift_ffn)
        x = mesh.map(lambda s, t, u: t + u, x, self._reduce(
            {s: o[0] for s, o in f.items()}, self.ffn_split, dtype))
        return x, {s: (out[s][2], out[s][3], f[s][1]) for s in mesh.slots}

    def _norm_split(self, y, norm_of, split, n, sliced=False):
        """``norm_of(slot)`` (an ``RMSNorm``) of each slot's y: where
        ``split``, y holds the slot's columns of a dimension of ``n``, and
        the norm is taken over the whole of it (``rmsnorm_over_model``)
        with the slot's columns of the scale (the scale itself, or with
        ``sliced`` its slice of a replicated one); else the module
        itself."""
        if not split:
            return self.mesh.map(lambda s, t: norm_of(s)(t), y)

        def scale(s):
            sc = norm_of(s).scale
            if not sliced:
                return sc
            a, b = self.cols(s, n, True)
            return sc[a:b]

        return rmsnorm_over_model(self.mesh, y, {
            s: scale(s) for s in self.mesh.slots}, n, self.cfg.norm_eps)

    def mamba_states(self, b: int, dtype, device):
        """Each slot's zero Mamba2 state at ``b`` rows: conv_x and ssm of
        its heads, the whole conv_B / conv_C histories."""
        d_in, H, N, P = M2.mamba2_dims(self.cfg)
        W, k = self.cfg.ssm_conv_width, (self.M if self.mixer_split else 1)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return {s: {"conv_x": zeros(b, W - 1, d_in // k),
                    "conv_B": zeros(b, W - 1, N), "conv_C": zeros(b, W - 1, N),
                    "ssm": zeros(b, H // k, P, N, dt=torch.float32)}
                for s in self.mesh.slots}

    def mamba_cached(self, get, x, cache, li):
        """The Mamba2 layer ``get(slot)`` over each slot's cache state of
        layer ``li``, updated in place: the conv_B / conv_C histories
        gathered over 'model' where the cache splits them on N, and each
        slot's part of the new ones written back."""
        mesh, N = self.mesh, self.cfg.ssm_state
        st = {s: {n: t[li] for n, t in cache[s]["mamba"].items()}
              for s in mesh.slots}
        if self.bc_split:
            for n in ("conv_B", "conv_C"):
                whole = mesh.all_gather({s: st[s][n] for s in mesh.slots},
                                        "model", dim=2)
                for s in mesh.slots:
                    st[s][n] = whole[s]
        x, new = self.mamba(get, x, st)

        def write(s, nw):
            a, b = self.cols(s, N, self.bc_split)
            for n, t in cache[s]["mamba"].items():
                t[li].copy_(nw[n][..., a:b] if n in ("conv_B", "conv_C")
                            else nw[n])

        mesh.map(write, new)
        return x

    def rwkv_cached(self, get, x, cache, li, shifts: bool):
        """The RWKV6 layer ``get(slot)`` over each slot's ``wkv`` state of
        layer ``li`` and, with ``shifts``, the cache's token shifts
        (gathered over 'model' where the cache splits them on d; without,
        zeros: a prompt starts from them, as unsharded), updated in place
        (each slot writes its part of the new shifts)."""
        mesh, d = self.mesh, self.cfg.d_model
        wkv = {s: cache[s]["wkv"][li] for s in mesh.slots}
        prev = []
        for n in ("shift_att", "shift_ffn"):
            t = {s: cache[s][n][li] for s in mesh.slots}
            if not shifts:
                t = mesh.map(lambda s, u: u.new_zeros(u.shape[0], d), t)
            elif self.shift_split:
                t = mesh.all_gather(t, "model", dim=1)
            prev.append(t)
        x, new = self.rwkv(get, x, wkv, *prev)

        def write(s, nw):
            a, b = self.cols(s, d, self.shift_split)
            cache[s]["wkv"][li].copy_(nw[0])
            cache[s]["shift_att"][li].copy_(nw[1][:, a:b])
            cache[s]["shift_ffn"][li].copy_(nw[2][:, a:b])

        mesh.map(write, new)
        return x

    def logits(self, params, x):
        """Each slot's f32 logits over its vocabulary shard (-1e9 on the
        padded columns)."""
        def local(s, xs):
            P = params[s]
            return L.unembed(P.unembed_weight(), P.final_norm(xs), self.cfg,
                             self.vocab(s, self.unembed_split)[0])

        return self.mesh.map(local, x)

    def full_logits(self, lg, ba):
        """The slots' logits shards as one (B, ·, Vp) tensor on the first
        slot (the reference's replicated output): gathered over 'model',
        then over the batch axes."""
        mesh = self.mesh
        if self.unembed_split:
            lg = mesh.all_gather(lg, "model", dim=2)
        if ba is not None:
            lg = mesh.all_gather(lg, PART._axes_of(ba), dim=0)
        return lg[mesh.slots[0]]

    def loss(self, lg, tokens, ba, extra=None):
        """Next-token cross entropy of each slot's rows (vocab-parallel
        over 'model'), plus ``extra`` (a slot's scalar: 0.01 × the moe
        aux loss), then the sum over the data slots (a psum over the data
        axes; a batch replicated over data counts each copy): the caller
        divides by the data slots. Returns the total on the first
        slot."""
        mesh = self.mesh

        def local(s, lg_, tok):
            S_text = tok.shape[1]
            labels = tok[:, 1:]
            pred = lg_[:, -S_text:][:, :-1]
            va, vb = self.vocab(s, self.unembed_split)
            inside = (labels >= va) & (labels < vb)
            gold = pred.gather(-1, (labels - va).clamp(0, vb - va - 1)
                               .long().unsqueeze(-1)).squeeze(-1)
            return (torch.logsumexp(pred, dim=-1)[..., None],
                    torch.where(inside, gold, 0.0))

        out = mesh.map(local, lg, tokens)
        lse = {s: t[0] for s, t in out.items()}
        gold = {s: t[1] for s, t in out.items()}
        if self.unembed_split:
            lse = mesh.all_gather(lse, "model", dim=2)
            gold = mesh.psum(gold, "model")

        def nll(s, lse_s, gold_s):
            mask = torch.ones(gold_s.shape, dtype=torch.float32,
                              device=gold_s.device)
            z = torch.logsumexp(lse_s, dim=-1)
            out = ((z - gold_s) * mask).sum() / torch.clamp(mask.sum(),
                                                            min=1.0)
            return out if extra is None else out + extra[s]

        loss = mesh.map(nll, lse, gold)
        if self.data:
            loss = mesh.psum(loss, self.data)
        return loss[mesh.slots[0]]

    # -- caches --------------------------------------------------------------

    def cache_init(self, B: int, seq_len: int, window_override=None,
                   device=None, dtype=torch.bfloat16, kv_quant=False):
        """Each slot's empty serving cache under ``cache_specs`` (``pos``
        0, K/V and recurrent states zeros in ``dtype`` (the ssm and WKV
        states f32), ``kv_pos`` -1; the audio family's ``cross_k`` /
        ``cross_v`` zeros beside them and ``cross_pos`` = arange(F),
        replicated; with ``kv_quant`` the int8 K/V and their f32 scales),
        on the slot's device (``device`` where the mesh has none)."""
        cfg, mesh = self.cfg, self.mesh
        full = serve_cache_init(cfg, B, seq_len, dtype=dtype,
                                window_override=window_override, device=META,
                                kv_quant=kv_quant)
        specs = PART.cache_specs(full, cfg, None, mesh)
        if "attn" in full:
            self.set_cache_spec(B, full["attn"]["k"].shape[2])

        def make(name, t, spec, dev):
            if isinstance(t, dict):
                return {n: make(n, u, spec[n], dev) for n, u in t.items()}
            if not isinstance(t, torch.Tensor):      # pos
                return t
            shp = PART.shard_shape(mesh, spec, t.shape)
            if name == "kv_pos":
                return torch.full(shp, -1, dtype=t.dtype, device=dev)
            if name == "cross_pos":
                return torch.arange(shp[0], dtype=t.dtype, device=dev)
            return torch.zeros(shp, dtype=t.dtype, device=dev)

        return {s: make("", full, specs, mesh.device(s)
                        if mesh.devices is not None else device)
                for s in mesh.slots}

    def set_cache_spec(self, B: int, S: int):
        """The K/V cache spec at B sequences of S slots (the cross cache
        splits as the self cache: the same heads and head dim)."""
        self.cache_spec = PART.kv_cache_spec(
            (self.cfg.n_layers, B, S, self.cfg.n_kv_heads, self.hd),
            self.mesh)
        if self.cache_spec[2] is not None:
            raise NotImplementedError(
                "a cache split over its slots (neither Hkv nor hd divides "
                "'model'): no published config needs it")

    def cache_ranges(self, s):
        """(heads, head-dim range) of the slot's cache shard."""
        cfg, hd = self.cfg, self.hd
        _, _, _, hs, ds = self.cache_spec
        heads = (_range(self.m(s), cfg.n_kv_heads, self.M) if hs
                 else (0, cfg.n_kv_heads))
        dims = _range(self.m(s), hd, self.M) if ds else (0, hd)
        return heads, dims

    def cache_part(self, s, t):
        """The part of k or v (b, S, held heads, hd) in the slot's cache
        shard."""
        (ca, cb), (ha, hb) = self.cache_ranges(s)
        ka = self.kv_heads(s)[0]
        if (cb - ca, hb - ha) == tuple(t.shape[2:]):
            return t
        return t[:, :, ca - ka:cb - ka, ha:hb]

    def scale_part(self, s, sc):
        """The part of an int8 cache's scales (b, held heads) in the
        slot's scale shard: its heads where the cache splits heads, else
        every head (replicated)."""
        (ca, cb), _ = self.cache_ranges(s)
        ka = self.kv_heads(s)[0]
        return sc if cb - ca == sc.shape[1] else sc[:, ca - ka:cb - ka]


def rmsnorm_over_model(mesh, parts, scales, n: int, eps: float):
    """RMSNorm over a dimension of ``n`` whose columns are split over
    'model' (``layers.rmsnorm`` of the whole): each slot's f32 Σ x² over
    its columns, summed over 'model' (``Mesh.psum``, whose autograd
    transpose sums the cotangents), divided by ``n``; x times its rsqrt
    and the slot's ``scales`` columns, in x's dtype."""
    ss = mesh.psum(mesh.map(lambda s, t: t.float().square().sum(
        -1, keepdim=True), parts), "model")
    return mesh.map(lambda s, t, q: (t.float() * torch.rsqrt(q / n + eps)
                                     * scales[s].float()).to(t.dtype),
                    parts, ss)


def constraint_batch(mesh, B: int):
    """The batch entry the reference's carry constraint gives a batch of
    ``B`` rows on ``mesh``."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not axes:
        return None
    n = mesh.axis_size(axes)
    return (axes if len(axes) > 1 else axes[0]) if B % n == 0 else None


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _batch_parts(lm: ShardedLM, batch):
    """A whole batch (a dict of tensors, or one tensor) placed on the
    slots by ``batch_specs``: (parts, the batch axes)."""
    specs = PART.batch_specs(batch, lm.cfg, None, lm.mesh)
    tok_spec = specs["tokens"] if isinstance(specs, dict) else specs
    return PART.place(batch, specs, lm.mesh), lm.batch_spec(tok_spec)


def _remat_slots(slots, fn, ins, policy):
    """``fn(*ins)`` (each a {slot: tensor}, returning a tuple of them)
    checkpointed under ``policy`` as one function of the slots' tensors."""
    n = len(slots)

    def flat_fn(*ts):
        outs = fn(*(dict(zip(slots, ts[i * n:(i + 1) * n]))
                    for i in range(len(ins))))
        return tuple(o[s] for o in outs for s in slots)

    flat = MODEL._remat(policy)(flat_fn, *(d[s] for d in ins for s in slots))
    return tuple(dict(zip(slots, flat[i * n:(i + 1) * n]))
                 for i in range(len(flat) // n))


def _forward(lm: ShardedLM, params, parts, ba, *, remat=False,
             policy="full"):
    """Every slot's f32 vocab-shard logits of its rows (``forward``), and
    for the moe family each slot's layer means of (moe_aux, moe_dropped)
    (a (2,) tensor), else None. The recurrent families start from zero
    states, and the hybrid shared block attends with
    ``cfg.sliding_window``, as unsharded."""
    cfg, mesh = lm.cfg, lm.mesh
    dtype = MODEL.compute_dtype(cfg)
    slots = list(mesh.slots)
    remat = remat and torch.is_grad_enabled()

    def run(layer, ins, pol):
        return (_remat_slots(slots, layer, ins, pol) if remat
                else layer(*ins))

    x = lm.embed_inputs(params, parts, dtype)
    b, S = x[slots[0]].shape[:2]
    dev = x[slots[0]].device
    if cfg.family == "ssm":
        N, d = cfg.wkv_head_dim, cfg.d_model
        H = (d // lm.M if lm.time_split else d) // N
        for li in range(cfg.n_layers):

            def layer(xd, li=li):
                wkv = {s: torch.zeros((b, H, N, N), dtype=torch.float32,
                                      device=dev) for s in slots}
                prev = {s: torch.zeros((b, d), dtype=dtype, device=dev)
                        for s in slots}
                return (lm.rwkv(lambda s: params[s].blocks[li], xd, wkv,
                                prev, prev)[0],)

            x = run(layer, [x], policy)[0]
        return lm.logits(params, x), None
    rope, rot_dim = params[slots[0]].rope(0, S)
    attend = lm.prompt_attention(cfg.sliding_window)
    if cfg.family == "hybrid":
        for lo, hi, full in MODEL.hybrid_groups(cfg):
            for li in range(lo, hi):

                def layer(xd, li=li):
                    return (lm.mamba(lambda s: params[s].blocks[li], xd,
                                     lm.mamba_states(b, dtype, dev))[0],)

                x = run(layer, [x], policy)[0]
            if full:
                x = run(lambda xd: (lm.block(
                    lambda s: params[s].shared_attn, xd, ba, rope, rot_dim,
                    attend)[0],), [x], policy)[0]
        return lm.logits(params, x), None
    enc = (lm.encode(params, parts, ba, dtype, run) if cfg.is_encdec
           else None)
    auxs = []
    for li in range(cfg.n_layers):

        def layer(xd, *ed, li=li):
            cross = lm.cross_prompt(ed[0], ba) if ed else None
            out = lm.block(lambda s: params[s].blocks[li], xd, ba, rope,
                           rot_dim, attend, cross=cross, aux=cfg.is_moe)
            return (out[0],) if out[3] is None else (out[0], out[3])

        out = run(layer, [x] + ([enc] if enc is not None else []), policy)
        x = out[0]
        if len(out) > 1:
            auxs.append(out[1])
    aux = ({s: torch.stack([a[s] for a in auxs]).mean(0) for s in slots}
           if auxs else None)
    return lm.logits(params, x), aux


def _placed_tokens(parts):
    return {s: (p["tokens"] if isinstance(p, dict) else p)
            for s, p in parts.items()}


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def _zero1_dim(spec) -> Optional[int]:
    return next((i for i, e in enumerate(spec) if e == "data"), None)


class _TrainPlan:
    """What a sharded train step needs besides its inputs: the model's
    layout, the moments' specs, the schedule."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, mesh):
        self.lm = ShardedLM(cfg, mesh)
        self.tcfg, self.mesh = tcfg, mesh
        self.lr_fn = schedules.warmup_cosine(tcfg)
        meta = self.lm.meta_params
        self.ospecs = PART.opt_specs(adamw.init(dict(
            meta.named_parameters())), meta, cfg, mesh)
        self.names = list(self.lm.pspecs)

    def grads(self, params, batch):
        """The microbatch loop (microbatch i the unsharded step's, placed
        over the data slots), then the gradients reduced onto the moment
        shards: (mean loss, {name: {slot: f32 gradient tile}}, global
        norm, the moe family's mean moe_aux and moe_dropped), each scalar
        on the first slot."""
        lm, mesh, tcfg = self.lm, self.mesh, self.tcfg
        M = tcfg.microbatches
        whole = batch if isinstance(batch, dict) else {"tokens": batch}
        rows = whole["tokens"].shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{M} microbatches")
        chunks = [_batch_parts(lm, {k: v[i * rows // M:(i + 1) * rows // M]
                                    for k, v in whole.items()})
                  for i in range(M)]
        mesh.fork()
        for s in mesh.slots:
            for p in params[s].parameters():
                p.grad = None
        total, aux_sum = None, None
        for parts, ba in chunks:
            lg, aux = _forward(lm, params, parts, ba, remat=tcfg.remat,
                               policy=tcfg.remat_policy)
            extra = (None if aux is None
                     else {s: 0.01 * a[0] for s, a in aux.items()})
            loss = lm.loss(lg, _placed_tokens(parts), ba, extra)
            del lg
            mesh.join()
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
            if aux is not None:
                a = aux[mesh.slots[0]].detach()
                aux_sum = a if aux_sum is None else aux_sum + a
        mesh.fork()
        with torch.no_grad():
            grads, norm = self._reduce(params, M)
        metrics = ({} if aux_sum is None else
                   {"moe_aux": aux_sum[0] / M, "moe_dropped": aux_sum[1] / M})
        return total / (M * lm.n_data), grads, norm, metrics

    def _reduce(self, params, M):
        """Sum the slots' gradients over 'model' where a parameter is
        replicated over it (and over 'pod'), reduce-scatter them over
        'data' onto the moment shards (all-reduce where a moment is not
        split; an FSDP weight's gradient is its shard's already, summed
        over 'data' by its gather's transpose), scale by 1 / (microbatches
        × data slots); the global norm counts each distinct shard once."""
        lm, mesh = self.lm, self.mesh
        scale = 1.0 / (M * lm.n_data)
        named = {s: dict(params[s].named_parameters()) for s in mesh.slots}
        grads = {}
        for n in self.names:
            g = {s: named[s][n].grad for s in mesh.slots}
            if "model" not in lm.pspecs[n]:
                g = mesh.psum(g, "model")
            if "pod" in mesh.shape:
                g = mesh.psum(g, "pod")
            z = _zero1_dim(self.ospecs.mu[n])
            if n not in lm.fsdp:
                g = (mesh.psum_scatter(g, "data", dim=z) if z is not None
                     else mesh.psum(g, "data"))
            grads[n] = mesh.map(lambda s, t: t * scale, g)
        for s in mesh.slots:
            for p in params[s].parameters():
                p.grad = None

        def sq(s):
            total = torch.zeros((), dtype=torch.float32,
                                device=grads[self.names[0]][s].device)
            for n in self.names:
                axes = {a for e in self.ospecs.mu[n]
                        for a in PART._axes_of(e)}
                if all(mesh.coord(s, a) == 0 for a in mesh.axis_names
                       if a not in axes):
                    total = total + grads[n][s].float().square().sum()
            return total

        norm2 = mesh.psum(mesh.map(lambda s: sq(s)), mesh.axis_names)
        norm = mesh.map(lambda s, t: torch.sqrt(t), norm2)
        return grads, norm

    def whole(self, grads):
        """The gradients' moment-shard tiles gathered to whole tensors by
        name (on the first slot's device)."""
        mesh = self.mesh
        placed = {s: {n: grads[n][s] for n in self.names} for s in mesh.slots}
        return PART.gather(placed, dict(self.ospecs.mu), mesh)

    def update(self, params, opt_state, grads, norm):
        """Clip by the global norm, AdamW on each slot's shard, the
        updated tiles all-gathered over 'data' (an FSDP weight stays the
        slot's shard). Returns the lr."""
        mesh, tcfg, fsdp = self.mesh, self.tcfg, self.lm.fsdp
        lr = self.lr_fn(opt_state[mesh.slots[0]].step + 1)
        named = {s: dict(params[s].named_parameters()) for s in mesh.slots}
        tiles = {}
        for s in mesh.slots:
            with mesh.on(s):
                clip = torch.clamp(tcfg.grad_clip / torch.clamp(
                    norm[s], min=1e-9), max=1.0)
                tile, gs = {}, {}
                for n in self.names:
                    z = _zero1_dim(self.ospecs.mu[n])
                    p = named[s][n]
                    if z is not None and n not in fsdp:
                        size = p.shape[z] // mesh.axis_size("data")
                        p = p.narrow(z, mesh.coord(s, "data") * size, size)
                    tile[n] = p
                    gs[n] = grads[n][s].mul_(clip)
                opt_state[s] = adamw.apply(tile, gs, opt_state[s], tcfg, lr)
                tiles[s] = tile
        for n in self.names:
            z = _zero1_dim(self.ospecs.mu[n])
            if z is None or n in fsdp:
                continue
            full = mesh.all_gather({s: tiles[s][n] for s in mesh.slots},
                                   "data", dim=z)
            for s in mesh.slots:
                with mesh.on(s):
                    named[s][n].copy_(full[s])
        return lr


def make_sharded_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """The counterpart of the reference's ``jax.jit(make_train_step(cfg,
    tcfg), in_shardings=(params, opt, batch), out_shardings=(params, opt,
    None))`` on ``mesh``. The step takes each slot's parameters (a
    ``CausalLM`` of its shards with gradient, ``place(params,
    param_specs)``), AdamW states (``place(opt, opt_specs)``) and the
    whole batch (each microbatch placed by ``batch_specs``), updates the
    parameters and moments in place and returns (params, opt_state,
    metrics with loss, grad_norm, lr and the moe family's moe_aux and
    moe_dropped, on the first slot). With ``grads_out`` (a dict) it also
    puts there the step's whole f32 gradients by name, gathered from the
    moment shards before the clipping and the update, for holding the
    SPMD program's gradients against the unsharded ones."""
    plan = _TrainPlan(cfg, tcfg, mesh)

    def train_step(params, opt_state, batch, grads_out=None):
        with use_mesh(mesh):
            loss, grads, norm, aux = plan.grads(params, batch)
            if grads_out is not None:
                mesh.join()
                grads_out.update(plan.whole(grads))
            with torch.no_grad():
                lr = plan.update(params, opt_state, grads, norm)
            mesh.join()
        return params, opt_state, {"loss": loss, **aux,
                                   "grad_norm": norm[mesh.slots[0]],
                                   "lr": lr}

    return train_step


def make_sharded_prefill_step(cfg: ArchConfig, shape: InputShape, mesh,
                              window_override: Optional[int] = None):
    """The counterpart of ``jax.jit(make_prefill_step(cfg, shape,
    window_override), in_shardings=(params, batch))`` on ``mesh``:
    ``prefill_step(params, batch)`` -> (the last position's logits (B,
    1, Vp) f32 on the first slot, each slot's cache under
    ``cache_specs``). The step makes its own cache
    (``ShardedLM.cache_init``) in the compute dtype: bf16 for the
    published configs, as ``serve_cache_init`` makes it unsharded. It
    takes no cache, so it never fills an int8 one: that cache is filled
    by the decode step from empty, the reference's int8 route (the
    unsharded ``model.prefill`` refuses one). The prompt attends with
    ``cfg.sliding_window`` (the hybrid shared block: with the ring's
    size); ``window_override`` sizes the cache, as unsharded. A vlm
    prompt's image positions take cache slots and count in ``pos``; an
    audio prompt's encoder output fills the slots' cross caches; the
    hybrid and ssm layers start from the empty cache's zero states (an
    ssm prompt from zero token shifts, as unsharded) and store the final
    ones."""
    lm = ShardedLM(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with use_mesh(mesh):
            s0 = mesh.slots[0]
            parts, ba = _batch_parts(lm, batch)
            tok = _placed_tokens(parts)
            B = lm.B_of(ba, tok[s0].shape[0])
            dtype = MODEL.compute_dtype(cfg)
            cache = lm.cache_init(B, shape.seq_len, window_override,
                                  device=tok[s0].device, dtype=dtype)
            mesh.fork()
            x = lm.embed_inputs(params, parts, dtype)
            S = x[s0].shape[1]
            if cfg.family == "ssm":
                for li in range(cfg.n_layers):
                    x = lm.rwkv_cached(lambda s, li=li: params[s].blocks[li],
                                       x, cache, li, shifts=False)
            else:
                rope, rot_dim = params[s0].rope(0, S)

                def fill(g, k, v):
                    mesh.map(lambda s, ks, vs: MODEL._fill_ring(
                        cache[s]["attn"], g, lm.cache_part(s, ks),
                        lm.cache_part(s, vs), S), k, v)

            if cfg.family == "hybrid":
                attend = lm.prompt_attention(
                    cache[s0]["attn"]["k"].shape[2])
                for g, (lo, hi, full) in enumerate(MODEL.hybrid_groups(cfg)):
                    for li in range(lo, hi):
                        x = lm.mamba_cached(
                            lambda s, li=li: params[s].blocks[li], x, cache,
                            li)
                    if full:
                        x, k, v, _ = lm.block(
                            lambda s: params[s].shared_attn, x, ba, rope,
                            rot_dim, attend)
                        fill(g, k, v)
            elif cfg.family != "ssm":
                attend = lm.prompt_attention(cfg.sliding_window)
                enc = (lm.encode(params, parts, ba, dtype) if cfg.is_encdec
                       else None)
                for li in range(cfg.n_layers):
                    cross = None
                    if enc is not None:
                        def write(k, v, li=li):
                            def one(s, ks, vs):
                                cache[s]["cross_k"][li].copy_(
                                    lm.cache_part(s, ks))
                                cache[s]["cross_v"][li].copy_(
                                    lm.cache_part(s, vs))
                            mesh.map(one, k, v)
                        cross = lm.cross_prompt(enc, ba, write)
                    x, k, v, _ = lm.block(lambda s: params[s].blocks[li], x,
                                          ba, rope, rot_dim, attend,
                                          cross=cross)
                    fill(li, k, v)
            last = mesh.map(lambda s, xs: xs[:, -1:], x)
            logits = lm.full_logits(lm.logits(params, last), ba)
            for s in mesh.slots:
                cache[s]["pos"] = S
            mesh.join()
        return logits, cache

    return prefill_step


def make_sharded_serve_step(cfg: ArchConfig, mesh,
                            window_override: Optional[int] = None):
    """The counterpart of ``jax.jit(make_serve_step(cfg,
    window_override), in_shardings=(params, cache, tokens),
    out_shardings=(None, cache))`` on ``mesh``: ``serve_step(params,
    cache, tokens)`` with each slot's cache (from the sharded prefill, or
    ``ShardedLM.cache_init``) and the whole (B, 1) tokens -> (logits (B,
    1, Vp) f32 on the first slot, the cache, updated in place). Each slot
    writes the token's K/V into its cache shard (an int8 cache: the
    quantized values and their scales); where the cache splits the head
    dim, the layer's K/V are gathered over 'model' to whole heads before
    L3 (an int8 cache: ``layers.flash_attend``). The audio decoder also
    runs L3 over each slot's cross cache, and adds no position to the
    token, as the reference's decode does not. A moe decode group is
    dropless (C = its size), so a slot's local group size leaves the
    function as it is. The hybrid family's shared block attends over its
    ring with the ring's size as its window; its Mamba2 layers and the
    ssm family's layers step their states (``ssd_step``, ``wkv_step``)."""
    lm = ShardedLM(cfg, mesh)
    window = (window_override if window_override is not None
              else cfg.sliding_window)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        with use_mesh(mesh):
            parts, ba = _batch_parts(lm, tokens)
            tok = _placed_tokens(parts)
            s0 = mesh.slots[0]
            pos = cache[s0]["pos"]
            mesh.fork()
            dtype = MODEL.compute_dtype(cfg)
            x = lm.embed(params, tok, dtype)
            if cfg.family == "ssm":
                for li in range(cfg.n_layers):
                    x = lm.rwkv_cached(lambda s, li=li: params[s].blocks[li],
                                       x, cache, li, shifts=True)
            else:
                x = _decode_attention_layers(lm, params, cache, x, ba, pos,
                                             window)
            logits = lm.full_logits(lm.logits(params, x), ba)
            for s in mesh.slots:
                cache[s]["pos"] = pos + 1
            mesh.join()
        return logits, cache

    return serve_step


def _decode_attention_layers(lm: ShardedLM, params, cache, x, ba, pos: int,
                             window: int):
    """One token through the layers of an attention family (and the
    hybrid family's Mamba2 layers between its shared block's
    applications), each slot's cache updated in place."""
    cfg, mesh = lm.cfg, lm.mesh
    s0 = mesh.slots[0]
    ck0 = cache[s0]["attn"]["k"]
    quant = ck0.dtype == torch.int8
    if cfg.family == "hybrid":
        window = ck0.shape[2]
    lm.set_cache_spec(lm.B_of(ba, ck0.shape[1]), ck0.shape[2])
    gather = lm.cache_spec[4] is not None
    rope, rot_dim = params[s0].rope(pos, 1)

    def held(s):
        return ((0, cfg.n_kv_heads) if gather
                else lm.cache_ranges(s)[0])

    def layer_kv(li, names):
        """The slots' cache of layer ``li`` (``names``: the K and V
        entries, and an int8 cache's scales), K/V gathered over 'model' to
        whole heads where the cache splits the head dim (the scales are
        then replicated)."""
        out = []
        for n in names:
            c = {s: (cache[s]["attn"][n] if n in cache[s]["attn"]
                     else cache[s][n])[li] for s in mesh.slots}
            out.append(mesh.all_gather(c, "model", dim=3)
                       if gather and n in ("k", "v", "cross_k", "cross_v")
                       else c)
        return out

    def decode_attention(li):
        """``attend`` for one token at layer ``li``: the token's K/V into
        each slot's cache shard, then L3 per slot (an int8 cache: the
        plain ``flash_attend``)."""
        def write(s, ks, vs):
            c = cache[s]["attn"]
            ring = window > 0 and c["k"].shape[2] <= window
            if not quant:
                attn_cache_update(c["k"][li], c["v"][li], c["kv_pos"][li],
                                  lm.cache_part(s, ks), lm.cache_part(s, vs),
                                  pos, ring)
                return
            slot = cache_slot(c["k"].shape[2], pos, ring)
            for n, t in (("k", ks), ("v", vs)):
                # the whole held heads' scales (the amax over all of hd),
                # then the slot's part of the values and of the scales
                q, scale = quantize_kv(t)
                c[n][li][:, slot].copy_(lm.cache_part(s, q)[:, 0])
                c[n + "_scale"][li][:, slot].copy_(
                    lm.scale_part(s, scale[:, 0]))
            c["kv_pos"][li][slot] = pos

        def local(s, qs, *kv):
            kv_pos = cache[s]["attn"]["kv_pos"][li]
            kv = lm.kv_for_q(s, kv, held(s))
            if quant:
                return L.flash_attend(qs, *kv, window=window, q_offset=pos,
                                      kv_positions=kv_pos,
                                      kv_valid=kv_pos >= 0)
            return L.decode_attention(qs[:, 0], *kv, kv_pos, pos,
                                      window=window)[:, None]

        def attend(q, k, v):
            mesh.map(write, k, v)
            names = ("k", "v") + (("k_scale", "v_scale") if quant else ())
            return mesh.map(local, q, *layer_kv(li, names))
        return attend

    def cross_decode(li):
        """``cross`` for one token at layer ``li``: L3 per slot over its
        cross cache, every frame counted (query position F − 1)."""
        def cross(attn_of, h):
            q = lm.cross_q(attn_of, h, ba)

            def local(s, qs, ks, vs):
                ks, vs = lm.kv_for_q(s, (ks, vs), held(s))
                return L.decode_attention(
                    qs[:, 0], ks, vs, cache[s]["cross_pos"],
                    ks.shape[1] - 1)[:, None]

            return mesh.map(local, q, *layer_kv(li, ("cross_k", "cross_v")))
        return cross

    if cfg.family == "hybrid":
        for g, (lo, hi, full) in enumerate(MODEL.hybrid_groups(cfg)):
            for li in range(lo, hi):
                x = lm.mamba_cached(lambda s, li=li: params[s].blocks[li],
                                    x, cache, li)
            if full:
                x = lm.block(lambda s: params[s].shared_attn, x, ba, rope,
                             rot_dim, decode_attention(g))[0]
        return x
    for li in range(cfg.n_layers):
        x = lm.block(lambda s, li=li: params[s].blocks[li], x, ba, rope,
                     rot_dim, decode_attention(li),
                     cross=cross_decode(li) if cfg.is_encdec else None)[0]
    return x
