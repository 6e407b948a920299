"""The dense family's train, prefill and decode steps as SPMD programs over
a ('data', 'model') mesh (the counterpart of the reference's sharded
steps: ``jax.jit(step, in_shardings=..., out_shardings=...)`` under the
dry-run mesh, the program GSPMD derives from ``sharding.partitioning``'s
specs).

The port is single-controller: one process drives every slot of a
``launch.mesh.Mesh`` in lockstep, each slot's work on its own CUDA stream
(one card holds every slot), and the collectives run over the mesh's
axes. Each slot holds its shards (``partitioning.place``) as a
``CausalLM`` of the shards, and runs the model's own modules on them:
the norms, the projections (``Attention.columns``, ``norm_rope``,
``SwiGLU.hidden``, ``layers.unembed``), and the kernels L1 (prompt and
training forward), L2 (training backward) and L3 (decode) on its heads.
Only the block's order (norm, attention, residual, norm, MLP, residual)
is spelt out again here, since collectives fall between its pieces. The
batch stays where ``batch_specs`` puts it, which is where the
reference's carry constraint keeps it (``ShardedLM.batch_spec`` checks
it), so a block boundary moves nothing. Where the placement demands it:

  - row-parallel outputs: ``wo`` and ``mlp/w_down`` give f32 partial
    products, summed over 'model' (``psum``) in f32 and cast once, as the
    unsharded product rounds once;
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
  - data parallelism and ZeRO-1: each data slot runs the microbatch loop
    on its rows; the f32 gradients are summed over 'model' where a
    parameter is replicated over it, then reduce-scattered over 'data'
    onto ``opt_specs``'s moment shards (all-reduced where a moment is not
    split); AdamW runs on the shard and the updated tiles are
    all-gathered over 'data'. The global gradient norm counts each
    distinct shard once.

Collectives add in slot order (``core.topology.Group``), so a rerun is
bitwise the same. The families other than dense raise
``NotImplementedError`` (ROADMAP A.21), with no fall-back to the
unsharded step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.models.kvcache import attn_cache_update, serve_cache_init
from repro_torch.optim import adamw, schedules
from repro_torch.sharding import partitioning as PART
from repro_torch.sharding.constraints import batch_axes, constrain, use_mesh

SHARDED_FAMILIES = ("dense",)
META = torch.device("meta")


def check_family(cfg: ArchConfig):
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"the sharded steps cover the {', '.join(SHARDED_FAMILIES)} "
            f"family; {cfg.name} ({cfg.family}) is queued in ROADMAP A.21")


# ---------------------------------------------------------------------------
# f32 partial products
# ---------------------------------------------------------------------------

def _mm_f32_fwd(a2, w):
    if a2.device.type == "cpu":
        return a2.float() @ w.float()
    return torch.mm(a2, w, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """a (…, k) @ w (k, n) in a's dtype with an f32 result: each product
    and the sum in f32, no rounding to a's dtype (on the card cuBLAS's
    bf16 GEMM with an f32 output, ``torch.mm(..., out_dtype=float32)``;
    on the CPU the f32 product of the exact f32 copies). The backward
    pass is the half-precision one of ``a @ w``, which the unsharded model
    runs."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        out = _mm_f32_fwd(a.reshape(-1, a.shape[-1]), w)
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = g @ w.T
        if ctx.needs_input_grad[1]:
            gw = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return ga, gw


def mm_f32(a, w):
    """a @ w with an f32 result (a row-parallel partial product)."""
    if a.dtype == torch.float32:
        return a @ w.float()
    return _MatmulF32.apply(a, w)


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------


def _range(i: int, n: int, parts: int):
    size = n // parts
    return i * size, (i + 1) * size


class ShardedLM:
    """The specs of ``cfg`` on ``mesh`` and where each slot's shards lie
    (the same in every layer), and the SPMD pieces of the dense model."""

    def __init__(self, cfg: ArchConfig, mesh):
        check_family(cfg)
        from repro_torch.models import steps as STEPS
        self.cfg, self.mesh = cfg, mesh
        self.meta_params = STEPS.params_specs(cfg)
        self.pspecs = PART.param_specs(self.meta_params, cfg, mesh)
        if any("data" in PART._axes_of(e) for sp in self.pspecs.values()
               for e in sp):
            raise NotImplementedError("dense parameters shard no dim over "
                                      "'data'")
        self.M = mesh.axis_size("model")
        self.hd = cfg.resolved_head_dim
        self.data = tuple(a for a in ("pod", "data") if a in mesh.shape)
        self.n_data = mesh.axis_size(self.data)
        sp = self.pspecs
        self.q_cols = sp["blocks.0.attn.wq"][1] == "model"
        self.kv_cols = sp["blocks.0.attn.wk"][1] == "model"
        self.wo_rows = sp["blocks.0.attn.wo"][0] == "model"
        self.mlp_split = sp["blocks.0.mlp.w_down"][0] == "model"
        self.table_split = sp["table"][0] == "model"
        self.unembed_split = (self.table_split if cfg.tie_embeddings
                              else sp["unembed"][1] == "model")
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.q_split = self.q_cols and H % self.M == 0
        self.kv_split = self.kv_cols and Hkv % self.M == 0

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

    def project(self, params, li, h, ba, S, rope, rot_dim):
        """Each slot's q, k, v (b, S, heads, hd) for layer ``li``, normed
        and rotated as ``Attention.project``."""
        mesh, cfg = self.mesh, self.cfg

        qkv = mesh.map(lambda s, hs: params[s].blocks[li].attn.columns(hs), h)
        q, k, v = (self._to_heads({s: t[i] for s, t in qkv.items()}, n,
                                  cols, ba, S)
                   for i, n, cols in ((0, cfg.n_heads, self.q_cols),
                                      (1, cfg.n_kv_heads, self.kv_cols),
                                      (2, cfg.n_kv_heads, self.kv_cols)))

        out = mesh.map(lambda s, qs, ks, vs: params[s].blocks[li].attn
                       .norm_rope(qs, ks, vs, rope, rot_dim), q, k, v)
        return tuple({s: t[i] for s, t in out.items()} for i in range(3))

    def kv_for_q(self, s, k, v, held):
        """The K/V heads the slot's q heads attend to, out of the heads
        ``held`` = (first, end) that k/v (b, S, ·, hd) hold: a slice where
        the q heads' groups line up with it, else one K/V head per q head
        (group 1)."""
        G = self.cfg.n_heads // self.cfg.n_kv_heads
        qa, qb = self.q_heads(s)
        lo, hi = qa // G, -(-qb // G)
        if hi - lo == 1 or (qa % G == 0 and qb % G == 0):
            if (lo, hi) == held:
                return k, v
            return (k[:, :, lo - held[0]:hi - held[0]].contiguous(),
                    v[:, :, lo - held[0]:hi - held[0]].contiguous())
        idx = torch.arange(qa, qb, device=k.device) // G - held[0]
        return k.index_select(2, idx), v.index_select(2, idx)

    def out_proj(self, params, li, o, dtype):
        """Each slot's attention output (b, S, heads·hd, its q heads'
        columns) through ``wo``: row-parallel partials summed over
        'model' in f32, or the whole product where ``wo`` is
        replicated."""
        mesh, hd = self.mesh, self.hd

        def local(s, os_):
            wo = params[s].blocks[li].attn.wo.to(dtype)
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

    def mlp(self, params, li, h, dtype):
        def local(s, hs):
            m = params[s].blocks[li].mlp
            if not self.mlp_split:
                return m(hs)
            return mm_f32(m.hidden(hs), m.w_down.to(dtype))

        return self._reduce(self.mesh.map(local, h), self.mlp_split, dtype)

    def prompt_attention(self, window: int):
        """``attend`` for a prompt: each slot's q heads through L1 (or its
        autograd Function) over their K/V heads."""
        def attend(q, k, v):
            def local(s, qs, ks, vs):
                ks, vs = self.kv_for_q(s, ks, vs, self.kv_heads(s))
                return L._prompt_attention(qs, ks, vs, True, window)
            return self.mesh.map(local, q, k, v)
        return attend

    def block(self, params, li, x, ba, rope, rot_dim, attend):
        """Layer ``li`` on every slot: pre-norm attention and SwiGLU, each
        with a residual. ``attend(q, k, v)`` maps each slot's q, k, v (b,
        S, heads, hd) to its attention output (b, S, q heads, hd). Returns
        (x, k, v) per slot."""
        mesh = self.mesh
        dtype = next(iter(x.values())).dtype
        S = next(iter(x.values())).shape[1]
        h = mesh.map(lambda s, xs: params[s].blocks[li].ln1(xs), x)
        q, k, v = self.project(params, li, h, ba, S, rope, rot_dim)
        o = {s: t.reshape(t.shape[0], S, -1)
             for s, t in attend(q, k, v).items()}
        a = self.out_proj(params, li, o, dtype)
        x = mesh.map(lambda s, xs, as_: xs + as_, x, a)
        h = mesh.map(lambda s, xs: params[s].blocks[li].ln2(xs), x)
        m = self.mlp(params, li, h, dtype)
        return mesh.map(lambda s, xs, ms: xs + ms, x, m), k, v

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

    def loss(self, lg, tokens, ba):
        """Next-token cross entropy of each slot's rows (vocab-parallel
        over 'model'), then the mean over the data slots (a psum over the
        data axes; a batch replicated over data counts each copy, so the
        mean is its loss). Returns the total on the first slot."""
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
            return ((z - gold_s) * mask).sum() / torch.clamp(mask.sum(),
                                                             min=1.0)

        loss = mesh.map(nll, lse, gold)
        if self.data:
            loss = mesh.psum(loss, self.data)
        return loss[mesh.slots[0]]

    # -- caches --------------------------------------------------------------

    def cache_init(self, B: int, seq_len: int, window_override=None,
                   device=None, dtype=torch.bfloat16):
        """Each slot's empty serving cache under ``cache_specs`` (``pos``
        0, K/V zeros in ``dtype``, ``kv_pos`` -1), on the slot's device
        (``device`` where the mesh has none)."""
        cfg, mesh = self.cfg, self.mesh
        full = serve_cache_init(cfg, B, seq_len, dtype=dtype,
                                window_override=window_override, device=META)
        specs = PART.cache_specs(full, cfg, None, mesh)
        self.set_cache_spec(B, full["attn"]["k"].shape[2])
        out = {}
        for s in mesh.slots:
            dev = mesh.device(s) if mesh.devices is not None else device
            attn = {}
            for n, t in full["attn"].items():
                shp = PART.shard_shape(mesh, specs["attn"][n], t.shape)
                attn[n] = (torch.full(shp, -1, dtype=t.dtype, device=dev)
                           if n == "kv_pos" else
                           torch.zeros(shp, dtype=t.dtype, device=dev))
            out[s] = {"pos": 0, "attn": attn}
        return out

    def set_cache_spec(self, B: int, S: int):
        """The K/V cache spec at B sequences of S slots."""
        self.cache_spec = PART.kv_cache_spec(
            (self.cfg.n_layers, B, S, self.cfg.n_kv_heads, self.hd),
            self.mesh)
        if self.cache_spec[2] is not None:
            raise NotImplementedError(
                "a cache split over its slots (neither Hkv nor hd divides "
                "'model'): the dense configs never need it")

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


def _forward(lm: ShardedLM, params, tokens, ba, *, remat=False,
             policy="full"):
    """Every slot's f32 vocab-shard logits of its rows (``forward``)."""
    cfg, mesh = lm.cfg, lm.mesh
    dtype = MODEL.compute_dtype(cfg)
    x = lm.embed(params, tokens, dtype)
    S = next(iter(x.values())).shape[1]
    rope, rot_dim = params[mesh.slots[0]].rope(0, S)
    attend = lm.prompt_attention(cfg.sliding_window)
    remat = remat and torch.is_grad_enabled()
    slots = list(mesh.slots)
    for li in range(cfg.n_layers):

        def layer(*xs, li=li):
            out, _, _ = lm.block(params, li, dict(zip(slots, xs)), ba, rope,
                                 rot_dim, attend)
            return tuple(out[s] for s in slots)

        xs = tuple(x[s] for s in slots)
        xs = MODEL._remat(policy)(layer, *xs) if remat else layer(*xs)
        x = dict(zip(slots, xs))
    return lm.logits(params, x)


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
        """The microbatch loop on every data slot, then the gradients
        reduced onto the moment shards: (mean loss, {name: {slot: f32
        gradient tile}}, global norm), each scalar on the first slot."""
        lm, mesh, tcfg = self.lm, self.mesh, self.tcfg
        M = tcfg.microbatches
        parts, ba = _batch_parts(lm, batch)
        rows = _placed_tokens(parts)[mesh.slots[0]].shape[0]
        if rows % M:
            raise ValueError(f"a slot's {rows} rows do not split into {M} "
                             f"microbatches")
        mesh.fork()
        for s in mesh.slots:
            for p in params[s].parameters():
                p.grad = None
        total = None
        for i in range(M):
            chunk = {s: {k: v[i * rows // M:(i + 1) * rows // M]
                         for k, v in p.items()} for s, p in parts.items()}
            tok = _placed_tokens(chunk)
            lg = _forward(lm, params, tok, ba, remat=tcfg.remat,
                          policy=tcfg.remat_policy)
            loss = lm.loss(lg, tok, ba)
            del lg
            mesh.join()
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        mesh.fork()
        with torch.no_grad():
            grads, norm = self._reduce(params, M)
        return total / (M * lm.n_data), grads, norm

    def _reduce(self, params, M):
        """Sum the slots' gradients over 'model' where a parameter is
        replicated over it (and over 'pod'), reduce-scatter them over
        'data' onto the moment shards (all-reduce where a moment is not
        split), scale by 1 / (microbatches × data slots); the global norm
        counts each distinct shard once."""
        lm, mesh = self.lm, self.mesh
        scale = 1.0 / (M * lm.n_data)
        grads = {}
        for n in self.names:
            g = {s: dict(params[s].named_parameters())[n].grad
                 for s in mesh.slots}
            if "model" not in lm.pspecs[n]:
                g = mesh.psum(g, "model")
            if "pod" in mesh.shape:
                g = mesh.psum(g, "pod")
            z = _zero1_dim(self.ospecs.mu[n])
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

    def update(self, params, opt_state, grads, norm):
        """Clip by the global norm, AdamW on each slot's shard, the
        updated tiles all-gathered over 'data'. Returns the lr."""
        mesh, tcfg = self.mesh, self.tcfg
        lr = self.lr_fn(opt_state[mesh.slots[0]].step + 1)
        tiles = {}
        for s in mesh.slots:
            with mesh.on(s):
                clip = torch.clamp(tcfg.grad_clip / torch.clamp(
                    norm[s], min=1e-9), max=1.0)
                named = dict(params[s].named_parameters())
                tile, gs = {}, {}
                for n in self.names:
                    z = _zero1_dim(self.ospecs.mu[n])
                    p = named[n]
                    if z is not None:
                        size = p.shape[z] // mesh.axis_size("data")
                        p = p.narrow(z, mesh.coord(s, "data") * size, size)
                    tile[n] = p
                    gs[n] = grads[n][s].mul_(clip)
                opt_state[s] = adamw.apply(tile, gs, opt_state[s], tcfg, lr)
                tiles[s] = tile
        for n in self.names:
            z = _zero1_dim(self.ospecs.mu[n])
            if z is None:
                continue
            full = mesh.all_gather({s: tiles[s][n] for s in mesh.slots},
                                   "data", dim=z)
            for s in mesh.slots:
                with mesh.on(s):
                    dict(params[s].named_parameters())[n].copy_(full[s])
        return lr


def make_sharded_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """The counterpart of the reference's ``jax.jit(make_train_step(cfg,
    tcfg), in_shardings=(params, opt, batch), out_shardings=(params, opt,
    None))`` on ``mesh``. The step takes each slot's parameters (a
    ``CausalLM`` of its shards with gradient, ``place(params,
    param_specs)``), AdamW states (``place(opt, opt_specs)``) and the
    whole batch (placed by ``batch_specs``), updates the parameters and
    moments in place and returns (params, opt_state, metrics with loss,
    grad_norm and lr on the first slot)."""
    plan = _TrainPlan(cfg, tcfg, mesh)

    def train_step(params, opt_state, batch):
        with use_mesh(mesh):
            loss, grads, norm = plan.grads(params, batch)
            with torch.no_grad():
                lr = plan.update(params, opt_state, grads, norm)
            mesh.join()
        return params, opt_state, {"loss": loss,
                                   "grad_norm": norm[mesh.slots[0]],
                                   "lr": lr}

    return train_step


def make_sharded_grads(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """The sharded step's loss and gradients, without the update:
    ``grads_fn(params, batch)`` -> (mean loss, {name: whole f32 gradient}
    gathered from the moment shards, global norm), for holding the SPMD
    program's gradients against the unsharded ones."""
    plan = _TrainPlan(cfg, tcfg, mesh)

    def grads_fn(params, batch):
        with use_mesh(mesh):
            loss, grads, norm = plan.grads(params, batch)
            mesh.join()
            placed = {s: {n: grads[n][s] for n in plan.names}
                      for s in mesh.slots}
            whole = PART.gather(placed, dict(plan.ospecs.mu), mesh)
        return loss, whole, norm[mesh.slots[0]]

    return grads_fn


def make_sharded_prefill_step(cfg: ArchConfig, shape: InputShape, mesh,
                              window_override: Optional[int] = None):
    """The counterpart of ``jax.jit(make_prefill_step(cfg, shape,
    window_override), in_shardings=(params, batch))`` on ``mesh``:
    ``prefill_step(params, batch)`` -> (the last position's logits (B, 1,
    Vp) f32 on the first slot, each slot's cache under ``cache_specs``, in
    the compute dtype: bf16 for the published configs, as
    ``serve_cache_init`` makes it unsharded). The prompt
    attends with ``cfg.sliding_window``; ``window_override`` sizes the
    cache, as unsharded."""
    lm = ShardedLM(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with use_mesh(mesh):
            parts, ba = _batch_parts(lm, batch)
            tok = _placed_tokens(parts)
            b, S = tok[mesh.slots[0]].shape
            B = lm.B_of(ba, b)
            mesh.fork()
            dev = tok[mesh.slots[0]].device
            dtype = MODEL.compute_dtype(cfg)
            cache = lm.cache_init(B, shape.seq_len, window_override,
                                  device=dev, dtype=dtype)
            x = lm.embed(params, tok, dtype)
            rope, rot_dim = params[mesh.slots[0]].rope(0, S)
            attend = lm.prompt_attention(cfg.sliding_window)
            for li in range(cfg.n_layers):
                x, k, v = lm.block(params, li, x, ba, rope, rot_dim, attend)
                mesh.map(lambda s, ks, vs: MODEL._fill_ring(
                    cache[s]["attn"], li, lm.cache_part(s, ks),
                    lm.cache_part(s, vs), S), k, v)
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
    writes the token's K/V into its cache shard; where the cache splits
    the head dim, the layer's K/V are gathered over 'model' to whole
    heads before L3."""
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
            ck0 = cache[s0]["attn"]["k"]
            lm.set_cache_spec(lm.B_of(ba, ck0.shape[1]), ck0.shape[2])
            gather = lm.cache_spec[4] is not None
            mesh.fork()
            dtype = MODEL.compute_dtype(cfg)
            x = lm.embed(params, tok, dtype)
            rope, rot_dim = params[s0].rope(pos, 1)

            def decode_attention(li):
                """``attend`` for one token at layer ``li``: the token's
                K/V into each slot's cache shard, the layer gathered over
                'model' to whole heads where the cache splits the head
                dim, then L3 per slot."""
                def write(s, ks, vs):
                    c = cache[s]["attn"]
                    ring = window > 0 and c["k"].shape[2] <= window
                    attn_cache_update(c["k"][li], c["v"][li],
                                      c["kv_pos"][li], lm.cache_part(s, ks),
                                      lm.cache_part(s, vs), pos, ring)

                def local(s, qs, ks, vs):
                    held = ((0, cfg.n_kv_heads) if gather
                            else lm.cache_ranges(s)[0])
                    ks, vs = lm.kv_for_q(s, ks, vs, held)
                    return L.decode_attention(
                        qs[:, 0], ks, vs, cache[s]["attn"]["kv_pos"][li],
                        pos, window=window)[:, None]

                def attend(q, k, v):
                    mesh.map(write, k, v)
                    ck = {s: cache[s]["attn"]["k"][li] for s in mesh.slots}
                    cv = {s: cache[s]["attn"]["v"][li] for s in mesh.slots}
                    if gather:
                        ck = mesh.all_gather(ck, "model", dim=3)
                        cv = mesh.all_gather(cv, "model", dim=3)
                    return mesh.map(local, q, ck, cv)
                return attend

            for li in range(cfg.n_layers):
                x, _, _ = lm.block(params, li, x, ba, rope, rot_dim,
                                   decode_attention(li))
            logits = lm.full_logits(lm.logits(params, x), ba)
            for s in mesh.slots:
                cache[s]["pos"] = pos + 1
            mesh.join()
        return logits, cache

    return serve_step
