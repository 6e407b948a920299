"""The audio family of the port (whisper: layernorm, sinusoidal
positions, the GELU MLP, the encoder, cross-attention and its cache)
against the JAX reference.

The model is the ``smoke_variant`` of whisper-medium (2 encoder and 2
decoder layers, d 256, 4 heads of 32 with no GQA, 16 stub frames) in f32.
Parameters come from the reference's ``init_params`` and cross with
``convert.llm_params_from_numpy``; tokens and frame embeddings are
numpy-seeded (``synthetic_token_batches``). The reference's decode
steps run its Pallas decode-attention kernel in interpret mode over the
self cache (``REPRO_PALLAS_DECODE_ATTN=1``); its prompts and train steps
run its plain attention (``_flash_attend``), as its cross-attention
always does. Its Pallas flash-attention route is not used here: its
wrapper pads K/V to whole tiles and masks the padding only through the
causal test, so the non-causal encoder over 16 (or 1,500) frames
attends to zero keys there (``test_reference_pallas_route_attends_to_
padded_keys`` pins it; ROADMAP §C); its backward also takes only whole
512-position tiles. The port runs its kernels' plain versions (CPU
tensors), which mask the ragged edge.

Tolerances, relative to the largest reference value
(``assert_rel_close``), as in ``test_torch_llm.py`` and
``test_torch_train.py``:
- f32 model outputs and caches: 1e-4 (the same f32 arithmetic through
  2 + 2 layers, summed in other orders; measured: forward 7.3e-7,
  prefill 6.9e-7, cross_k / cross_v 4.8e-7 / 5.7e-7, decode steps
  4.9e-7 to 7.6e-7);
- single layers in f32: 1e-5; in bf16: 2^-7, one bf16 step of the value
  (both round f32 values that differ in summation order);
- train steps: loss and grad norm 1e-5, lr 1e-6, AdamW moments 2e-4 of
  each tensor's largest value (the reference's own limit for its
  attention backward);
- bf16 serving steps: 5e-2 (``test_torch_llm.py``'s bf16 limit).

The reference's ``decode_step`` embeds the token without its sinusoidal
position, where its ``forward`` and ``prefill`` add it, so its decode
logits are not its forward's; the port keeps that behaviour, and
``test_decode_steps_match_reference`` pins it on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.data import tokens as TTOK
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from torch_helpers import assert_rel_close, llm_cfgs, np_tree
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

ARCH = "whisper_medium"
B, S_PROMPT, N_DECODE, MAX_LEN = 2, 8, 4, 16
RTOL = 1e-4
LAYER_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
TRAIN_S, N_STEPS = 64, 3
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
MOMENT_RTOL = 2e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _batch(cfg, seq, seed=0):
    """numpy ``{"tokens": (B, seq) int32, "audio_embeds": (B, F, d)}``,
    the embeddings as f32 (bf16 values)."""
    b = next(TTOK.synthetic_token_batches(cfg, B, seq, seed=seed,
                                          device="cpu"))
    return {k: v.float().numpy() if k == "audio_embeds" else v.numpy()
            for k, v in b.items()}


def _as(batch, conv, lo=0, hi=None):
    """The batch with its tokens cut to [lo, hi), every array through
    ``conv``; the frame embeddings stay whole."""
    return {k: conv(np.ascontiguousarray(v[:, lo:hi]) if k == "tokens"
                    else v) for k, v in batch.items()}


class _Reference:
    """The reference's whisper smoke model in f32: params, forward,
    prefill and decode steps (the Pallas decode kernel in interpret
    mode)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.models import model as JM
        from repro.models.kvcache import serve_cache_init
        self.jcfg, self.cfg = llm_cfgs(ARCH, dtype="float32")
        self.jtree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree = np_tree(self.jtree)
        self.batch = _batch(self.cfg, S_PROMPT + N_DECODE)
        toks = jnp.asarray(self.batch["tokens"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
            logits, _ = JM.forward(self.jtree, self.jcfg,
                                   _as(self.batch, jnp.asarray), remat=False)
            self.forward = np.asarray(logits)
            cache = serve_cache_init(self.jcfg, B, MAX_LEN, dtype=jnp.float32)
            logits, cache = jax.jit(JM.prefill, static_argnums=(1,))(
                self.jtree, self.jcfg,
                _as(self.batch, jnp.asarray, 0, S_PROMPT), cache)
            self.prefill_logits = np.asarray(logits)
            self.prefill_cache = np_tree(cache)
            step = jax.jit(lambda p, c, t: JM.decode_step(p, self.jcfg, c, t))
            self.decode_logits = []
            for i in range(S_PROMPT, S_PROMPT + N_DECODE):
                logits, cache = step(self.jtree, cache, toks[:, i:i + 1])
                self.decode_logits.append(np.asarray(logits))
            self.decode_cache = np_tree(cache)

    def port(self):
        params = CV.llm_params_from_numpy(self.tree, self.cfg, "cpu")
        cache = TKV.serve_cache_init(self.cfg, B, MAX_LEN,
                                     dtype=torch.float32, device="cpu")
        return params, cache


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _assert_cache(cache, want, rtol=RTOL):
    assert cache["pos"] == int(want["pos"])
    np.testing.assert_array_equal(cache["attn"]["kv_pos"].numpy(),
                                  want["attn"]["kv_pos"])
    for got, w in ((cache["attn"]["k"], want["attn"]["k"]),
                   (cache["attn"]["v"], want["attn"]["v"]),
                   (cache["cross_k"], want["cross_k"]),
                   (cache["cross_v"], want["cross_v"])):
        assert got.shape == w.shape
        assert_rel_close(got.float().numpy(), np.asarray(w, np.float32),
                         rtol)


# ---------------------------------------------------------------------------
# config, tokens, parameters
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    from repro.configs.base import get_config
    jc, tc = get_config(ARCH), TCB.get_config("whisper-medium")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (dataclasses.asdict(tc.smoke_variant())
            == dataclasses.asdict(jc.smoke_variant()))
    assert tc.param_count() == jc.param_count() == 757_752_832
    assert tc.padded_vocab_size == 51_968 and tc.is_encdec
    assert TCB.NOT_PORTED == {}
    assert tc.family in TCB.FAMILIES and tc.family in TCB.ATTENTION_FAMILIES


def test_tokens_match_reference():
    """The same tokens and the same bf16 frame embeddings, drawn after
    the tokens from one generator."""
    from repro.configs.base import get_config
    from repro.data.tokens import synthetic_token_batches
    cfg = TCB.get_config(ARCH).smoke_variant()
    want_it = synthetic_token_batches(get_config(ARCH).smoke_variant(), 3,
                                      33, seed=5)
    got_it = TTOK.synthetic_token_batches(cfg, 3, 33, seed=5, device="cpu")
    for _ in range(2):
        want, got = next(want_it), next(got_it)
        assert set(got) == set(want) == {"tokens", "audio_embeds"}
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert got["audio_embeds"].dtype == torch.bfloat16
        assert got["audio_embeds"].shape == (3, cfg.n_audio_frames,
                                             cfg.d_model)
        np.testing.assert_array_equal(
            got["audio_embeds"].float().numpy(),
            np.asarray(want["audio_embeds"], np.float32))


def test_params_round_trip_applies_the_cast_rule():
    """bf16 serving storage: the smoke model's large matrices go to bf16
    as the reference's ``_cast_tree`` casts them, its small arrays
    (norms, biases) stay f32; back to the reference's tree unchanged.
    At full width the rule also casts whisper-medium's stacked biases and
    norms ((24, 4,096), (24, 1,024)), which ``serve_dtype`` must apply
    per encoder and decoder stack as the reference does."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    jcfg, cfg = llm_cfgs(ARCH)
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    assert params.enc_blocks[0].attn.wq.dtype == torch.bfloat16
    assert params.blocks[0].cross_attn.wk.dtype == torch.bfloat16
    assert params.blocks[1].mlp.b_in.dtype == torch.float32
    assert params.enc_final_norm.bias.dtype == torch.float32
    back = CV.llm_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JM._cast_tree(tree, jnp.bfloat16))
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, w)
    full = TCB.get_config(ARCH)
    for name, shape, n in (("enc_blocks.0.mlp.b_in", (4096,), 24),
                           ("blocks.3.ln_x.bias", (1024,), 24),
                           ("enc_final_norm.scale", (1024,), 0)):
        assert TM.n_stacked(full, name) == n
        stacked = jnp.zeros(((n,) if n else ()) + shape, jnp.float32)
        want_dt = JM._cast_tree({"a": stacked}, jnp.bfloat16)["a"].dtype
        got_dt = TM.serve_dtype(shape, full, TM.n_stacked(full, name))
        assert str(got_dt).split(".")[-1] == str(want_dt), name


def test_f32_params_and_adamw_state_round_trip():
    """The reference's f32 parameters and AdamW state (after one step)
    cross to the port and back unchanged, the encoder's stack included."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.models import model as JM
    from repro.optim import adamw as JA
    jcfg, cfg = llm_cfgs(ARCH)
    tree = JM.init_params(jax.random.key(1), jcfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), tree)
    _, state = JA.apply(tree, grads, JA.init(tree), TrainConfig(), 1e-3)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.parameters())
    opt = CV.adamw_state_from_numpy(np_tree(state._asdict()), params)
    assert any(n.startswith("enc_blocks.") for n in opt.mu)
    back = {"params": CV.llm_params_to_numpy(params),
            **CV.adamw_state_to_numpy(opt, params)}
    want = {"params": np_tree(tree), **np_tree(state._asdict())}
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, w)


def test_init_params_layout():
    """Seeded init: layernorm scales one and biases zero, the GELU MLP's
    biases zero, matrices normal × 1/√fan_in; tied embeddings."""
    cfg = TCB.get_config(ARCH).smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params.unembed is None and len(params.enc_blocks) == 2
    enc, dec = params.enc_blocks[0], params.blocks[0]
    assert isinstance(enc.ln1, TL.LayerNorm)
    assert isinstance(dec.mlp, TL.GeluMLP)
    for t in (enc.ln1.bias, dec.ln_x.bias, dec.mlp.b_in, dec.mlp.b_out,
              params.enc_final_norm.bias):
        assert t.dtype == torch.float32 and float(t.abs().max()) == 0.0
    assert float(dec.ln2.scale.min()) == float(dec.ln2.scale.max()) == 1.0
    std = float(dec.mlp.w_out.float().std())
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert not any(p.requires_grad for p in params.parameters())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 96)) * 2 + 0.5).astype(np.float32)
    scale = rng.normal(size=(96,)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    want = JL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)},
                        jnp.asarray(x, dtype), 1e-5)
    got = TL.layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                       torch.from_numpy(x).to(getattr(torch, dtype)), 1e-5)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert_rel_close(got.float().numpy(), np.asarray(want, np.float32),
                     LAYER_RTOL[dtype])


@pytest.mark.parametrize("n_pos, d", [(16, 256), (1500, 1024)])
def test_sinusoidal_positions_match_reference(n_pos, d):
    """Interleaved sin/cos, at the smoke model's and whisper-medium's
    frame counts. Each library computes the divisor 10000^(2i/d) in f32
    (4 of whisper's 512 differ by an ulp) and rounds pos / divisor once,
    so an angle may differ by two f32 ulps of its own size, and sin and
    cos move by at most that (measured: up to 2^-15 at angles of
    64-1,024 rad, where an ulp is 2^-17 to 2^-14): the limit is two ulps
    of the angle plus 2e-7 for the functions' own rounding."""
    from repro.models import layers as JL
    want = np.asarray(JL.sinusoidal_positions(n_pos, d))
    got = TL.sinusoidal_positions(n_pos, d)
    assert got.dtype == torch.float32 and got.shape == (n_pos, d)
    pos = np.arange(n_pos, dtype=np.float32)[:, None]
    dim = np.arange(0, d, 2, dtype=np.float32)
    angle = np.repeat(pos / np.power(np.float32(10_000.0), dim / d), 2, 1)
    assert angle.dtype == np.float32
    limit = 2 * np.spacing(angle) + 2e-7
    assert np.all(np.abs(got.numpy() - want) <= limit)
    np.testing.assert_array_equal(got[:, 1::2].numpy()[0], 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh GELU in f32 between the two products, the biases cast to
    the activation dtype before they are added."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(1)
    d, f = 64, 160
    p = {"w_in": rng.normal(size=(d, f)) / d ** 0.5,
         "b_in": rng.normal(size=(f,)),
         "w_out": rng.normal(size=(f, d)) / f ** 0.5,
         "b_out": rng.normal(size=(d,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = JL.gelu_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, dtype))
    mlp = TL.GeluMLP(*(torch.from_numpy(p[k])
                       for k in ("w_in", "b_in", "w_out", "b_out")))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert_rel_close(got.float().numpy(), np.asarray(want, np.float32),
                     LAYER_RTOL[dtype])


def test_blocks_match_reference(ref):
    """One encoder block (non-causal, over the frames) and one decoder
    block with cross-attention to an encoder output: activations, the
    self-attention's K/V and the cross K/V, against the reference's
    ``_dense_block_apply`` and ``_cross_kv`` (plain attention)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cfg, jcfg = ref.cfg, ref.jcfg
    rng = np.random.default_rng(2)
    F, S, d = cfg.n_audio_frames, 11, cfg.d_model
    frames = rng.normal(size=(B, F, d)).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    params, _ = ref.port()
    layer0 = jax.tree.map(lambda a: a[0], ref.jtree)
    blk = {k: layer0[k] for k in ("enc_blocks", "blocks")}
    w_enc, _, (wk, wv) = JM._dense_block_apply(
        blk["enc_blocks"], jcfg, jnp.asarray(frames), jnp.arange(F),
        window=0, moe=False, causal=False)
    with torch.no_grad():
        got, (k, v), _ = params.enc_blocks[0](
            torch.from_numpy(frames), (None, None), 0, causal=False)
    for g, w in ((got, w_enc), (k, wk), (v, wv)):
        assert_rel_close(g.numpy(), np.asarray(w), LAYER_RTOL["float32"])
    cross = JM._cross_kv(blk["blocks"], jcfg, jnp.asarray(frames))
    w_dec, _, (wk, wv) = JM._dense_block_apply(
        blk["blocks"], jcfg, jnp.asarray(x), jnp.arange(S), window=0,
        moe=False, cross=cross)
    with torch.no_grad():
        got, (k, v), (ck, cv) = params.blocks[0](
            torch.from_numpy(x), (None, None), 0, torch.from_numpy(frames))
    assert ck.shape == (B, F, cfg.n_kv_heads, cfg.resolved_head_dim)
    for g, w in ((got, w_dec), (k, wk), (v, wv), (ck, cross[0]),
                 (cv, cross[1])):
        assert_rel_close(g.numpy(), np.asarray(w), LAYER_RTOL["float32"])


def test_reference_pallas_route_attends_to_padded_keys():
    """Non-causal attention over a ragged length (the encoder's frames),
    f32: the port's ``flash_attention`` (its plain version here; L1 masks
    the ragged edge the same way on the card) equals the reference's
    plain ``_flash_attend`` within 1e-5, at the smoke model's 16 frames
    and at Sq != Skv (cross-attention); the reference's Pallas wrapper
    (``kernels/flash_attention/ops.flash_attention``, which
    ``attention_apply`` takes under ``REPRO_PALLAS_ATTN=1``) pads K/V to
    its 512-key tile with zeros and leaves them unmasked without the
    causal test, so it moves the result by more than 0.1 of its largest
    value: a quirk of the reference, which the serve runs above avoid."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as FAK
    from repro.models.layers import _flash_attend
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rng = np.random.default_rng(5)
    for sq, skv in ((16, 16), (11, 16)):
        q = rng.normal(size=(B, sq, 4, 32)).astype(np.float32)
        k, v = (rng.normal(size=(B, skv, 4, 32)).astype(np.float32)
                for _ in range(2))
        jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
        want = np.asarray(_flash_attend(jq, jk, jv, causal=False, window=0,
                                        q_offset=0))
        got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=False)
        assert_rel_close(got.numpy(), want, 1e-5)
        pallas = np.asarray(FAK.flash_attention(jq, jk, jv, causal=False))
        assert np.abs(pallas - want).max() > 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference (f32)
# ---------------------------------------------------------------------------


def test_forward_matches_reference(ref):
    params, _ = ref.port()
    logits, aux = TM.forward(params, ref.cfg,
                             _as(ref.batch, torch.from_numpy))
    assert logits.dtype == torch.float32 and aux == {}
    assert logits.shape == (B, S_PROMPT + N_DECODE,
                            ref.cfg.padded_vocab_size)
    assert_rel_close(logits.numpy(), ref.forward, RTOL)


def test_prefill_matches_reference(ref):
    """Last logits, the self-attention cache and the cross cache
    (``cross_k`` / ``cross_v`` (L, B, F, Hkv, hd)); ``cross_pos`` is every
    frame's slot."""
    params, cache = ref.port()
    logits, cache = TM.prefill(params, ref.cfg,
                               _as(ref.batch, torch.from_numpy, 0, S_PROMPT),
                               cache)
    assert logits.shape == (B, 1, ref.cfg.padded_vocab_size)
    assert_rel_close(logits.numpy(), ref.prefill_logits, RTOL)
    _assert_cache(cache, ref.prefill_cache)
    F = ref.cfg.n_audio_frames
    assert cache["cross_pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["cross_pos"].numpy(), np.arange(F))
    # prefill computes the forward's function at the prompt's last token
    assert_rel_close(logits[:, 0].numpy(), ref.forward[:, S_PROMPT - 1],
                     RTOL)


def test_decode_steps_match_reference(ref):
    """Four teacher-forced decode steps after prefill against the
    reference's ``decode_step``, and the cache after them. Neither
    package's decode equals its forward at the same position: the
    reference's ``decode_step`` adds no sinusoidal position to the token
    (its ``forward`` and ``prefill`` do), and the port keeps that; the gap
    (measured 0.41-0.54 of the largest forward logit on both sides) is
    pinned at more than 100× the comparison's limit."""
    params, cache = ref.port()
    toks = torch.from_numpy(ref.batch["tokens"])
    TM.prefill(params, ref.cfg,
               _as(ref.batch, torch.from_numpy, 0, S_PROMPT), cache)
    fwd, _ = TM.forward(params, ref.cfg, _as(ref.batch, torch.from_numpy))
    scale = float(np.abs(ref.forward).max())
    for i, want in enumerate(ref.decode_logits):
        t = S_PROMPT + i
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       toks[:, t:t + 1])
        assert_rel_close(logits.numpy(), want, RTOL)
        ref_gap = float(np.abs(want[:, 0] - ref.forward[:, t]).max())
        port_gap = float((logits[:, 0] - fwd[:, t]).abs().max())
        assert min(ref_gap, port_gap) > 100 * RTOL * scale, (ref_gap,
                                                              port_gap)
    _assert_cache(cache, ref.decode_cache)


def test_bf16_steps_match_reference():
    """The serving steps as a user calls them: bf16 weights and
    activations, the default bf16 cache (self and cross) made by
    ``make_prefill_step``, then ``make_serve_step``; against the
    reference's steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import InputShape
    from repro.models import model as JM
    from repro.models import steps as JST
    jcfg, cfg = llm_cfgs(ARCH)
    shape = TCB.InputShape("serve", MAX_LEN, B, "prefill")
    jshape = InputShape("serve", MAX_LEN, B, "prefill")
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    batch = _batch(cfg, S_PROMPT + 2)
    jt = jnp.asarray(batch["tokens"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
        want, jcache = jax.jit(JST.make_prefill_step(jcfg, jshape))(
            tree, _as(batch, jnp.asarray, 0, S_PROMPT))
        serve = jax.jit(JST.make_serve_step(jcfg))
        want_steps = []
        for i in range(S_PROMPT, S_PROMPT + 2):
            lg, jcache = serve(tree, jcache, jt[:, i:i + 1])
            want_steps.append(np.asarray(lg))
    got, cache = TST.make_prefill_step(cfg, shape)(
        params, _as(batch, torch.from_numpy, 0, S_PROMPT))
    assert cache["cross_k"].dtype == torch.bfloat16
    assert_rel_close(got.numpy(), np.asarray(want), 5e-2)
    step = TST.make_serve_step(cfg)
    t = torch.from_numpy(batch["tokens"])
    for i, w in zip(range(S_PROMPT, S_PROMPT + 2), want_steps):
        got, cache = step(params, cache, t[:, i:i + 1])
        assert_rel_close(got.numpy(), w, 5e-2)
    jc = np_tree(jcache)
    assert cache["pos"] == int(jc["pos"])
    for n in ("cross_k", "cross_v"):
        assert_rel_close(cache[n].float().numpy(),
                         np.asarray(jc[n], np.float32), 2 ** -7)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ref():
    """The reference's ``make_train_step`` for N_STEPS steps of B ×
    TRAIN_S tokens with B × 16 frames, 2 microbatches, remat, from its
    ``init_params(key(1))`` (plain attention)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.models import model as JM
    from repro.models import steps as JST
    from repro.optim import adamw as JA
    jcfg, cfg = llm_cfgs(ARCH, dtype="float32")
    tcfg = TCB.TrainConfig(microbatches=2, **TRAIN_KW)
    tree = JM.init_params(jax.random.key(1), jcfg)
    tree0 = np_tree(tree)
    gen = TTOK.synthetic_token_batches(cfg, B, TRAIN_S, seed=3, device="cpu")
    batches = [{k: v.float().numpy() if k == "audio_embeds" else v.numpy()
                for k, v in next(gen).items()} for _ in range(N_STEPS)]
    opt = JA.init(tree)
    step = jax.jit(JST.make_train_step(
        jcfg, TrainConfig(**dataclasses.asdict(tcfg))))
    metrics = []
    for batch in batches:
        tree, opt, m = step(tree, opt, _as(batch, jnp.asarray))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, tcfg=tcfg, tree0=tree0, batches=batches,
                metrics=metrics, opt=np_tree(opt._asdict()))


def test_train_steps_match_reference(train_ref):
    """Loss, grad norm and lr of each step, and the AdamW moments after
    the last, through the port's autograd Function (plain L1 and L2)."""
    import jax
    r = train_ref
    params = CV.llm_params_from_numpy(r["tree0"], r["cfg"], "cpu",
                                      train=True)
    opt = TA.init(dict(params.named_parameters()))
    step = TST.make_train_step(r["cfg"], r["tcfg"])
    for batch, want in zip(r["batches"], r["metrics"]):
        params, opt, m = step(params, opt, _as(batch, torch.from_numpy))
        assert set(m) == set(want) == {"loss", "grad_norm", "lr"}
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=rtol,
                                       err_msg=k)
    assert opt.step == int(r["opt"]["step"]) == N_STEPS
    got = CV.adamw_state_to_numpy(opt, params)
    for name in ("mu", "nu"):
        flat_g = jax.tree_util.tree_flatten_with_path(got[name])[0]
        flat_w = jax.tree_util.tree_flatten_with_path(r["opt"][name])[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=MOMENT_RTOL * float(np.abs(w).max()),
                err_msg=f"{name} {path}")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """``remat`` on (either policy for the decoder; the encoder always
    recomputes its whole block) and off: equal gradients (1e-6), the
    encoder's and the cross-attention's included."""
    cfg = dataclasses.replace(TCB.get_config(ARCH).smoke_variant(),
                              dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 24, 4).items()}
    grads = []
    for remat in (False, True):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                train=True)
        loss, _ = TST.loss_fn(params, cfg, batch, remat=remat,
                              remat_policy=policy)
        loss.backward()
        grads.append({n: p.grad.numpy() for n, p in
                      params.named_parameters()})
    assert float(np.abs(grads[0]["enc_blocks.0.attn.wq"]).max()) > 0
    for n in grads[0]:
        assert_rel_close(grads[1][n], grads[0][n], 1e-6)
