"""The attention families' serving path of the port (configs, tokens,
layers, KV cache, model, steps, parameter conversion) against the JAX
reference.

Parameters come from the reference's ``init_params`` and are carried
across with ``convert.llm_params_from_numpy``; tokens (and a vlm batch's
image embeddings) are numpy-seeded. The models are the ``smoke_variant``
of Qwen3-4B (GQA, qk-norm, padded vocabulary) and Llama-3-8B (dense),
Granite-MoE and Mixtral (moe: 4 experts, top-2 routing with capacity
drops in prefill; Mixtral's 64-token sliding window under an 80-token
prompt, so that its cache is a ring that wraps) and InternVL2 (vlm: 8
image positions before the text), in f32, with ``n_kv_heads=2`` so that
GQA groups are > 1 (the smoke variant alone gives group 1). The reference
runs its Pallas kernels in interpret mode: flash attention in prefill
(``REPRO_PALLAS_ATTN=1``) and decode attention in ``decode_step``
(``REPRO_PALLAS_DECODE_ATTN=1``). The port runs its kernels' plain
versions (CPU tensors).

Tolerances, relative to the largest reference value (``assert_rel_close``):
- f32: 1e-4. Both sides run the same f32 arithmetic through two layers;
  sums are taken in other orders (XLA's dots and the Pallas kernels'
  online softmax against torch's matmuls and the plain full-row softmax),
  which leaves differences of ~1e-6 relative; 1e-4 is the limit the port
  is held to.
- bf16 weights and activations (``test_bf16_steps_match_reference``):
  5e-2. Every matmul output is rounded to bf16 (2^-8 relative) by both
  sides, but after sums in different orders, so single roundings differ
  by one bf16 step; through two layers and the unembedding these reach
  ~1e-2 of the largest logit.
- The KV cache in f32 is compared at 1e-4, in bf16 at 2^-7 (one bf16
  step of the value, plus the difference of the f32 values it rounds).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.data import tokens as TTOK
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from torch_helpers import assert_rel_close
from torch_helpers import llm_cfgs as _cfgs
from torch_helpers import np_tree as _np_tree

ARCHS = ["qwen3_4b", "llama3_8b", "granite_moe_1b_a400m", "mixtral_8x7b",
         "internvl2_1b"]
B, S_PROMPT, MAX_LEN, N_DECODE = 2, 40, 48, 4
# per arch: Mixtral's prompt passes its 64-token window (the cache is a
# 64-slot ring); InternVL2's 8 image positions take cache slots too
ARCH_KW = {"mixtral_8x7b": dict(s_prompt=80),
           "internvl2_1b": dict(max_len=64)}
RTOL = 1e-4


def _batch(cfg, seq, seed=0):
    """numpy ``{"tokens": (B, seq) int32}`` and, for a vlm config, its
    ``image_embeds`` (B, n_image_tokens, d) as f32 (bf16 values)."""
    b = next(TTOK.synthetic_token_batches(cfg, B, seq, seed=seed,
                                          device="cpu"))
    return {k: v.float().numpy() if k == "image_embeds" else v.numpy()
            for k, v in b.items()}


def _tokens(cfg, seq, seed=0):
    return _batch(cfg, seq, seed)["tokens"]


def _text_slice(batch, lo, hi, conv):
    """The batch with its tokens cut to [lo, hi), each array passed
    through ``conv`` (``jnp.asarray`` or ``torch.from_numpy``); the image
    embeddings stay whole."""
    return {k: conv(np.ascontiguousarray(v[:, lo:hi]) if k == "tokens"
                    else v) for k, v in batch.items()}


class _Reference:
    """One reference serve run per arch: params, forward (and its aux),
    prefill through the Pallas flash kernel, decode steps through the
    Pallas decode kernel (both in interpret mode)."""

    def __init__(self, arch, window_override=None, s_prompt=S_PROMPT,
                 max_len=MAX_LEN, n_decode=N_DECODE):
        import jax
        import jax.numpy as jnp
        from repro.models import model as JM
        from repro.models.kvcache import serve_cache_init
        self.jcfg, self.cfg = _cfgs(arch, dtype="float32", n_kv_heads=2)
        jtree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree = _np_tree(jtree)
        self.batch = _batch(self.cfg, s_prompt + n_decode)
        self.tokens = self.batch["tokens"]
        self.n_image = (self.cfg.n_image_tokens
                        if "image_embeds" in self.batch else 0)
        self.s_prompt, self.max_len = s_prompt, max_len
        self.window_override = window_override
        toks = jnp.asarray(self.tokens)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS_ATTN", "1")
            mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
            out, aux = JM.forward(
                jtree, self.jcfg,
                _text_slice(self.batch, 0, None, jnp.asarray), remat=False)
            self.forward = np.asarray(out)
            self.aux = {k: float(v) for k, v in aux.items()}
            cache = serve_cache_init(self.jcfg, B, max_len, dtype=jnp.float32,
                                     window_override=window_override)
            logits, cache = jax.jit(JM.prefill, static_argnums=(1,))(
                jtree, self.jcfg,
                _text_slice(self.batch, 0, s_prompt, jnp.asarray), cache)
            self.prefill_logits = np.asarray(logits)
            self.prefill_cache = _np_tree(cache)
            step = jax.jit(lambda p, c, t: JM.decode_step(
                p, self.jcfg, c, t, window_override=window_override))
            self.decode_logits = []
            for i in range(s_prompt, s_prompt + n_decode):
                logits, cache = step(jtree, cache, toks[:, i:i + 1])
                self.decode_logits.append(np.asarray(logits))
            self.decode_cache = _np_tree(cache)

    def port(self):
        params = CV.llm_params_from_numpy(self.tree, self.cfg, "cpu")
        cache = TKV.serve_cache_init(self.cfg, B, self.max_len,
                                     dtype=torch.float32,
                                     window_override=self.window_override,
                                     device="cpu")
        return params, cache


_REFS = {}


def reference(arch, **kw):
    kw = dict(ARCH_KW.get(arch, {}), **kw)
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REFS:
        _REFS[key] = _Reference(arch, **kw)
    return _REFS[key]


def _assert_cache(cache, want, rtol=RTOL):
    assert cache["pos"] == int(want["pos"])
    np.testing.assert_array_equal(cache["attn"]["kv_pos"].numpy(),
                                  want["attn"]["kv_pos"])
    for n in ("k", "v"):
        assert_rel_close(cache["attn"][n].float().numpy(),
                         np.asarray(want["attn"][n], np.float32), rtol)


# ---------------------------------------------------------------------------
# configs, tokens, parameters
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    from repro.configs.base import get_config
    for arch in TCB.DENSE_IDS + TCB.MOE_IDS + TCB.VLM_IDS:
        jc, tc = get_config(arch), TCB.get_config(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert (dataclasses.asdict(tc.smoke_variant())
                == dataclasses.asdict(jc.smoke_variant()))
    assert TCB.get_config("qwen3-4b").padded_vocab_size == 152_064
    granite = TCB.get_config("granite-moe-1b-a400m")
    assert (granite.param_count(), granite.active_param_count()) == (
        1_334_578_176, 428_608_512)
    assert TCB.get_config("mixtral_8x7b").param_count() == 46_702_526_464
    assert list(TCB.NOT_PORTED) == ["whisper_medium"]
    for arch in TCB.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TCB.get_config(arch)


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_1b"])
def test_tokens_match_reference(arch):
    """The same tokens and, for the vlm family, the same bf16 image
    embeddings, drawn after the tokens from one generator."""
    from repro.configs.base import get_config
    from repro.data.tokens import synthetic_token_batches
    cfg = TCB.get_config(arch).smoke_variant()
    ref = synthetic_token_batches(get_config(arch).smoke_variant(), 3, 97,
                                  seed=5)
    port = TTOK.synthetic_token_batches(cfg, 3, 97, seed=5, device="cpu")
    for _ in range(2):
        want, got = next(ref), next(port)
        assert set(got) == set(want)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        if "image_embeds" in want:
            assert got["image_embeds"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got["image_embeds"].float().numpy(),
                np.asarray(want["image_embeds"], np.float32))


def test_params_round_trip_applies_the_cast_rule():
    """bf16 config: large matrices go to bf16 exactly as the reference's
    ``_cast_tree`` casts them; small arrays (here the norm scales, also
    when stacked) stay f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    jcfg, cfg = _cfgs("qwen3_4b")
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(_np_tree(tree), cfg, "cpu")
    assert params.blocks[0].attn.wq.dtype == torch.bfloat16
    assert params.blocks[0].attn.q_norm.scale.dtype == torch.float32
    assert params.final_norm.scale.dtype == torch.float32
    back = CV.llm_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JM._cast_tree(tree, jnp.bfloat16))
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, w)


def test_init_params_layout():
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              n_kv_heads=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    blk = params.blocks[0]
    assert params.table.shape == (cfg.padded_vocab_size, cfg.d_model)
    assert params.unembed.dtype == torch.bfloat16
    assert blk.attn.wk.shape == (cfg.d_model, 2 * cfg.resolved_head_dim)
    assert blk.ln1.scale.dtype == torch.float32
    assert float(blk.ln1.scale.min()) == float(blk.ln1.scale.max()) == 1.0
    std = float(blk.mlp.w_down.float().std())
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert not any(p.requires_grad for p in params.parameters())


def test_other_families_raise():
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              family="audio")
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError):
        TKV.serve_cache_init(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference (f32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits and aux: the moe family's layer means of ``moe_aux`` and
    ``moe_dropped``, nothing for the others."""
    ref = reference(arch)
    params, _ = ref.port()
    logits, aux = TM.forward(
        params, ref.cfg, _text_slice(ref.batch, 0, None, torch.from_numpy))
    assert logits.dtype == torch.float32
    assert logits.shape[1] == ref.n_image + ref.tokens.shape[1]
    assert_rel_close(logits.numpy(), ref.forward, RTOL)
    assert set(aux) == set(ref.aux) == (
        {"moe_aux", "moe_dropped"} if ref.cfg.is_moe else set())
    for k, want in ref.aux.items():
        np.testing.assert_allclose(float(aux[k]), want, rtol=RTOL,
                                   atol=RTOL, err_msg=k)
    # the padded vocabulary rows (151,936 -> 152,064 at full width)
    V = ref.cfg.vocab_size
    if ref.cfg.padded_vocab_size > V:
        assert float(logits[..., V:].max()) == -1e9


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    ref = reference(arch)
    params, cache = ref.port()
    logits, cache = TM.prefill(
        params, ref.cfg,
        _text_slice(ref.batch, 0, ref.s_prompt, torch.from_numpy), cache)
    assert logits.shape == (B, 1, ref.cfg.padded_vocab_size)
    assert cache["pos"] == ref.n_image + ref.s_prompt
    assert_rel_close(logits.numpy(), ref.prefill_logits, RTOL)
    _assert_cache(cache, ref.prefill_cache)
    if ref.cfg.sliding_window:      # a ring, filled past its size
        assert ref.s_prompt > cache["attn"]["k"].shape[2]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Decode after prefill against the reference's steps; where prefill
    computes the forward's function (no capacity drops: not the moe
    family), also against the full forward at each position."""
    ref = reference(arch)
    params, cache = ref.port()
    toks = torch.from_numpy(ref.tokens)
    TM.prefill(params, ref.cfg,
               _text_slice(ref.batch, 0, ref.s_prompt, torch.from_numpy),
               cache)
    for i, want in enumerate(ref.decode_logits):
        t = ref.s_prompt + i
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       toks[:, t:t + 1])
        assert_rel_close(logits.numpy(), want, RTOL)
        if not ref.cfg.is_moe:
            # teacher-forced decode equals the full forward there
            assert_rel_close(logits[:, 0].numpy(),
                             ref.forward[:, ref.n_image + t], RTOL)
    _assert_cache(cache, ref.decode_cache)


@pytest.mark.parametrize("case", ["ring-wraps", "full-cache-clamps"])
def test_cache_edges_match_reference(case):
    """ring-wraps: a 16-slot ring (window_override=16) under a 24-token
    prompt; prefill keeps the last 16 positions at slots position % 16,
    and 10 decode steps wrap the ring (oldest slot first).
    full-cache-clamps: a full-attention cache of 20 slots filled by a
    20-token prompt; 2 more decode steps write at the last slot, as the
    reference's ``dynamic_update_slice`` clamps the index."""
    window, s_prompt, max_len, n_decode = {
        "ring-wraps": (16, 24, 64, 10),
        "full-cache-clamps": (None, 20, 20, 2)}[case]
    ref = reference("qwen3_4b", window_override=window, s_prompt=s_prompt,
                    max_len=max_len, n_decode=n_decode)
    params, cache = ref.port()
    toks = torch.from_numpy(ref.tokens)
    logits, cache = TM.prefill(params, ref.cfg,
                               {"tokens": toks[:, :s_prompt]}, cache)
    assert_rel_close(logits.numpy(), ref.prefill_logits, RTOL)
    _assert_cache(cache, ref.prefill_cache)
    for i, want in enumerate(ref.decode_logits):
        t = s_prompt + i
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       toks[:, t:t + 1],
                                       window_override=window)
        assert_rel_close(logits.numpy(), want, RTOL)
    _assert_cache(cache, ref.decode_cache)
    if case == "ring-wraps":
        assert cache["attn"]["k"].shape[2] == 16
        assert (sorted(cache["attn"]["kv_pos"][0].tolist())
                == list(range(18, 34)))
    else:
        assert cache["attn"]["kv_pos"][0, -1] == 21


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_stepwise_decode(arch):
    """The port's own consistency (counterpart of
    tests/test_prefill_decode.py): feeding the prompt one token at a time
    through decode_step gives prefill's last logits and its cache. As
    there, the moe family runs at a capacity factor that drops nothing
    (prefill's drops legitimately differ from dropless decode); a vlm
    prompt's image positions and first token go through prefill on the
    stepwise side too."""
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32", n_kv_heads=2,
                              moe_capacity_factor=100.0)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 12, 1).items()}
    toks = batch["tokens"]
    cache_a = TKV.serve_cache_init(cfg, B, 24, dtype=torch.float32,
                                   device="cpu")
    logits_a, cache_a = TM.prefill(params, cfg, batch, cache_a)
    cache_b = TKV.serve_cache_init(cfg, B, 24, dtype=torch.float32,
                                   device="cpu")
    first = 0
    if "image_embeds" in batch:
        first = 1
        TM.prefill(params, cfg, dict(batch, tokens=toks[:, :1]), cache_b)
    for i in range(first, 12):
        logits_b, cache_b = TM.decode_step(params, cfg, cache_b,
                                           toks[:, i:i + 1])
    assert_rel_close(logits_a.numpy(), logits_b.numpy(), RTOL)
    n = 12 + (cfg.n_image_tokens if "image_embeds" in batch else 0)
    assert cache_a["pos"] == cache_b["pos"] == n
    for n in ("k", "v", "kv_pos"):
        assert_rel_close(cache_a["attn"][n].float().numpy(),
                         cache_b["attn"][n].float().numpy(), RTOL)


def test_bf16_steps_match_reference():
    """The serving steps as a user calls them: bf16 weights and
    activations, the default bf16 cache made by ``make_prefill_step``,
    then ``make_serve_step``; against the reference's steps."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models import steps as JST
    jcfg, cfg = _cfgs("qwen3_4b", n_kv_heads=2)
    shape = TCB.InputShape("serve", MAX_LEN, B, "prefill")
    from repro.configs.base import InputShape
    jshape = InputShape("serve", MAX_LEN, B, "prefill")
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(_np_tree(tree), cfg, "cpu")
    toks = _tokens(cfg, S_PROMPT + 2)
    jt = jnp.asarray(toks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS_ATTN", "1")
        mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
        want, jcache = jax.jit(JST.make_prefill_step(jcfg, jshape))(
            tree, {"tokens": jt[:, :S_PROMPT]})
        want_steps = []
        serve = jax.jit(JST.make_serve_step(jcfg))
        for i in range(S_PROMPT, S_PROMPT + 2):
            lg, jcache = serve(tree, jcache, jt[:, i:i + 1])
            want_steps.append(np.asarray(lg))
    t = torch.from_numpy(toks)
    got, cache = TST.make_prefill_step(cfg, shape)(
        params, {"tokens": t[:, :S_PROMPT]})
    assert cache["attn"]["k"].dtype == torch.bfloat16
    assert_rel_close(got.numpy(), np.asarray(want), 5e-2)
    serve_t = TST.make_serve_step(cfg)
    for i, w in zip(range(S_PROMPT, S_PROMPT + 2), want_steps):
        got, cache = serve_t(params, cache, t[:, i:i + 1])
        assert_rel_close(got.numpy(), w, 5e-2)
    jc = _np_tree(jcache)
    assert cache["pos"] == int(jc["pos"])
    np.testing.assert_array_equal(cache["attn"]["kv_pos"].numpy(),
                                  jc["attn"]["kv_pos"])
    assert_rel_close(cache["attn"]["k"].float().numpy(),
                     np.asarray(jc["attn"]["k"], np.float32), 2 ** -7)
