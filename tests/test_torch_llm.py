"""The dense-LLM serving path of the port (configs, tokens, layers, KV
cache, model, steps, parameter conversion) against the JAX reference.

Parameters come from the reference's ``init_params`` and are carried
across with ``convert.llm_params_from_numpy``; tokens are numpy-seeded.
The models are the ``smoke_variant`` of Qwen3-4B (GQA, qk-norm, padded
vocabulary) and Llama-3-8B, in f32, with ``n_kv_heads=2`` so that GQA
groups are > 1 (the smoke variant alone gives group 1). The reference
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

ARCHS = ["qwen3_4b", "llama3_8b"]
B, S_PROMPT, MAX_LEN, N_DECODE = 2, 40, 48, 4
RTOL = 1e-4


def _tokens(cfg, seq, seed=0):
    return next(TTOK.synthetic_token_batches(cfg, B, seq, seed=seed,
                                             device="cpu"))["tokens"].numpy()


class _Reference:
    """One reference serve run per arch: params, forward, prefill through
    the Pallas flash kernel, decode steps through the Pallas decode
    kernel (both in interpret mode)."""

    def __init__(self, arch, window_override=None, s_prompt=S_PROMPT,
                 max_len=MAX_LEN, n_decode=N_DECODE):
        import jax
        import jax.numpy as jnp
        from repro.models import model as JM
        from repro.models.kvcache import serve_cache_init
        self.jcfg, self.cfg = _cfgs(arch, dtype="float32", n_kv_heads=2)
        jtree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree = _np_tree(jtree)
        self.tokens = _tokens(self.cfg, s_prompt + n_decode)
        self.s_prompt, self.max_len = s_prompt, max_len
        self.window_override = window_override
        toks = jnp.asarray(self.tokens)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS_ATTN", "1")
            mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
            self.forward = np.asarray(JM.forward(
                jtree, self.jcfg, {"tokens": toks}, remat=False)[0])
            cache = serve_cache_init(self.jcfg, B, max_len, dtype=jnp.float32,
                                     window_override=window_override)
            logits, cache = jax.jit(JM.prefill, static_argnums=(1,))(
                jtree, self.jcfg, {"tokens": toks[:, :s_prompt]}, cache)
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
    for arch in TCB.DENSE_IDS:
        jc, tc = get_config(arch), TCB.get_config(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert (dataclasses.asdict(tc.smoke_variant())
                == dataclasses.asdict(jc.smoke_variant()))
    assert TCB.get_config("qwen3-4b").padded_vocab_size == 152_064
    for arch in TCB.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TCB.get_config(arch)


def test_tokens_match_reference():
    from repro.configs.base import get_config
    from repro.data.tokens import synthetic_token_batches
    cfg = TCB.get_config("qwen3_4b")
    ref = synthetic_token_batches(get_config("qwen3_4b"), 3, 97, seed=5)
    port = TTOK.synthetic_token_batches(cfg, 3, 97, seed=5, device="cpu")
    for _ in range(2):
        want, got = next(ref)["tokens"], next(port)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
                              family="moe")
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError):
        TKV.serve_cache_init(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference (f32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref = reference(arch)
    params, _ = ref.port()
    logits, aux = TM.forward(params, ref.cfg,
                             {"tokens": torch.from_numpy(ref.tokens)})
    assert aux == {} and logits.dtype == torch.float32
    assert_rel_close(logits.numpy(), ref.forward, RTOL)
    # the padded vocabulary rows (151,936 -> 152,064 at full width)
    V = ref.cfg.vocab_size
    if ref.cfg.padded_vocab_size > V:
        assert float(logits[..., V:].max()) == -1e9


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    ref = reference(arch)
    params, cache = ref.port()
    toks = torch.from_numpy(ref.tokens[:, :S_PROMPT])
    logits, cache = TM.prefill(params, ref.cfg, {"tokens": toks}, cache)
    assert logits.shape == (B, 1, ref.cfg.padded_vocab_size)
    assert_rel_close(logits.numpy(), ref.prefill_logits, RTOL)
    _assert_cache(cache, ref.prefill_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    ref = reference(arch)
    params, cache = ref.port()
    toks = torch.from_numpy(ref.tokens)
    TM.prefill(params, ref.cfg, {"tokens": toks[:, :S_PROMPT]}, cache)
    for i, want in enumerate(ref.decode_logits):
        t = S_PROMPT + i
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       toks[:, t:t + 1])
        assert_rel_close(logits.numpy(), want, RTOL)
        # teacher-forced decode equals the full forward at that position
        assert_rel_close(logits[:, 0].numpy(), ref.forward[:, t], RTOL)
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
    through decode_step gives prefill's last logits and its cache."""
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32", n_kv_heads=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 12, seed=1))
    cache_a = TKV.serve_cache_init(cfg, B, 20, dtype=torch.float32,
                                   device="cpu")
    logits_a, cache_a = TM.prefill(params, cfg, {"tokens": toks}, cache_a)
    cache_b = TKV.serve_cache_init(cfg, B, 20, dtype=torch.float32,
                                   device="cpu")
    for i in range(12):
        logits_b, cache_b = TM.decode_step(params, cfg, cache_b,
                                           toks[:, i:i + 1])
    assert_rel_close(logits_a.numpy(), logits_b.numpy(), RTOL)
    assert cache_a["pos"] == cache_b["pos"] == 12
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
