"""The serving shapes of the port against the JAX reference: the four
input shapes, ``shape_supported``, ``long_context_window``, the input
specs on the meta device against the reference's ``eval_shape`` trees,
the window cache of long_500k, the ring that wraps, a prompt longer than
its cache, and RoPE at long_500k's last position.

The spec helpers are compared at full size for all 10 architectures and
4 shapes: nothing is allocated on either side. The decode comparisons
run the ``smoke_variant`` of Llama-3-8B in f32, the reference with its
Pallas kernels in interpret mode, the port through its kernels' plain
versions (CPU tensors), from the reference's ``init_params`` carried
with ``convert.llm_params_from_numpy`` and numpy-seeded tokens.

Tolerances, relative to the largest reference value
(``assert_rel_close``): port against reference 1e-4, as in
``test_torch_llm.py``; the ring against a full cache with the same window
mask 2e-4, the reference's own limit for that comparison
(``tests/test_long_context.py``). RoPE at position 524,287: the port's
inverse frequencies equal the reference's bitwise, so the angles are the
same f32 numbers, and the rotations differ only in cos / sin of angles up
to 5.2e5 rad; measured ≤ 1.3e-7 of the largest input, held to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from torch_helpers import assert_rel_close, llm_cfgs, np_tree
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

RTOL = 1e-4
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the reference's shapes and dtypes by name, against torch's
DTYPES = {"int32": torch.int32, "int8": torch.int8,
          "float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_shape(name):
    from repro.configs.base import INPUT_SHAPES
    return INPUT_SHAPES[name]


def _ref_leaves(tree):
    """{path: (shape, torch dtype)} of a reference ShapeDtypeStruct tree."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)
        out[key] = (tuple(leaf.shape), DTYPES[str(leaf.dtype)])
    return out


def _port_leaves(tree, prefix=()):
    """{path: (shape, dtype)} of the port's nested dict of meta tensors;
    a Python int leaf (``pos``) stands for a 0-dim int32 scalar."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, prefix + (k,)))
        elif isinstance(v, int):
            out[prefix + (k,)] = ((), torch.int32)
        else:
            assert v.device.type == "meta", (prefix + (k,), v.device)
            out[prefix + (k,)] = (tuple(v.shape), v.dtype)
    return out


def _named_leaves(named, cfg):
    """The port's ``named_parameters`` (or AdamW moments) in the
    reference's layout through ``convert``'s name map: a stacked path's
    leaf is (n_layers, *shape), checked row by row."""
    rows = {}
    for name, t in named.items():
        assert t.device.type == "meta", name
        path, layer = CV._tree_path(name)
        rows.setdefault(tuple(path), []).append((layer, tuple(t.shape),
                                                 t.dtype))
    out = {}
    for path, items in rows.items():
        (layer, shape, dtype), *_ = items
        assert all((s, d) == (shape, dtype) for _, s, d in items), path
        if layer is None:
            assert len(items) == 1, path
            out[path] = (shape, dtype)
        else:
            assert sorted(i for i, _, _ in items) == list(range(len(items)))
            out[path] = ((len(items),) + shape, dtype)
    return out


# ---------------------------------------------------------------------------
# shapes, shape_supported, long_context_window
# ---------------------------------------------------------------------------


def test_input_shapes_match_reference():
    from repro.configs.base import INPUT_SHAPES
    assert tuple(TCB.INPUT_SHAPES) == tuple(INPUT_SHAPES) == SHAPES
    for name, want in INPUT_SHAPES.items():
        got = TCB.INPUT_SHAPES[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.is_decode == want.is_decode
    assert (TCB.TRAIN_4K, TCB.PREFILL_32K, TCB.DECODE_32K,
            TCB.LONG_500K) == tuple(TCB.INPUT_SHAPES.values())


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_shape_supported_and_window_match_reference(arch):
    from repro.configs.base import get_config, shape_supported
    from repro.models import steps as JST
    jcfg, cfg = get_config(arch), TCB.get_config(arch)
    for name in SHAPES:
        js, ts = _jax_shape(name), TCB.INPUT_SHAPES[name]
        assert TCB.shape_supported(cfg, ts) == shape_supported(jcfg, js)
        assert (TST.long_context_window(cfg, ts)
                == JST.long_context_window(jcfg, js))
    assert TM.LONG_CONTEXT_WINDOW == 8192
    if arch == "whisper_medium":
        ok, note = TCB.shape_supported(cfg, TCB.LONG_500K)
        assert not ok and "enc-dec" in note


# ---------------------------------------------------------------------------
# the spec helpers against the reference's eval_shape trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_spec_helpers_match_reference(arch):
    """For every shape: params, AdamW state, batch, cache (with the
    long-context window where the reference applies one), the int8 cache
    of the dense, moe and vlm families, and the decode tokens, leaf by
    leaf in shape and dtype. The port's cache keeps ``pos`` as a Python
    int and, for the audio family, ``cross_pos`` (the slot positions L3
    reads the cross cache at), which the reference has not."""
    from repro.configs.base import get_config
    from repro.models import steps as JST
    jcfg, cfg = get_config(arch), TCB.get_config(arch)
    params = TST.params_specs(cfg)
    assert _named_leaves(dict(params.named_parameters()), cfg) == \
        _ref_leaves(JST.params_specs(jcfg))
    assert not any(p.requires_grad for p in params.parameters())
    opt = TST.opt_specs(cfg)
    jopt = JST.opt_specs(jcfg)
    assert opt.step == 0 and _ref_leaves(jopt.step) == {(): ((),
                                                            torch.int32)}
    for part, jpart in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        assert _named_leaves(part, cfg) == _ref_leaves(jpart)
    for name in SHAPES:
        js, ts = _jax_shape(name), TCB.INPUT_SHAPES[name]
        assert _port_leaves(TST.batch_specs(cfg, ts)) == \
            _ref_leaves(JST.batch_specs(jcfg, js))
        window = TST.long_context_window(cfg, ts)
        got = _port_leaves(TST.cache_specs(cfg, ts, window))
        if cfg.is_encdec:
            assert got.pop(("cross_pos",)) == (
                (cfg.n_audio_frames,), torch.int32)
        assert got == _ref_leaves(JST.cache_specs(jcfg, js, window))
        if cfg.family in TKV.QUANT_FAMILIES:
            assert _port_leaves(TST.cache_specs_quant(cfg, ts, window)) == \
                _ref_leaves(JST.cache_specs_quant(jcfg, js, window))
        else:
            with pytest.raises(NotImplementedError, match="int8"):
                TST.cache_specs_quant(cfg, ts, window)
        tok = TST.decode_token_specs(ts)
        assert (tuple(tok.shape), tok.dtype, tok.device.type) == (
            (ts.global_batch, 1), torch.int32, "meta")


def test_long_500k_caches():
    """At long_500k: 8,192 slots for the full-attention dense, moe and
    vlm models, mixtral's own 4,096-slot window, zamba2's ring capped at
    4,096, rwkv6's state as at decode_32k."""
    shape = TCB.LONG_500K
    for arch in ("qwen3_4b", "llama3_8b", "minitron_8b", "chatglm3_6b",
                 "granite_moe_1b_a400m", "internvl2_1b"):
        cfg = TCB.get_config(arch)
        c = TST.cache_specs(cfg, shape, TST.long_context_window(cfg, shape))
        assert c["attn"]["k"].shape[2] == 8192, arch
    mixtral = TCB.get_config("mixtral_8x7b")
    assert TST.long_context_window(mixtral, shape) is None
    assert TST.cache_specs(mixtral, shape)["attn"]["k"].shape[2] == 4096
    zamba = TCB.get_config("zamba2_7b")
    assert TST.cache_specs(zamba, shape)["attn"]["k"].shape[2] == 4096
    rwkv = TCB.get_config("rwkv6_7b")
    assert _port_leaves(TST.cache_specs(rwkv, shape)) == _port_leaves(
        TST.cache_specs(rwkv, dataclasses.replace(shape, seq_len=32_768)))


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_recurrent_state_constant_size(arch):
    """The reference's test on the port: the serving state does not grow
    with the context (the hybrid's shared-attention ring is capped at its
    4,096-slot window)."""
    cfg = TCB.get_config(arch).smoke_variant()
    c1 = _port_leaves(TKV.serve_cache_init(cfg, 2, 4096, device="meta"))
    c2 = _port_leaves(TKV.serve_cache_init(cfg, 2, 1 << 19, device="meta"))
    assert c1.keys() == c2.keys()
    for key, (shape, _) in c2.items():
        if "attn" in key:
            slot_dim = 2 if len(shape) > 2 else 1
            assert shape[slot_dim] <= 4096, (key, shape)
        else:
            assert c1[key][0] == shape, (key, c1[key], shape)


def test_dense_long_context_uses_window_cache():
    """The reference's test on the port: ``window_override`` bounds the
    dense cache."""
    cfg = TCB.get_config("llama3_8b").smoke_variant()
    c = TKV.serve_cache_init(cfg, 1, 1 << 19, window_override=64,
                             device="meta")
    assert c["attn"]["k"].shape[2] == 64


# ---------------------------------------------------------------------------
# ring wrap, a prompt longer than the cache, RoPE at 524,287
# ---------------------------------------------------------------------------

W, S = 16, 40


@pytest.fixture(scope="module")
def llama():
    """The reference's llama3-8b smoke model in f32 on both sides, and
    40 numpy-seeded tokens."""
    import jax
    from repro.models import model as JM
    jcfg, cfg = llm_cfgs("llama3_8b", dtype="float32")
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    return jcfg, cfg, tree, params, toks


def _port_decode(cfg, params, toks, max_len, window):
    cache = TKV.serve_cache_init(cfg, 1, max_len, dtype=torch.float32,
                                 window_override=window, device="cpu")
    t = torch.from_numpy(toks)
    out = []
    for i in range(toks.shape[1]):
        logits, cache = TM.decode_step(params, cfg, cache, t[:, i:i + 1],
                                       window_override=window)
        out.append(logits.numpy())
    return out, cache


def test_swa_ring_wraparound_matches_reference(one_torch_thread, llama):
    """The reference's ring test on the port: a ring of W = 16 slots
    decoded over S = 40 tokens (it wraps twice) against a full cache of
    S + 8 slots with the same window mask, within the reference's 2e-4;
    and the ring's logits at every step against the reference's ring."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models.kvcache import serve_cache_init
    jcfg, cfg, tree, params, toks = llama
    ring, ring_cache = _port_decode(cfg, params, toks, S, W)
    full, _ = _port_decode(cfg, params, toks, S + 8, W)
    assert ring_cache["attn"]["k"].shape[2] == W
    assert sorted(ring_cache["attn"]["kv_pos"][0].tolist()) == list(
        range(S - W, S))
    assert_rel_close(ring[-1], full[-1], 2e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
        step = jax.jit(lambda p, c, t: JM.decode_step(
            p, jcfg, c, t, window_override=W))
        cache = serve_cache_init(jcfg, 1, S, dtype=jnp.float32,
                                 window_override=W)
        for i in range(S):
            want, cache = step(tree, cache, jnp.asarray(toks[:, i:i + 1]))
            assert_rel_close(ring[i], np.asarray(want), RTOL)
    np.testing.assert_array_equal(ring_cache["attn"]["kv_pos"].numpy(),
                                  np.asarray(cache["attn"]["kv_pos"]))


def test_prefill_longer_than_cache_matches_reference(one_torch_thread,
                                                     llama):
    """A 32-token prompt into a 16-slot ring through ``make_prefill_step``
    with ``window_override`` = 16 (``_fill_ring``'s keep < S branch: the
    prompt attends with full causal attention, as the reference's
    prefill ignores the override; the last 16 positions stay at slots
    position % 16), then 8 decode steps with the window through
    ``make_serve_step``; against the reference's steps (their default
    bf16 cache on both sides, f32 weights and activations)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import InputShape
    from repro.models import steps as JST
    jcfg, cfg, tree, params, toks = llama
    prompt = 32
    jshape = InputShape("long", S, 1, "decode")
    shape = TCB.InputShape("long", S, 1, "decode")
    jt = jnp.asarray(toks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS_ATTN", "1")
        mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
        want, jcache = jax.jit(JST.make_prefill_step(jcfg, jshape, W))(
            tree, {"tokens": jt[:, :prompt]})
        want_steps = [np.asarray(want)]
        serve = jax.jit(JST.make_serve_step(jcfg, W))
        for i in range(prompt, S):
            lg, jcache = serve(tree, jcache, jt[:, i:i + 1])
            want_steps.append(np.asarray(lg))
    t = torch.from_numpy(toks)
    got, cache = TST.make_prefill_step(cfg, shape, W)(
        params, {"tokens": t[:, :prompt]})
    assert cache["attn"]["k"].shape[2] == W and prompt > W
    ring_pos = [0] * W
    for p in range(prompt - W, prompt):
        ring_pos[p % W] = p
    assert cache["attn"]["kv_pos"][0].tolist() == ring_pos
    got_steps = [got.numpy()]
    serve_t = TST.make_serve_step(cfg, W)
    for i in range(prompt, S):
        lg, cache = serve_t(params, cache, t[:, i:i + 1])
        got_steps.append(lg.numpy())
    for g, w in zip(got_steps, want_steps):
        assert_rel_close(g, w, RTOL)
    jc = np_tree(jcache)
    assert cache["pos"] == int(jc["pos"]) == S
    np.testing.assert_array_equal(cache["attn"]["kv_pos"].numpy(),
                                  jc["attn"]["kv_pos"])
    # the steps' cache is bf16 on both sides: one bf16 step of the value,
    # as in test_torch_llm.py
    for n in ("k", "v"):
        assert cache["attn"][n].dtype == torch.bfloat16
        assert_rel_close(cache["attn"][n].float().numpy(),
                         np.asarray(jc["attn"][n], np.float32), 2 ** -7)


@pytest.mark.parametrize("arch", ["qwen3_4b", "llama3_8b", "chatglm3_6b"])
def test_rope_at_long_500k_position(arch):
    """``CausalLM.rope`` at position 524,287 (long_500k's last) rotates
    as the reference's ``apply_rope`` does there: full width (Qwen3's
    theta 1e6, Llama's 5e5) and ChatGLM's half-rotated heads."""
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import layers as JL
    jcfg = get_config(arch)
    # the rotation depends on the head size, rope_partial and rope_theta
    # only: a model with no layers and a small vocabulary carries them
    cfg = dataclasses.replace(TCB.get_config(arch), n_layers=0,
                              vocab_size=256)
    hd = cfg.resolved_head_dim
    jf, rot = JL.rope_frequencies(hd, jcfg.rope_partial, jcfg.rope_theta)
    tf, trot = TL.rope_frequencies(hd, cfg.rope_partial, cfg.rope_theta)
    assert trot == rot
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pos = TCB.LONG_500K.seq_len - 1
    (cos, sin), rot_dim = params.rope(pos, 1)
    x = np.random.default_rng(2).normal(
        size=(2, 1, cfg.n_heads, hd)).astype(np.float32)
    got = TL.apply_rope(torch.from_numpy(x), cos, sin, rot_dim).numpy()
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.full((2, 1), pos),
                                    jf, rot))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()
    if cfg.rope_partial < 1:        # the unrotated half passes unchanged
        np.testing.assert_array_equal(got[..., rot:], x[..., rot:])
