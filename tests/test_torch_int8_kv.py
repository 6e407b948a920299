"""The int8 KV cache of the port against the JAX reference:
``quantize_kv``, the cache's layout, ``flash_attend`` (the plain chunked
attention that reads it), int8 decode, and the reference's int8 prefill
quirk.

The reference fills an int8 cache only through ``decode_step`` from the
empty cache (``tests/test_integration.py``): its ``prefill`` casts K/V
into the int8 cache without scales and drops ``k_scale`` / ``v_scale``,
so that its next ``decode_step`` raises ``KeyError``; the port's
``prefill`` refuses an int8 cache. The decode runs are the reference
test's setup: the ``smoke_variant`` in f32, a 64-slot cache, 10 tokens
(numpy-seeded), the reference's ``init_params`` carried with
``convert.llm_params_from_numpy``; also Qwen3 (qk-norm, GQA group 2) and
Granite-MoE (its decode's MoE layer).

Tolerances: int8 values equal; scales within 1e-7 relative for
``quantize_kv`` on the same f32 inputs (one f32 division each side) and
within 1e-6 after decode (the K/V they scale come from f32 products
summed in other orders: measured ≤ 1.5e-8, 1.2e-6 of the scale, after
Granite's MoE layer); logits 1e-4 relative to the largest reference value, as
in ``test_torch_llm.py``. The reference's own contract, int8 against the
f32 cache: max |Δ logit| < 0.15 and the same argmax.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_helpers import assert_rel_close, llm_cfgs, np_tree
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

RTOL = 1e-4
N_TOK, MAX_LEN = 10, 64


def _kv_inputs():
    """(B, 1, Hkv, hd) f32 K/V-like values: random rows, rows whose
    amax is 127 (scale exactly 1.0) holding exact .5 ties of both signs,
    all-zero rows (scale 1e-6 / 127), and rows far below 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 1, 4, 32)).astype(np.float32) * 2.0
    ties = rng.integers(-120, 120, size=32) + 0.5
    ties[0] = 127.0
    x[0, 0, 0] = ties
    x[1, 0, 1] = -ties
    x[2, 0, 2] = 0.0
    x[2, 0, 3] = rng.normal(size=32) * 1e-9
    return x


def test_quantize_kv_matches_reference():
    import jax.numpy as jnp
    from repro.models.kvcache import quantize_kv
    x = _kv_inputs()
    want_q, want_s = (np.asarray(a) for a in quantize_kv(jnp.asarray(x)))
    got_q, got_s = TKV.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-7, atol=0)
    # half to even: 2.5 -> 2, 3.5 -> 4 on both sides
    assert got_s[0, 0, 0] == 1.0
    np.testing.assert_array_equal(got_q[0, 0, 0].numpy(),
                                  np.round(x[0, 0, 0]).astype(np.int8))
    assert not got_q[2, 0, 2].any() and not got_q[2, 0, 3].any()
    # bf16 inputs are read as f32, as in the reference
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_q, _ = quantize_kv(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(TKV.quantize_kv(xb)[0].numpy(),
                                  np.asarray(want_q))


def test_int8_cache_layout_and_refusals():
    """The int8 cache beside the bf16 one; the families whose reference
    decode cannot read it refuse it."""
    cfg = TCB.get_config("qwen3_4b").smoke_variant()
    c = TKV.serve_cache_init(cfg, 2, 48, device="cpu", kv_quant=True)
    a = c["attn"]
    L, hd, Hkv = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    assert a["k"].shape == a["v"].shape == (L, 2, 48, Hkv, hd)
    assert a["k"].dtype == a["v"].dtype == torch.int8
    assert a["k_scale"].shape == a["v_scale"].shape == (L, 2, 48, Hkv)
    assert a["k_scale"].dtype == torch.float32
    assert a["kv_pos"].dtype == torch.int32 and int(a["kv_pos"].max()) == -1
    for arch in ("whisper_medium", "zamba2_7b", "rwkv6_7b"):
        with pytest.raises(NotImplementedError, match="int8"):
            TKV.serve_cache_init(TCB.get_config(arch).smoke_variant(), 1, 8,
                                 device="cpu", kv_quant=True)


@pytest.mark.parametrize("case", ["decode-ring", "prompt-causal"])
def test_flash_attend_matches_reference(case):
    """``flash_attend`` against the reference's ``_flash_attend`` on the
    same int8 values and scales: decode-ring, one query over a 2,500-slot
    ring (three 1,024-slot chunks, the last ragged) with empty slots,
    slots written after the query and a window, and a whole empty chunk,
    so that rows start with no valid key; prompt-causal, 40 queries over
    40 slots. On decode-ring also against L3's plain version
    (``decode_attention``, the route of the other caches) on the
    dequantized cache: the same masks."""
    import jax.numpy as jnp
    from repro.models.layers import _flash_attend
    from repro_torch.kernels.decode_attention.ops import decode_attention
    rng = np.random.default_rng(3)
    B, H, Hkv, hd = 2, 8, 2, 32
    if case == "decode-ring":
        S, Sq, q_pos, window = 2500, 1, 3100, 2000
        kv_pos = (np.arange(S) + 600).astype(np.int32)
        kv_pos[:1024] = -1                 # the first chunk is empty
        kv_pos[1500:1510] = q_pos + 5       # written after the query
    else:
        S, Sq, q_pos, window = 40, 40, 0, 0
        kv_pos = np.arange(S, dtype=np.int32)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    (k, ks), (v, vs) = (TKV.quantize_kv(torch.from_numpy(
        rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)))
        for _ in range(2))
    want = np.asarray(_flash_attend(
        *(jnp.asarray(a) for a in (q, k.numpy(), v.numpy())), causal=True,
        window=window, q_offset=q_pos, kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos >= 0), k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy())))
    tpos = torch.from_numpy(kv_pos)
    got = TL.flash_attend(torch.from_numpy(q), k, v, ks, vs, window=window,
                          q_offset=q_pos, kv_positions=tpos,
                          kv_valid=tpos >= 0)
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    assert_rel_close(got.numpy(), want, RTOL)
    if case == "decode-ring":
        l3 = decode_attention(torch.from_numpy(q[:, 0]),
                              k.float() * ks[..., None],
                              v.float() * vs[..., None], tpos, q_pos,
                              window=window)
        assert_rel_close(got[:, 0].numpy(), l3.numpy(), 1e-5)


class _Int8Decode:
    """The reference test's setup for one arch: params, tokens, and the
    reference's decode of N_TOK tokens from the empty int8 cache and from
    the f32 cache (its Pallas decode kernel in interpret mode reads the
    f32 one; the int8 one goes through its ``_flash_attend``)."""

    def __init__(self, arch, **kw):
        import jax
        import jax.numpy as jnp
        from repro.models import model as JM
        from repro.models.kvcache import serve_cache_init
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", **kw)
        tree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree = np_tree(tree)
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (1, N_TOK)).astype(np.int32)
        step = jax.jit(lambda p, c, t: JM.decode_step(p, self.jcfg, c, t))
        self.logits, self.caches = {}, {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS_DECODE_ATTN", "1")
            for quant in (True, False):
                cache = serve_cache_init(self.jcfg, 1, MAX_LEN,
                                         dtype=jnp.float32, kv_quant=quant)
                out = []
                for i in range(N_TOK):
                    lg, cache = step(tree, cache,
                                     jnp.asarray(self.tokens[:, i:i + 1]))
                    out.append(np.asarray(lg))
                self.logits[quant], self.caches[quant] = out, np_tree(cache)

    def port(self, quant):
        params = CV.llm_params_from_numpy(self.tree, self.cfg, "cpu")
        cache = TKV.serve_cache_init(self.cfg, 1, MAX_LEN,
                                     dtype=torch.float32, device="cpu",
                                     kv_quant=quant)
        t = torch.from_numpy(self.tokens)
        out = []
        for i in range(N_TOK):
            lg, cache = TM.decode_step(params, self.cfg, cache, t[:, i:i + 1])
            out.append(lg.numpy())
        return out, cache


@pytest.mark.parametrize("arch,kw", [
    ("llama3_8b", {}), ("qwen3_4b", {"n_kv_heads": 2}),
    ("granite_moe_1b_a400m", {})])
def test_int8_decode_matches_reference(one_torch_thread, arch, kw):
    ref = _Int8Decode(arch, **kw)
    got, cache = ref.port(True)
    for g, w in zip(got, ref.logits[True]):
        assert_rel_close(g, w, RTOL)
    want = ref.caches[True]
    assert cache["pos"] == int(want["pos"]) == N_TOK
    a, wa = cache["attn"], want["attn"]
    assert set(a) == set(wa)
    np.testing.assert_array_equal(a["kv_pos"].numpy(), wa["kv_pos"])
    for n in ("k", "v"):
        assert a[n].dtype == torch.int8
        np.testing.assert_array_equal(a[n].numpy(), wa[n])
        np.testing.assert_allclose(a[n + "_scale"].numpy(),
                                   wa[n + "_scale"], rtol=0, atol=1e-6)
    assert int((a["k"] != 0).sum()) > 0.9 * N_TOK * a["k"][0, 0, 0].numel() \
        * a["k"].shape[0]
    # the reference's contract, on the port: int8 against the f32 cache
    full, _ = ref.port(False)
    for g, w in zip(full, ref.logits[False]):
        assert_rel_close(g, w, RTOL)
    gap = np.abs(full[-1] - got[-1]).max()
    assert gap < 0.15, gap
    assert full[-1].argmax() == got[-1].argmax()


def test_int8_prefill_quirk_is_pinned():
    """The reference: prefill into an int8 cache truncates K/V (cast
    without scales) and returns no scales, and the next decode_step raises
    KeyError. The port: prefill into an int8 cache raises
    NotImplementedError naming that behaviour; a bf16 cache prefills."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models.kvcache import serve_cache_init
    jcfg, cfg = llm_cfgs("llama3_8b", dtype="float32")
    tree = JM.init_params(jax.random.key(0), jcfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, N_TOK)).astype(np.int32)
    cache = serve_cache_init(jcfg, 1, MAX_LEN, dtype=jnp.float32,
                             kv_quant=True)
    _, cache = JM.prefill(tree, jcfg, {"tokens": jnp.asarray(toks)}, cache)
    assert cache["attn"]["k"].dtype == jnp.int8
    assert "k_scale" not in cache["attn"]
    with pytest.raises(KeyError, match="k_scale"):
        JM.decode_step(tree, jcfg, cache, jnp.asarray(toks[:, :1]))
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    tcache = TKV.serve_cache_init(cfg, 1, MAX_LEN, device="cpu",
                                  kv_quant=True)
    batch = {"tokens": torch.from_numpy(toks)}
    with pytest.raises(NotImplementedError, match="without scales"):
        TM.prefill(params, cfg, batch, tcache)
    _, fcache = TM.prefill(params, cfg, batch, TKV.serve_cache_init(
        cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu"))
    assert fcache["pos"] == N_TOK
