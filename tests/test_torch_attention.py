"""Kernels L1 (flash attention, forward, with its logsumexp), L2 (its
backward) and L3 (decode attention): the port against the JAX reference.

On the CPU each wrapper runs its plain version; it is held against the
reference's wrapper, which runs its Pallas kernel in interpret mode, and
against the reference's jnp oracle, on the same numpy inputs. The
``cuda`` legs hold each CUDA kernel against the plain version on the card,
over the same cases, and check that the wrappers allocate only their
outputs (L3: and its split-S partials), with no padded copy of q/k/v or
of the cache. L1 and L2 have two CUDA variants each: bf16 calls go to the
Hopper tensor-core kernels (``*_sm90.cu``), f32 calls to the f32 kernels;
the ``sm90`` legs cover every head size of the bf16 kernels and check
which variant ran.

L2 sits behind the autograd Function ``flash_attention_trainable``; its
gradients are held against ``jax.grad`` through the reference's
``flash_attention_trainable`` (the two Pallas backward kernels in
interpret mode) at 2e-4, the tolerance of the reference's own
``tests/test_flash_attention.py``: both sides sum the same f32 products in
other orders (the reference's tiles, the plain version's whole rows).

Tolerances, relative to the largest reference value (``assert_rel_close``):
- f32: 1e-5. Both sides compute the same f32 scores and softmax; the
  Pallas kernel and the CUDA kernel sum online over tiles, the plain
  versions over the whole row, so only the summation order differs.
- bf16 inputs: both sides widen the same bf16 values to f32 and compute in
  f32; the port writes its result in bf16 (the reference's f32 result cast
  to the input dtype), so the port may sit one bf16 rounding (2^-8
  relative) from the reference: 4e-3. On the card, kernel and plain
  version each round an f32 value that differs only in summation order, so
  they may land one bf16 step apart: the same 4e-3.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA
from torch_helpers import assert_rel_close, cuda_device  # noqa: F401

RTOL = {"f32": 1e-5, "bf16": 4e-3}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

# (id, B, S, H, Hkv, hd, causal, window, dtype). Sq == Skv as in prefill;
# the non-causal case is tile-aligned (the reference's wrapper pads k/v
# without masking them when not causal).
FLASH_CASES = [
    ("causal-300-gqa2-f32", 1, 300, 4, 2, 32, True, 0, "f32"),
    ("causal-300-gqa2-bf16", 1, 300, 4, 2, 64, True, 0, "bf16"),
    ("window-700-gqa4-f32", 1, 700, 4, 1, 32, True, 128, "f32"),
    ("window-700-gqa4-bf16", 1, 700, 4, 1, 128, True, 128, "bf16"),
    ("noncausal-512-f32", 2, 512, 2, 2, 32, False, 0, "f32"),
    # zamba2's shared attention block: MHA at hd = 112
    ("causal-300-mha-hd112-bf16", 1, 300, 4, 4, 112, True, 0, "bf16"),
]

# (id, B, S, H, Hkv, hd, layout, window, q dtype, cache dtype)
#   full: slots 0..S-1 hold positions 0..S-1, the query is at S-1
#   empty: the first 60% of the slots are filled, the rest are -1
#   ring: a ring of S slots after wrap-around (position p at slot p % S),
#         with two slots still empty; with a window, part of it is masked
DECODE_CASES = [
    ("full-300-gqa2-f32", 2, 300, 4, 2, 32, "full", 0, "f32", "f32"),
    ("empty-700-gqa4-bf16", 2, 700, 8, 2, 64, "empty", 0, "bf16", "bf16"),
    ("ring-300-window-f32", 1, 300, 4, 1, 32, "ring", 150, "f32", "f32"),
    ("ring-700-window-bf16", 2, 700, 4, 2, 128, "ring", 500, "bf16", "bf16"),
    ("ring-300-f32-query-bf16-cache", 2, 300, 4, 2, 32, "ring", 0, "f32",
     "bf16"),
    ("ring-300-mha-hd112-f32", 2, 300, 4, 4, 112, "ring", 0, "f32", "f32"),
]


def _as(x, dt):
    return torch.from_numpy(x).to(TORCH_DT[dt])


def flash_inputs(case, seed=0):
    _, B, S, H, Hkv, hd, _, _, dt = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    # bf16 cases: round once, so both packages see the same values
    return tuple(_as(x, dt) for x in (q, k, v))


def decode_inputs(case, seed=0):
    _, B, S, H, Hkv, hd, layout, _, qdt, kvdt = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    if layout == "full":
        kv_pos, q_pos = np.arange(S), S - 1
    elif layout == "empty":
        n = int(0.6 * S)
        kv_pos = np.where(np.arange(S) < n, np.arange(S), -1)
        q_pos = n - 1
    else:
        q_pos = 3 * S + 17
        p = np.arange(q_pos - S + 1, q_pos + 1)
        kv_pos = np.empty(S, np.int64)
        kv_pos[p % S] = p
        kv_pos[[(q_pos - 5) % S, (q_pos - S + 3) % S]] = -1
    return (_as(q, qdt), _as(k, kvdt), _as(v, kvdt),
            torch.from_numpy(kv_pos.astype(np.int32)), int(q_pos))


def _np32(t):
    return t.float().numpy()


def _jnp(t):
    import jax.numpy as jnp
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_reference(case):
    from repro.kernels.flash_attention import ops as JFA
    from repro.kernels.flash_attention.ref import flash_attention_ref
    causal, window, dt = case[6], case[7], case[8]
    q, k, v = flash_inputs(case)
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    jq, jk, jv = _jnp(q), _jnp(k), _jnp(v)
    pallas = np.asarray(JFA.flash_attention(jq, jk, jv, causal=causal,
                                            window=window))
    oracle = np.asarray(flash_attention_ref(jq, jk, jv, causal=causal,
                                            window=window))
    assert_rel_close(_np32(out), pallas, RTOL[dt])
    assert_rel_close(_np32(out), oracle, RTOL[dt])


def test_flash_plain_ragged_noncausal_and_empty_rows():
    """Cases the reference's Pallas wrapper cannot take (it pads k/v
    without masking them when not causal), against its jnp oracle: a
    ragged non-causal call with Sq != Skv, and a window of 1 (each row
    sees only itself)."""
    from repro.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 37, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 53, 2, 32)).astype(np.float32)
            for _ in range(2))
    for causal, window in ((False, 0), (True, 1), (False, 20)):
        out = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window)
        want = np.asarray(flash_attention_ref(q, k, v, causal=causal,
                                              window=window))
        assert_rel_close(out.numpy(), want, RTOL["f32"])


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_plain_matches_reference(case):
    from repro.kernels.decode_attention import ops as JDA
    from repro.kernels.decode_attention.ref import decode_attention_ref
    window, qdt = case[7], case[8]
    q, k, v, kv_pos, q_pos = decode_inputs(case)
    out = DA.decode_attention(q, k, v, kv_pos, q_pos, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    jargs = (_jnp(q), _jnp(k), _jnp(v), _jnp(kv_pos))
    pallas = np.asarray(JDA.decode_attention(*jargs, q_pos, window=window))
    oracle = np.asarray(decode_attention_ref(*jargs, q_pos, window))
    assert_rel_close(_np32(out), pallas, RTOL[qdt])
    assert_rel_close(_np32(out), oracle, RTOL[qdt])


def test_decode_plain_no_valid_slot_gives_zeros():
    case = ("x", 1, 40, 4, 2, 32, "full", 0, "f32", "f32")
    q, k, v, kv_pos, _ = decode_inputs(case)
    out = DA.decode_attention(q, k, v, torch.full_like(kv_pos, -1), 39)
    assert float(out.abs().max()) == 0.0


def test_wrappers_reject_bad_operands():
    q, k, v = flash_inputs(FLASH_CASES[0])
    with pytest.raises(ValueError):
        FA.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                           v[:, :, :1].repeat(1, 1, 3, 1))   # 4 % 3 != 0
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.to(torch.bfloat16), v)
    dq, dk, dv, kv_pos, q_pos = decode_inputs(DECODE_CASES[0])
    with pytest.raises(ValueError):
        DA.decode_attention(dq, dk, dv, kv_pos[:-1], q_pos)


# ---------------------------------------------------------------------------
# L1's lse and L2 through the autograd Function, on the CPU
# ---------------------------------------------------------------------------

# (id, Hkv, causal, window): B = 1, S = 512 (the reference's Pallas
# forward with lse takes only tile-aligned shapes), H = 4, hd = 32, f32
LSE_CASES = [("causal-gqa2", 2, True, 0), ("window128-gqa4", 1, True, 128),
             ("noncausal-gqa1", 4, False, 0)]


@pytest.mark.parametrize("case", LSE_CASES, ids=[c[0] for c in LSE_CASES])
def test_flash_lse_matches_reference(case):
    """lse from the port's ``flash_attention(..., return_lse=True)``
    against the reference's ``flash_attention_padded(..., return_lse=True)``
    (interpret mode): both form the same f32 scores, so only summation
    order differs: 1e-5 of the largest |lse|."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_padded
    _, Hkv, causal, window = case
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 512, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, 512, Hkv, 32)).astype(np.float32)
            for _ in range(2))
    o, lse = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 512, 4)
    jo, jlse = flash_attention_padded(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, interpret=True,
                                      return_lse=True)
    assert_rel_close(lse.numpy(), np.asarray(jlse), RTOL["f32"])
    assert_rel_close(o.numpy(), np.asarray(jo), RTOL["f32"])


def _grads_port(q, k, v, tgt, causal, window, attend):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = attend(qt, kt, vt, causal, window)
    ((o.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("Hkv,window", [(2, 0), (4, 256), (1, 0)])
def test_flash_grads_match_reference(Hkv, window):
    """The cases of the reference's
    ``test_flash_attention_vjp_matches_ref_grad``: dq, dk, dv of
    sum((o - tgt)^2) through the port's autograd Function (plain L1 with
    lse, plain L2) against ``jax.grad`` through the reference's
    ``flash_attention_trainable`` (Pallas forward and backward kernels,
    interpret mode), at the reference test's 2e-4."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as JFA
    rng = np.random.default_rng(7)
    B, S, H, hd = 1, 512, 4, 64
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    tgt = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def loss(q, k, v):
        o = JFA.flash_attention_trainable(q, k, v, True, window)
        return jnp.sum((o - tgt) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    got = _grads_port(q, k, v, tgt, True, window,
                      FA.flash_attention_trainable)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


def _plain_attend(q, k, v, causal, window):
    return FA.flash_attention_ref(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (300, 300, True, 0), (300, 300, True, 64), (77, 130, False, 0),
    (130, 77, False, 40)])
def test_flash_grads_ragged_match_plain_autograd(Sq, Skv, causal, window):
    """Shapes the reference's trainable variant does not take (ragged,
    Sq != Skv): the autograd Function (``flash_bwd_ref`` from o and lse)
    against autograd through ``flash_attention_ref`` itself, GQA group 2,
    f32: 2e-4 as above."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, Sq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, Skv, 2, 32)).astype(np.float32)
            for _ in range(2))
    tgt = rng.normal(size=q.shape).astype(np.float32)
    got = _grads_port(q, k, v, tgt, causal, window,
                      FA.flash_attention_trainable)
    want = _grads_port(q, k, v, tgt, causal, window, _plain_attend)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


def test_flash_bwd_rejects_bad_operands():
    q, k, v = flash_inputs(FLASH_CASES[0])
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        FA.flash_bwd(q, k, v, o, o[:, :-1], lse)
    with pytest.raises(ValueError):
        FA.flash_bwd(q, k, v, o, o, lse.double())
    with pytest.raises(TypeError):
        FA.flash_bwd(q, k, v, o, o.to(torch.bfloat16), lse)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _alloc_peak(fn):
    """Bytes allocated above the starting point while ``fn`` runs."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _rounded(n):
    """The caching allocator's block size for a request of n bytes."""
    return (n + 511) // 512 * 512


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_cuda_flash_kernel_matches_plain(case, cuda_device):
    causal, window, dt = case[6], case[7], case[8]
    q, k, v = (t.to(cuda_device) for t in flash_inputs(case))
    n0 = FA.flash_attention.launches
    out, peak = _alloc_peak(
        lambda: FA.flash_attention(q, k, v, causal=causal, window=window))
    assert FA.flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert peak <= _rounded(out.numel() * out.element_size())
    want = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert_rel_close(out.float().cpu().numpy(),
                     want.to(q.dtype).float().cpu().numpy(), RTOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (1000, 1000, True, 0), (77, 1000, False, 0), (1000, 77, False, 300),
    (129, 129, True, 64), (1, 1, True, 0)])
def test_cuda_flash_kernel_ragged_shapes(Sq, Skv, causal, window,
                                         cuda_device):
    """Ragged edges on both axes, Sq != Skv, tiles that straddle the
    diagonal and the window edge, and a single row, at hd = 128."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((2, Sq, 8, 128), generator=g, device=cuda_device)
    k, v = (torch.randn((2, Skv, 2, 128), generator=g, device=cuda_device)
            for _ in range(2))
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert_rel_close(out.cpu().numpy(), want.cpu().numpy(), RTOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_cuda_decode_kernel_matches_plain(case, cuda_device):
    window, qdt = case[7], case[8]
    q, k, v, kv_pos, q_pos = decode_inputs(case)
    q, k, v, kv_pos = (t.to(cuda_device) for t in (q, k, v, kv_pos))
    n0 = DA.decode_attention.launches
    out = DA.decode_attention(q, k, v, kv_pos, q_pos, window=window)
    assert DA.decode_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    want = DA.decode_attention_ref(q, k, v, kv_pos, q_pos, window)
    assert_rel_close(out.float().cpu().numpy(),
                     want.to(q.dtype).float().cpu().numpy(), RTOL[qdt])


@pytest.mark.cuda
def test_cuda_decode_allocates_only_output_and_partials(cuda_device):
    """A ragged 4,113-slot bf16 cache (8.4 MB per K or V): the call may
    allocate its (B, H, hd) output and the split-S partials, nothing
    like a padded copy of the cache."""
    B, S, H, Hkv, hd = 2, 4113, 16, 4, 128
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((B, H, hd), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, hd), generator=g, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    out, peak = _alloc_peak(
        lambda: DA.decode_attention(q, k, v, kv_pos, S - 1))
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    nc, _ = DA.split_plan(B, Hkv, S, hd, n_sm)
    allowed = (_rounded(B * H * hd * 2) + _rounded(4 * B * H * nc * hd)
               + _rounded(4 * B * H * nc * 2))
    assert peak <= allowed, (peak, allowed)
    want = DA.decode_attention_ref(q, k, v, kv_pos, S - 1)
    assert_rel_close(out.float().cpu().numpy(),
                     want.to(q.dtype).float().cpu().numpy(), RTOL["bf16"])


# L3 at its split and tile boundaries: (id, B, S, H, Hkv, hd, layout,
# window, q dtype, cache dtype). S one slot short of, at and past a 32-slot
# tile and a split (split_plan's chunk at this shape and SM count), a
# single slot, every head size and query/cache dtype pair, groups 1, 2, 4,
# 6 and 16 (ChatGLM3's MQA-like 32/2), and windows that leave most splits
# without a valid slot
DECODE_EDGE_CASES = [
    ("s31-gqa4-hd128-bf16", 2, 31, 8, 2, 128, "full", 0, "bf16", "bf16"),
    ("s32-mha-hd112-bf16", 2, 32, 4, 4, 112, "full", 0, "bf16", "bf16"),
    ("s33-gqa2-hd64-f32", 1, 33, 4, 2, 64, "ring", 0, "f32", "f32"),
    ("s1-gqa4-hd32-bf16-f32", 3, 1, 4, 1, 32, "full", 0, "bf16", "f32"),
    ("s4095-g16-hd128-bf16", 1, 4095, 32, 2, 128, "full", 0, "bf16", "bf16"),
    ("s4097-g6-hd64-f32-bf16", 1, 4097, 12, 2, 64, "empty", 0, "f32",
     "bf16"),
    ("s4096-mha-hd112-window100-bf16", 2, 4096, 4, 4, 112, "ring", 100,
     "bf16", "bf16"),
    ("s2049-g16-hd32-window40-f32", 1, 2049, 16, 1, 32, "ring", 40, "f32",
     "f32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_EDGE_CASES,
                         ids=[c[0] for c in DECODE_EDGE_CASES])
def test_cuda_decode_kernel_split_boundaries(case, cuda_device):
    window, qdt = case[7], case[8]
    q, k, v, kv_pos, q_pos = decode_inputs(case, seed=3)
    q, k, v, kv_pos = (t.to(cuda_device) for t in (q, k, v, kv_pos))
    n0 = DA.decode_attention.launches
    out = DA.decode_attention(q, k, v, kv_pos, q_pos, window=window)
    assert DA.decode_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    want = DA.decode_attention_ref(q, k, v, kv_pos, q_pos, window)
    assert_rel_close(out.float().cpu().numpy(),
                     want.to(q.dtype).float().cpu().numpy(), RTOL[qdt])


# (Sq, Skv, H, Hkv, causal, window): GQA groups 1, 2 and 4, ragged edges on
# both axes, tiles that straddle the diagonal and the window edge
BWD_SHAPES = [(300, 300, 4, 4, True, 0), (1000, 1000, 8, 4, True, 128),
              (77, 130, 8, 2, False, 0), (130, 77, 4, 1, False, 40),
              (129, 129, 8, 2, True, 64), (1, 1, 4, 1, True, 0)]
# L2 kernel vs plain version, relative to the largest plain value. fp32:
# both sum the same f32 products in other orders, over up to Skv terms
# per element, and ds = p (dp - D) cancels (each row of ds sums to 0), so
# the error is relative to the terms, not to the result: 1e-4. bf16: both
# round f32 values that differ only in summation order, so they may land
# one bf16 step (2^-8) apart: 4e-3.
BWD_RTOL = {"f32": 1e-4, "bf16": 4e-3}


def _bwd_inputs(shape, dt, device, seed=5, hd=128):
    Sq, Skv, H, Hkv, causal, window = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((2, Sq, H, hd), generator=g, device=device)
             .to(TORCH_DT[dt]) for _ in range(2))
    k, v = (torch.randn((2, Skv, Hkv, hd), generator=g, device=device)
            .to(TORCH_DT[dt]) for _ in range(2))
    o, lse = FA.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    return q, k, v, o.to(q.dtype).contiguous(), do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_cuda_flash_bwd_kernel_matches_plain(shape, dt, cuda_device):
    causal, window = shape[4], shape[5]
    q, k, v, o, do, lse = _bwd_inputs(shape, dt, cuda_device)
    n0 = FA.flash_bwd.launches
    got = FA.flash_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_bwd.launches == n0 + 1
    want = FA.flash_bwd_ref(q, k, v, o, do, lse, causal=causal,
                            window=window)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == q.dtype, name
        assert_rel_close(a.float().cpu().numpy(),
                         b.to(q.dtype).float().cpu().numpy(), BWD_RTOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", BWD_SHAPES[:4], ids=str)
def test_cuda_flash_bwd_hd112_matches_plain(shape, dt, cuda_device):
    """L2 at zamba2's head size, 112: the f32 kernel's own instantiation
    (14 accumulator columns per thread) and the sm90 kernel's 128-column
    tiles with 16 columns zero-filled."""
    causal, window = shape[4], shape[5]
    q, k, v, o, do, lse = _bwd_inputs(shape, dt, cuda_device, hd=112)
    n0 = FA.flash_bwd.launches
    got = FA.flash_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_bwd.launches == n0 + 1
    want = FA.flash_bwd_ref(q, k, v, o, do, lse, causal=causal,
                            window=window)
    for a, b in zip(got, want):
        assert a.dtype == q.dtype and a.shape == b.shape
        assert_rel_close(a.float().cpu().numpy(),
                         b.to(q.dtype).float().cpu().numpy(), BWD_RTOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES[:4], ids=str)
def test_cuda_flash_lse_matches_plain(shape, cuda_device):
    """L1's lse (f32 inputs): the same scores, another summation order."""
    causal, window = shape[4], shape[5]
    q, k, v, _, _, lse = _bwd_inputs(shape, "f32", cuda_device)
    o, got = FA.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    assert got.shape == lse.shape and got.dtype == torch.float32
    assert_rel_close(got.cpu().numpy(), lse.cpu().numpy(), RTOL["f32"])


@pytest.mark.cuda
def test_cuda_flash_bwd_allocates_only_its_outputs(cuda_device):
    """A ragged 4,113-token bf16 call at GQA group 4: the call may allocate
    dq, dk, dv and the (B, Sq, H) f32 D; no repeated K/V and no
    (B, Skv, H, hd) per-q-head temporaries (each would be 4x dk)."""
    shape = (4113, 4113, 16, 4, True, 0)
    q, k, v, o, do, lse = (t.contiguous() for t in
                           _bwd_inputs(shape, "bf16", "cpu"))
    q, k, v, o, do, lse = (t.to(cuda_device) for t in (q, k, v, o, do, lse))
    (dq, dk, dv), peak = _alloc_peak(
        lambda: FA.flash_bwd(q, k, v, o, do, lse))
    allowed = (_rounded(q.numel() * 2) + 2 * _rounded(k.numel() * 2)
               + _rounded(lse.numel() * 4))
    assert peak <= allowed, (peak, allowed)
    assert bool(torch.isfinite(dq).all() & torch.isfinite(dk).all()
                & torch.isfinite(dv).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_autograd_function_matches_plain_autograd(dt, cuda_device):
    """L1 forward + L2 backward through ``flash_attention_trainable``
    against autograd through ``flash_attention_ref``, at a ragged GQA-2
    shape, with do = tgt on both sides; the kernels' own tolerances (the
    plain forward's softmax differs from the kernels' lse route only in
    rounding)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn((2, 300, h, 128), generator=g, device=cuda_device)
               .to(TORCH_DT[dt]) for h in (8, 4, 4))
    tgt = torch.randn((2, 300, 8, 128), generator=g, device=cuda_device)
    n1, n2 = FA.flash_attention.launches, FA.flash_bwd.launches

    def grads(attend):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        (attend(qs, ks, vs, True, 64).float() * tgt).sum().backward()
        return [t.grad.float().cpu().numpy() for t in (qs, ks, vs)]

    got = grads(FA.flash_attention_trainable)
    assert (FA.flash_attention.launches, FA.flash_bwd.launches) == (n1 + 1,
                                                                    n2 + 1)
    want = grads(lambda *a: _plain_attend(*a).to(q.dtype))
    for a, b in zip(got, want):
        assert_rel_close(a, b, BWD_RTOL[dt])


# ---------------------------------------------------------------------------
# On the card: the bf16 tensor-core kernels (sm90) at every head size
# ---------------------------------------------------------------------------

# (Sq, Skv, H, Hkv, hd, causal, window): every head size L1 takes, GQA
# groups 1, 2 and 4, ragged edges off the kernels' 64- and 128-row tiles
# (300, 700, 4,033), window edges inside a tile, and rows that see no key
# (non-causal, window 50, Skv 300: rows >= 349)
SM90_FWD_SHAPES = [(300, 300, 4, 4, 32, True, 0),
                   (700, 700, 8, 4, 64, True, 100),
                   (4033, 4033, 8, 2, 128, True, 0),
                   (300, 700, 4, 1, 112, False, 0),
                   (700, 300, 8, 2, 128, False, 50),
                   (300, 300, 4, 1, 112, True, 37)]
# every head size L2 takes, 112 (zamba2's MHA shared block) among them
SM90_BWD_SHAPES = [(300, 300, 4, 4, 32, True, 0),
                   (700, 700, 8, 4, 64, True, 100),
                   (4033, 4033, 8, 2, 128, True, 0),
                   (700, 300, 8, 2, 128, False, 50),
                   (300, 700, 4, 1, 64, True, 200),
                   (4033, 4033, 4, 4, 112, True, 0),
                   (300, 700, 4, 2, 112, False, 50)]


def _sm90_inputs(shape, device, n_q=1, seed=8):
    """bf16 q[, do] (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd); B = 1 at
    4,033 tokens (the plain version's f32 score tiles), else 2."""
    Sq, Skv, H, Hkv, hd = shape[:5]
    B = 1 if max(Sq, Skv) > 1000 else 2
    g = torch.Generator(device=device).manual_seed(seed)
    qs = [torch.randn((B, Sq, H, hd), generator=g, device=device)
          .to(torch.bfloat16) for _ in range(n_q)]
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=g, device=device)
            .to(torch.bfloat16) for _ in range(2))
    return qs, k, v


def _counts(fn):
    """(sm90 launches, f32-kernel launches) of a wrapper."""
    return fn.sm90_launches, fn.launches - fn.sm90_launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_FWD_SHAPES, ids=str)
def test_cuda_sm90_flash_matches_plain(shape, cuda_device):
    """bf16 L1 goes to the sm90 kernel, allocates only o and lse, and
    agrees with the plain version: o at RTOL["bf16"], lse at RTOL["f32"]
    (the same f32 scores of the same bf16 inputs, another order)."""
    Sq, Skv, H, Hkv, hd, causal, window = shape
    (q,), k, v = _sm90_inputs(shape, cuda_device)
    sm90, f32 = _counts(FA.flash_attention)
    (o, lse), peak = _alloc_peak(lambda: FA.flash_attention(
        q, k, v, causal=causal, window=window, return_lse=True))
    assert _counts(FA.flash_attention) == (sm90 + 1, f32)
    assert o.dtype == torch.bfloat16 and lse.shape == q.shape[:3]
    assert peak <= _rounded(o.numel() * 2) + _rounded(lse.numel() * 4)
    want, lse_want = FA.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, return_lse=True)
    assert_rel_close(o.float().cpu().numpy(),
                     want.to(q.dtype).float().cpu().numpy(), RTOL["bf16"])
    assert_rel_close(lse.cpu().numpy(), lse_want.cpu().numpy(), RTOL["f32"])
    if not causal and window and Sq > Skv + window:
        blind = Skv + window - 1          # the first row that sees no key
        assert float(o[:, blind:].float().abs().max()) == 0.0
        assert torch.allclose(lse[:, blind:],
                              torch.full_like(lse[:, blind:],
                                          math.log(1e-30)))


@pytest.mark.cuda
def test_cuda_sm90_flash_allocates_only_its_output(cuda_device):
    """The serve path's call (bf16, no lse) at a ragged 4,113 tokens, GQA
    group 4: the call allocates its (B, Sq, H, hd) output and nothing
    like a padded copy of q, k or v."""
    (q,), k, v = _sm90_inputs((4113, 4113, 16, 4, 128), cuda_device)
    sm90, f32 = _counts(FA.flash_attention)
    o, peak = _alloc_peak(lambda: FA.flash_attention(q, k, v))
    assert _counts(FA.flash_attention) == (sm90 + 1, f32)
    assert peak <= _rounded(o.numel() * 2), peak
    assert bool(torch.isfinite(o).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_BWD_SHAPES, ids=str)
def test_cuda_sm90_flash_bwd_matches_plain(shape, cuda_device):
    """bf16 L2 goes to the sm90 kernels and agrees with the plain version
    on the same (o, lse) at BWD_RTOL["bf16"]."""
    Sq, Skv, H, Hkv, hd, causal, window = shape
    (q, do), k, v = _sm90_inputs(shape, cuda_device, n_q=2)
    o, lse = FA.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    o = o.to(q.dtype).contiguous()
    sm90, f32 = _counts(FA.flash_bwd)
    got = FA.flash_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _counts(FA.flash_bwd) == (sm90 + 1, f32)
    want = FA.flash_bwd_ref(q, k, v, o, do, lse, causal=causal,
                            window=window)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        assert_rel_close(a.float().cpu().numpy(),
                         b.to(q.dtype).float().cpu().numpy(),
                         BWD_RTOL["bf16"])


@pytest.mark.cuda
def test_cuda_f32_calls_stay_on_the_f32_kernels(cuda_device):
    """An f32 forward and backward launch the f32 kernels, not sm90."""
    (q, do), k, v = _sm90_inputs((130, 130, 4, 2, 64), cuda_device, n_q=2)
    q, do, k, v = (t.float() for t in (q, do, k, v))
    fwd, bwd = _counts(FA.flash_attention), _counts(FA.flash_bwd)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    FA.flash_bwd(q, k, v, o, do, lse)
    assert _counts(FA.flash_attention) == (fwd[0], fwd[1] + 1)
    assert _counts(FA.flash_bwd) == (bwd[0], bwd[1] + 1)


@pytest.mark.cuda
def test_cuda_sm90_empty_sides(cuda_device):
    """bf16 calls with no keys or no queries: the forward writes o = 0 and
    lse = log(1e-30) (every row sees no key); the backward writes dq = 0
    without keys and dk = dv = 0 without queries. The plain versions cannot
    reduce over an empty key axis, so the values are written out."""
    (q,), k, v = _sm90_inputs((5, 0, 4, 2, 64), cuda_device)
    o, lse = FA.flash_attention(q, k, v, causal=False, return_lse=True)
    assert float(o.float().abs().max()) == 0.0
    assert torch.allclose(lse, torch.full_like(lse, math.log(1e-30)))
    dq, dk, dv = FA.flash_bwd(q, k, v, o, q, lse, causal=False)
    assert dq.shape == q.shape and float(dq.float().abs().max()) == 0.0
    assert dk.numel() == dv.numel() == 0
    (q,), k, v = _sm90_inputs((0, 7, 4, 2, 64), cuda_device)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    dq, dk, dv = FA.flash_bwd(q, k, v, o, q, lse)
    torch.cuda.synchronize()
    assert dq.numel() == 0 and dk.shape == k.shape
    assert float(dk.float().abs().max()) == 0.0
    assert float(dv.float().abs().max()) == 0.0
