"""The arithmetic of the f32 attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``), emulated on the CPU and held against the
JAX reference's Pallas kernels (interpret mode) at the port's f32 limits.

The kernels multiply f32 operands on the TF32 tensor cores. Each operand
x is split as hi = x rounded to TF32 (to nearest, ties away) and lo =
x - hi, of which the tensor core reads the TF32 part (its low 13 bits
dropped), and each product is lo.hi + hi.lo + hi.hi with f32
accumulators (3xTF32; ``mm3``). Every operand goes through that split:
q (scaled by 1/sqrt(hd) first), k, v, do, and the P and dS that the
kernels form. The tile math is the kernels': L1 runs 32-key tiles
through an online softmax (m, l) and writes lse; L2's dq pass forms
D = rowsum(do * o) and loops over 16-key tiles, its dk/dv pass loops
over the GQA group's q-heads and their 16-query tiles, the group's sum
inside. Each tile's products are a fresh partial added into an f32 sum,
as in the kernels. The tensor cores' own accumulation (it truncates) is
not emulated: the kernels keep their partials short for it, and the card
tests (``chip_smoke.py``) hold them to the same limits.

Limits, as on the card:
- ``RTOL["f32"]`` (test_torch_attention.py; ``ATTN_TOL`` and ``LSE_TOL``
  in chip_smoke.py), 1e-5 of the largest reference value: the forward
  and lse;
- ``BWD_RTOL["f32"]`` (``L2_TOL``, ``E2E_TOL``), 1e-4: dq, dk, dv.

Tile-aligned cases (Sq % 256 == Skv % 512 == 0 for the backward; the
forward's Pallas wrapper pads and masks causal keys) are held against the
reference's Pallas kernels; ragged non-causal ones, which its wrapper
cannot pad (it attends to padded keys), against its plain
``flash_attention_ref`` and ``jax.vjp`` of it. One TF32 product (``mm1``)
misses the forward limit, which is why the kernels take three. Inputs
are made with numpy from a seed.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_mask
from test_torch_attention import BWD_RTOL, RTOL
from test_torch_flash_split_numerics import (_heads, _jax_lse, _jnp, _np,
                                             _unheads)
from test_torch_precision_numerics import _split_tf32
from test_torch_scan_decode_numerics import tf32
from torch_helpers import assert_rel_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TILE = 32     # keys per tile of L1
BWD_TILE = 16     # keys (dq pass) and queries (dk/dv pass) per tile of L2


def mm3(a, b):
    """a @ b as the kernels form it: three TF32 products of split operands,
    summed in f32."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """One TF32 product: the design that 3xTF32 replaces."""
    return tf32(a) @ tf32(b)


def _kv(x):
    """(B, S, Hkv, hd) -> (B, Hkv, 1, S, hd), f32."""
    return x.float().permute(0, 2, 1, 3)[:, :, None]


def emulate_fwd(q, k, v, causal, window, mm=mm3):
    """L1: q scaled then split once, 32-key tiles, the online softmax, P
    split into P V. Returns o (B, Sq, H, hd) and lse (B, Sq, H)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qh = _heads(q, Hkv) * (1.0 / math.sqrt(hd))
    kh, vh = _kv(k), _kv(v)
    mask = attention_mask(Sq, Skv, causal, window, "cpu")
    shape = (B, Hkv, H // Hkv, Sq, 1)
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    acc = torch.zeros((B, Hkv, H // Hkv, Sq, hd))
    for k0 in range(0, Skv, FWD_TILE):
        sl = slice(k0, k0 + FWD_TILE)
        s = mm(qh, kh[..., sl, :].transpose(-1, -2))
        s = s.masked_fill(~mask[:, sl], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        p = torch.where(s == -math.inf, 0.0, torch.exp(s - m_safe))
        acc = acc * corr + mm(p, vh[..., sl, :])
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    denom = l.clamp_min(1e-30)
    lse = torch.where(torch.isinf(m), 0.0, m) + torch.log(denom)
    return _unheads(acc / denom), _unheads(lse)[..., 0]


def emulate_bwd(q, k, v, o, do, lse, causal, window, mm=mm3):
    """L2: D from o and do; the dq pass over 16-key tiles (dS K); the dk/dv
    pass over each q-head of the group and its 16-query tiles (P^T dO,
    dS^T Q), the group's sum inside. Returns dq, dk, dv."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qs, doh, oh = _heads(q, Hkv) * scale, _heads(do, Hkv), _heads(o, Hkv)
    kh, vh = _kv(k), _kv(v)
    L = _heads(lse[..., None], Hkv)
    D = (doh * oh).sum(-1, keepdim=True)
    mask = attention_mask(Sq, Skv, causal, window, "cpu")

    def p_ds(rows, keys):
        s = mm(qs[..., rows, :], kh[..., keys, :].transpose(-1, -2))
        p = torch.exp(s - L[..., rows, :]).masked_fill(~mask[rows, keys], 0.0)
        dp = mm(doh[..., rows, :], vh[..., keys, :].transpose(-1, -2))
        return p, p * (dp - D[..., rows, :])

    every = slice(0, None)
    dq = torch.zeros_like(qs)
    for k0 in range(0, Skv, BWD_TILE):
        keys = slice(k0, k0 + BWD_TILE)
        dq += mm(p_ds(every, keys)[1], kh[..., keys, :])
    dk = torch.zeros((B, Hkv, 1, Skv, hd))
    dv = torch.zeros_like(dk)
    for g in range(G):
        for q0 in range(0, Sq, BWD_TILE):
            rows = slice(q0, q0 + BWD_TILE)
            p, ds = (x[:, :, g:g + 1] for x in p_ds(rows, every))
            dv += mm(p.transpose(-1, -2), doh[:, :, g:g + 1, rows])
            dk += mm(ds.transpose(-1, -2), qs[:, :, g:g + 1, rows])
    return _unheads(dq * scale), _unheads(dk), _unheads(dv)


def _inputs(B, Sq, Skv, H, Hkv, hd, seed, n_q=1):
    """f32 (q, k, v[, do]) made with numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)]
    shapes += [(B, Sq, H, hd)] * (n_q - 1)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]


def _aligned(Sq, Skv):
    """Shapes the reference's Pallas kernels take as they are."""
    return Sq % 256 == 0 and Skv % 512 == 0


def _reference_fwd(q, k, v, causal, window):
    """The reference's (o, lse): its Pallas forward (interpret mode), which
    pads and masks causal keys; for a ragged non-causal shape its plain
    attention and the masked logsumexp."""
    import jax
    from repro.kernels.flash_attention import ops as JFA
    from repro.kernels.flash_attention.kernel import flash_attention_padded
    from repro.kernels.flash_attention.ref import flash_attention_ref
    Sq, Skv = q.shape[1], k.shape[1]
    jargs = (_jnp(q), _jnp(k), _jnp(v))
    if _aligned(Sq, Skv):
        o, lse = flash_attention_padded(*jargs, causal=causal, window=window,
                                        interpret=True, return_lse=True)
        return _np(o), _np(lse)
    if causal or Sq == Skv:
        o = JFA.flash_attention(*jargs, causal=causal, window=window)
    else:
        o = jax.jit(functools.partial(flash_attention_ref, causal=causal,
                                      window=window))(*jargs)
    return _np(o), _jax_lse(q, k, causal, window)


# (id, B, Sq, Skv, H, Hkv, hd, causal, window): GQA groups 1 and 4 (and 2);
# every head size L1 and L2 take; Pallas-aligned shapes and ragged ones
# (Sq != Skv, not multiples of the kernels' tiles), one with rows that see
# no key (i >= 60: keys > i - 15 do not exist)
FWD_CASES = [
    ("causal-256-gqa4-hd128", 1, 256, 256, 4, 1, 128, True, 0),
    ("window64-512-gqa1-hd64", 1, 512, 512, 2, 2, 64, True, 64),
    ("causal-200-mha-hd112", 1, 200, 200, 2, 2, 112, True, 0),
    ("noncausal-256x512-gqa4-hd32", 2, 256, 512, 4, 1, 32, False, 0),
    ("ragged-77x150-gqa4-hd128", 1, 77, 150, 4, 1, 128, False, 0),
    ("ragged-150x45-window15-gqa1-hd64-empty-rows", 1, 150, 45, 2, 2, 64,
     False, 15),
]


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_3xtf32_forward_and_lse_match_reference(case):
    _, B, Sq, Skv, H, Hkv, hd, causal, window = case
    q, k, v = _inputs(B, Sq, Skv, H, Hkv, hd, seed=hd + Sq)
    o, lse = emulate_fwd(q, k, v, causal, window)
    want, want_lse = _reference_fwd(q, k, v, causal, window)
    assert_rel_close(o.numpy(), want, RTOL["f32"])
    assert_rel_close(lse.numpy(), want_lse, RTOL["f32"])
    if window == 15:
        assert float(o[0, 60:].abs().max()) == 0.0


def test_single_tf32_product_breaks_the_forward_limit():
    """Why each product is three: the same emulation with one TF32 product
    (operands rounded to TF32, no lo) moves the output of a causal case
    past RTOL["f32"], where 3xTF32 stays inside it."""
    _, B, Sq, Skv, H, Hkv, hd, causal, window = FWD_CASES[0]
    q, k, v = _inputs(B, Sq, Skv, H, Hkv, hd, seed=hd + Sq)
    want, _ = _reference_fwd(q, k, v, causal, window)
    limit = RTOL["f32"] * max(float(np.abs(want).max()), 1.0)
    errs = [float(np.abs(emulate_fwd(q, k, v, causal, window, mm)[0]
                         .numpy() - want).max())
            for mm in (mm1, mm3)]
    assert errs[0] > limit >= errs[1], (errs, limit)


# (id, B, Sq, Skv, H, Hkv, hd, causal, window): the head sizes L2 takes,
# GQA groups 1 and 4; Pallas-aligned shapes against the reference's two
# backward kernels on the same (o, lse), ragged ones against jax.vjp of
# its plain attention
BWD_CASES = [
    ("causal-512-gqa4-hd128", 1, 512, 512, 4, 1, 128, True, 0),
    ("window128-512-gqa1-hd64", 1, 512, 512, 2, 2, 64, True, 128),
    ("noncausal-256x512-mha-hd112", 1, 256, 512, 2, 2, 112, False, 0),
    ("ragged-77x150-gqa4-hd32", 1, 77, 150, 4, 1, 32, False, 0),
    ("ragged-causal-150-window40-gqa1-hd128", 1, 150, 150, 2, 2, 128, True,
     40),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_3xtf32_backward_matches_reference(case):
    import jax
    from repro.kernels.flash_attention import ops as JFA
    from repro.kernels.flash_attention.ref import flash_attention_ref
    _, B, Sq, Skv, H, Hkv, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, hd, seed=7 * hd + Sq, n_q=2)
    o, lse = emulate_fwd(q, k, v, causal, window)
    got = emulate_bwd(q, k, v, o, do, lse, causal, window)
    jq, jk, jv, jdo = (_jnp(t) for t in (q, k, v, do))
    if _aligned(Sq, Skv):
        want = JFA._fa_bwd(causal, window,
                           (jq, jk, jv, _jnp(o), _jnp(lse)), jdo)
    else:
        def grads(a, b, c, d):      # one compiled program, not op by op
            return jax.vjp(lambda a, b, c: flash_attention_ref(
                a, b, c, causal=causal, window=window), a, b, c)[1](d)
        want = jax.jit(grads)(jq, jk, jv, jdo)
    for a, b in zip(got, want):
        assert_rel_close(a.numpy(), _np(b), BWD_RTOL["f32"])
