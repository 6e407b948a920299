"""The arithmetic of the bf16 tensor-core attention kernels
(``csrc/flash_attention_sm90.cu``, ``csrc/flash_attention_bwd_sm90.cu``),
emulated on the CPU and held against the JAX reference at the port's bf16
limits; and the wrappers' choice of kernel variant.

The sm90 kernels multiply bf16 operands on the tensor cores with f32
accumulators. The inputs q, k, v, do, o are bf16 already, so S = Q K^T,
dP = dO V^T and every product with a bf16 input tile is exact up to the
f32 summation order. The operands formed inside the kernels are not: P
(forward, and both backward passes) and dS (backward) are f32 values
that enter their second product as hi = bf16(x) plus lo = bf16(x - hi),
two products summed into one f32 accumulator. ``_split`` emulates that,
tile by tile at the kernels' tile sizes, with the online softmax, lse and
D formed as the kernels form them. A single bf16 P or dS would not keep
the limits below (PERF.md, Findings).

Limits, as on the card:
- ``ATTN_TOL`` (chip_smoke.py) and ``RTOL`` (test_torch_attention.py),
  4e-3 of the largest reference value: the forward's bf16 output may
  land one bf16 step (2^-8) from the reference's, rounded the same way;
- ``LSE_TOL``, 1e-5 of the largest |lse|: the same f32 scores, another
  order;
- ``L2_TOL``, one bf16 step of the largest reference value, and
  ``BWD_RTOL``, 4e-3: dq, dk, dv against the reference's backward on the
  same (o, lse);
- ``E2E_TOL``, two bf16 steps: forward and backward together against
  ``jax.vjp`` of the reference, where D comes from the rounded o on one
  side only.

Inputs are made with numpy from a seed and rounded to bf16, so both sides
see the same values.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.ref import attention_mask
from torch_helpers import assert_rel_close, bf16_round

ATTN_TOL, LSE_TOL, L2_TOL, E2E_TOL = 4e-3, 1e-5, 1, 2
BWD_RTOL = 4e-3
LOG2E = 1.4426950408889634
FWD_TILE = 128      # keys per tile of the forward
BWD_TILE = 64       # keys (dq pass) and queries (dk/dv pass) per ring tile


def _split(x):
    """x = hi + lo, each rounded to bf16, as the kernels feed an f32
    operand to a bf16 product."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _single(x):
    """x rounded to one bf16 (and a zero second part): the design the
    split replaces."""
    hi = x.to(torch.bfloat16).float()
    return hi, torch.zeros_like(hi)


def _heads(x, Hkv):
    """(B, S, H, hd) -> (B, Hkv, group, S, hd), f32."""
    B, S, H, hd = x.shape
    return x.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)


def _unheads(x):
    B, Hkv, G, S, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, hd)


def emulate_fwd(q, k, v, causal, window, split=_split):
    """L1's sm90 arithmetic: online softmax over 128-key tiles, exp2 with
    the scale folded in, P = hi + lo into the P V product. Returns o
    (bf16, as written) and lse (f32, (B, Sq, H))."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qh = _heads(q, Hkv)
    kh, vh = (x.float().permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    mask = attention_mask(Sq, Skv, causal, window, "cpu")
    shape = (B, Hkv, H // Hkv, Sq, 1)
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    acc = torch.zeros((B, Hkv, H // Hkv, Sq, hd))
    for k0 in range(0, Skv, FWD_TILE):
        sl = slice(k0, k0 + FWD_TILE)
        s = qh @ kh[..., sl, :].transpose(-1, -2)
        s = s.masked_fill(~mask[:, sl], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.where(torch.isinf(m), 0.0,
                           torch.exp2((m - m_safe) * LOG2E))
        p = torch.where(s == -math.inf, 0.0,
                        torch.exp2(s * (scale * LOG2E) - m_safe * LOG2E))
        hi, lo = split(p)
        acc = acc * corr + hi @ vh[..., sl, :] + lo @ vh[..., sl, :]
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    denom = l.clamp_min(1e-30)
    o = _unheads(acc / denom).to(torch.bfloat16)
    lse = torch.where(torch.isinf(m), 0.0, m) + torch.log(denom)
    return o, _unheads(lse)[..., 0]


def _pad_cols(x, n):
    """x with zero columns appended up to ``n``: a head as a kernel's tile
    holds it when hd is below the tile's width."""
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def emulate_bwd(q, k, v, o, do, lse, causal, window, hd=None):
    """L2's sm90 arithmetic: D = rowsum(do * o) from the bf16 o; the dq pass
    over 64-key tiles (dS = hi + lo into dS K), the dk/dv pass over 64-query
    tiles (P^T and dS^T = hi + lo into P^T dO and dS^T Q), the GQA sum
    inside. ``hd``, the head size the scale is taken from, defaults to the
    inputs' width (the kernel passes the true hd where its tiles are
    wider). Returns dq, dk, dv in bf16, as written."""
    B, Sq, H, width = q.shape
    hd = hd or width
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qh, doh, oh = (_heads(x, Hkv) for x in (q, do, o))
    kh, vh = (x.float().permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    lse2 = _heads(lse[..., None], Hkv) * LOG2E
    D = (doh * oh).sum(-1, keepdim=True)
    mask = attention_mask(Sq, Skv, causal, window, "cpu")

    def p_ds(qs, ks):   # one tile pair: P and dS
        s = qh[..., qs, :] @ kh[..., ks, :].transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse2[..., qs, :])
        p = p.masked_fill(~mask[qs, ks], 0.0)
        dp = doh[..., qs, :] @ vh[..., ks, :].transpose(-1, -2)
        return p, p * (dp - D[..., qs, :])

    dq = torch.zeros_like(qh)
    every = slice(0, Sq)
    for k0 in range(0, Skv, BWD_TILE):
        ks = slice(k0, k0 + BWD_TILE)
        hi, lo = _split(p_ds(every, ks)[1])
        dq += hi @ kh[..., ks, :] + lo @ kh[..., ks, :]
    dk = torch.zeros((B, Hkv, 1, Skv, width))
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, BWD_TILE):
        qs = slice(q0, q0 + BWD_TILE)
        p, ds = p_ds(qs, slice(0, Skv))
        for x, acc, m in ((p, dv, doh), (ds, dk, qh)):
            hi, lo = _split(x.transpose(-1, -2))
            acc += (hi @ m[..., qs, :] + lo @ m[..., qs, :]).sum(
                2, keepdim=True)
    return (_unheads(dq * scale).to(torch.bfloat16),
            _unheads(dk * scale).to(torch.bfloat16),
            _unheads(dv).to(torch.bfloat16))


def _inputs(B, Sq, Skv, H, Hkv, hd, seed, n_q=1):
    """bf16 (q, k, v[, do]) made with numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)]
    shapes += [(B, Sq, H, hd)] * (n_q - 1)
    return [torch.from_numpy(bf16_round(rng.normal(size=s).astype(np.float32)))
            .to(torch.bfloat16) for s in shapes]


def _jnp(t):
    import jax.numpy as jnp
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x):
    return np.array(x, np.float32)


def _bf16_steps(err, scale, n):
    """err is within n bf16 steps of the largest reference value (the
    ``_limit`` rule of chip_smoke.py)."""
    return err <= n * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _jax_lse(q, k, causal, window):
    """The masked rows' logsumexp of the scaled scores in JAX, with L1's
    convention for a row that sees no key: log(1e-30)."""
    import jax.numpy as jnp
    from jax.nn import logsumexp
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = _jnp(q).astype(jnp.float32).reshape(B, Sq, Hkv, H // Hkv, hd)
    s = jnp.einsum("bqhgd,bkhd->bqhgk", qf / math.sqrt(hd),
                   _jnp(k).astype(jnp.float32))
    mask = jnp.asarray(attention_mask(Sq, Skv, causal, window,
                                      "cpu").numpy())
    s = jnp.where(mask[None, :, None, None, :], s, -jnp.inf)
    lse = logsumexp(s, axis=-1)
    lse = jnp.where(jnp.isinf(lse), math.log(1e-30), lse)
    return _np(lse.reshape(B, Sq, H))


# (id, B, Sq, Skv, H, Hkv, hd, causal, window): GQA groups 1, 2, 4; every
# head size L1 takes; Sq = Skv tiles the reference's Pallas wrapper takes,
# and ragged Sq != Skv (non-causal, which the wrapper cannot pad) against
# its jnp oracle, one with rows that see no key (i >= 116: keys > i - 40
# do not exist)
FWD_CASES = [
    ("causal-300-gqa2-hd64", 1, 300, 300, 4, 2, 64, True, 0),
    ("window128-700-gqa4-hd128", 1, 700, 700, 4, 1, 128, True, 128),
    ("causal-300-mha-hd112", 1, 300, 300, 4, 4, 112, True, 0),
    ("noncausal-512-gqa1-hd32", 2, 512, 512, 2, 2, 32, False, 0),
    ("ragged-77x300-gqa2-hd128", 1, 77, 300, 4, 2, 128, False, 0),
    ("ragged-300x77-window40-gqa4-hd64-empty-rows", 1, 300, 77, 4, 1, 64,
     False, 40),
]


def test_single_bf16_p_breaks_the_forward_limit():
    """Why P is split: the same emulation with P rounded to one bf16 moves
    an output of the windowed case past ATTN_TOL (one bf16 step too far),
    where hi + lo stays inside it."""
    from repro.kernels.flash_attention import ops as JFA
    _, B, Sq, Skv, H, Hkv, hd, causal, window = FWD_CASES[1]
    q, k, v = _inputs(B, Sq, Skv, H, Hkv, hd, seed=hd + Sq)
    want = bf16_round(_np(JFA.flash_attention(
        _jnp(q), _jnp(k), _jnp(v), causal=causal, window=window)))
    limit = ATTN_TOL * max(float(np.abs(want).max()), 1.0)
    errs = [float(np.abs(emulate_fwd(q, k, v, causal, window, split)[0]
                         .float().numpy() - want).max())
            for split in (_single, _split)]
    assert errs[0] > limit >= errs[1], (errs, limit)


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_split_forward_matches_reference(case):
    from repro.kernels.flash_attention import ops as JFA
    from repro.kernels.flash_attention.ref import flash_attention_ref
    _, B, Sq, Skv, H, Hkv, hd, causal, window = case
    q, k, v = _inputs(B, Sq, Skv, H, Hkv, hd, seed=hd + Sq)
    o, lse = emulate_fwd(q, k, v, causal, window)
    jargs = (_jnp(q), _jnp(k), _jnp(v))
    if Sq == Skv:
        want = _np(JFA.flash_attention(*jargs, causal=causal, window=window))
    else:
        want = _np(flash_attention_ref(*jargs, causal=causal, window=window))
    assert_rel_close(o.float().numpy(), want, ATTN_TOL)
    want16 = bf16_round(want)
    scale = max(float(np.abs(want16).max()), 1.0)
    assert float(np.abs(o.float().numpy() - want16).max()) <= ATTN_TOL * scale
    assert_rel_close(lse.numpy(), _jax_lse(q, k, causal, window), LSE_TOL)
    if window == 40:
        assert float(o[0, 116:].float().abs().max()) == 0.0


# (id, B, Sq, Skv, H, Hkv, hd, causal, window): the head sizes L2 takes,
# GQA groups 1, 2, 4; tile-aligned shapes (the reference's Pallas backward
# takes Sq % 256 == Skv % 512 == 0) against that backward on the same
# (o, lse), ragged ones (rows with no key among them) against jax.vjp
BWD_CASES = [
    ("causal-512-gqa2-hd64", 1, 512, 512, 4, 2, 64, True, 0),
    ("window128-512-gqa4-hd128", 1, 512, 512, 4, 1, 128, True, 128),
    ("noncausal-512-gqa1-hd32", 1, 512, 512, 2, 2, 32, False, 0),
    ("ragged-77x300-gqa2-hd128", 1, 77, 300, 4, 2, 128, False, 0),
    ("ragged-300x77-window40-gqa4-hd64-empty-rows", 1, 300, 77, 4, 1, 64,
     False, 40),
    ("ragged-causal-300-window64-gqa2-hd32", 1, 300, 300, 4, 2, 32, True,
     64),
    # zamba2's shared block: MHA at hd 112, which the sm90 kernel runs in
    # its 128-column tiles with columns 112-127 zero (``_pad_cols``)
    ("causal-512-mha-hd112", 1, 512, 512, 4, 4, 112, True, 0),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_split_backward_matches_reference(case):
    import jax
    from repro.kernels.flash_attention import ops as JFA
    from repro.kernels.flash_attention.ref import flash_attention_ref
    _, B, Sq, Skv, H, Hkv, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, hd, seed=7 * hd + Sq, n_q=2)
    o, lse = emulate_fwd(q, k, v, causal, window)
    got = emulate_bwd(q, k, v, o, do, lse, causal, window)
    if hd == 112:
        # the kernel's tiles: 128 columns, the last 16 zero-filled by the
        # tensor maps; only the first 112 columns of dq, dk, dv are stored
        wide = emulate_bwd(*(_pad_cols(t, 128) for t in (q, k, v, o, do)),
                           lse, causal, window, hd=hd)
        for a, b in zip(got, wide):
            assert torch.equal(b[..., hd:], torch.zeros_like(b[..., hd:]))
            assert_rel_close(b[..., :hd].float().numpy(), a.float().numpy(),
                             1e-6)
        got = [t[..., :hd] for t in wide]
    jq, jk, jv, jdo = (_jnp(t) for t in (q, k, v, do))
    if Sq % 256 == 0 and Skv % 512 == 0:
        # the reference's two Pallas backward kernels on the same o and lse
        want = JFA._fa_bwd(causal, window,
                           (jq, jk, jv, _jnp(o), _jnp(lse)), jdo)
        steps = L2_TOL
    else:
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
            a, b, c, causal=causal, window=window), jq, jk, jv)
        want = vjp(jdo.astype("float32"))
        steps = E2E_TOL
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        a, b = a.float().numpy(), bf16_round(_np(b))
        assert_rel_close(a, b, BWD_RTOL)
        scale = max(float(np.abs(b).max()), 1.0)
        err = float(np.abs(a - b).max())
        assert _bf16_steps(err, scale, steps), (name, err, scale)


# ---------------------------------------------------------------------------
# Which variant a wrapper launches: bf16 -> sm90, f32 -> the f32 kernels
# ---------------------------------------------------------------------------


class _Lib:
    """A stand-in for one C entry point: records its calls, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_libs(monkeypatch):
    """The wrappers' four C entry points replaced by recorders, and the
    card-only operand checks and stream by CPU stand-ins, so that the
    dispatch itself runs here."""
    libs = {name: _Lib() for name in ("_lib", "_lib_sm90", "_lib_bwd",
                                      "_lib_bwd_sm90")}
    for name, lib in libs.items():
        monkeypatch.setattr(FA, name, lambda lib=lib: lib)
    monkeypatch.setattr(FA, "check_cuda_operands", lambda t, d: None)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    for fn in (FA.flash_attention, FA.flash_bwd):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "sm90_launches", 0)
    return libs


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_forward_dispatch_by_dtype(stub_libs, dtype, hd):
    q, k, v = (torch.zeros((1, 40, h, hd), dtype=dtype) for h in (4, 2, 2))
    o, lse = FA._launch(q, k, v, True, 0, True)
    assert o.dtype == dtype and lse.dtype == torch.float32
    bf16 = dtype == torch.bfloat16
    sm90, simt = stub_libs["_lib_sm90"].calls, stub_libs["_lib"].calls
    assert (len(sm90), len(simt)) == ((1, 0) if bf16 else (0, 1))
    args = (sm90 or simt)[0]
    # both: 5 pointers, then B, Sq, Skv, H, Hkv, hd, causal, window
    assert args[5:] == (1, 40, 40, 4, 2, hd, 1, 0, 0)
    assert FA.flash_attention.launches == 1
    assert FA.flash_attention.sm90_launches == int(bf16)


@pytest.mark.parametrize("hd", FA.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_dispatch_by_dtype(stub_libs, dtype, hd):
    q, k, v = (torch.zeros((2, 40, h, hd), dtype=dtype) for h in (4, 1, 1))
    lse = torch.zeros((2, 40, 4))
    dq, dk, dv = FA._launch_bwd(q, k, v, q, q, lse, False, 16)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    bf16 = dtype == torch.bfloat16
    sm90, simt = stub_libs["_lib_bwd_sm90"].calls, stub_libs["_lib_bwd"].calls
    assert (len(sm90), len(simt)) == ((1, 0) if bf16 else (0, 1))
    args = (sm90 or simt)[0]
    # both: 10 pointers, then B, Sq, Skv, H, Hkv, hd, causal, window
    assert args[10:] == (2, 40, 40, 4, 1, hd, 0, 16, 0)
    assert FA.flash_bwd.launches == 1
    assert FA.flash_bwd.sm90_launches == int(bf16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_rejects_hd112(stub_libs, dtype):
    """L2 took hd 32, 64 and 128 until the hybrid family trained; it now
    takes L1's head sizes, 112 (zamba2's shared block) among them, in both
    variants, and a head size neither variant was built for (96) raises
    before any launch."""
    assert FA.BWD_HEAD_DIMS == FA.HEAD_DIMS and 112 in FA.BWD_HEAD_DIMS
    q, k, v = (torch.zeros((1, 40, 2, 96), dtype=dtype) for _ in range(3))
    with pytest.raises(ValueError, match="hd in"):
        FA._launch_bwd(q, k, v, q, q, torch.zeros((1, 40, 2)), True, 0)
    assert not any(lib.calls for lib in stub_libs.values())
    assert FA.flash_bwd.launches == 0
