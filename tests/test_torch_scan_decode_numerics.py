"""The arithmetic of kernels L4 (``csrc/ssd_chunk.cu``) and L3
(``csrc/decode_attention.cu``), emulated on the CPU and held against the
JAX reference at the port's limits; and L3's split plan.

L4 runs its four products (C B^T, M X, C S^T and (w x)^T B) on the tensor
cores with bf16 operands and f32 accumulators, over 64-step chunks, with
C B^T formed once per (batch, chunk) for the heads of a block. Its inputs
are f32, so each operand is split as x = hi + lo, both rounded to bf16
(round to nearest even), and each product is hi·hi + hi·lo + lo·hi.
``emulate_ssd`` does the same with f32 matmuls of the rounded operands;
``mode="single"`` rounds each operand once, and ``mode="tf32"`` splits
into two TF32 parts, the kernel's first tensor-core design. Limit:
``SCAN_TOL`` (chip_smoke.py), 1e-4 of the largest reference value.

L3 cuts each (batch, kv head)'s slots into the splits of
``ops.split_plan``; a block scores 32-slot tiles with its lane groups,
each keeping its own online softmax in log2 units over batches of its
slots, merges the groups, and with more than one split a second launch
combines the splits (one split is normalised in the block itself).
``emulate_decode`` follows that order. Limits: ``RTOL`` of
test_torch_attention.py (f32 1e-5, bf16 4e-3: one bf16 step).

Inputs are made with numpy from a seed (the cases and inputs of
test_torch_ssm_kernels.py and test_torch_attention.py).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.decode_attention.ref import slot_valid
from test_torch_attention import DECODE_CASES, RTOL, decode_inputs
from test_torch_ssm_kernels import SSD_CASES, _padded, _t, ssd_inputs
from torch_helpers import assert_rel_close

SCAN_TOL = 1e-4
SSD_T = 64           # steps per chunk of the kernel
LOG2E = 1.4426950408889634


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).float()


def tf32(x):
    """x rounded to TF32 (10-bit mantissa), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(rnd):
    def mm(a, b):
        ah, bh = rnd(a), rnd(b)
        al, bl = rnd(a - ah), rnd(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return mm


MODES = {"split": _split_mm(bf16), "tf32": _split_mm(tf32),
         "single": lambda a, b: bf16(a) @ bf16(b)}


def emulate_ssd(xdt, a, B_, C_, s0, mode="split"):
    """L4's arithmetic on (Bb, S, H, P) f32 inputs: 64-step chunks, C B^T
    once per (batch, chunk) for all heads, the mask exp(L_t - L_j) from
    the difference, every product through ``mode``'s rounding.
    Returns y (Bb, S, H, P) and the final state (Bb, H, P, N)."""
    mm = MODES[mode]
    Bb, S, H, P = xdt.shape
    mask = torch.tril(torch.ones((SSD_T, SSD_T), dtype=torch.bool))
    state = s0.clone()
    y = torch.empty_like(xdt)
    for c0 in range(0, S, SSD_T):
        X = xdt[:, c0:c0 + SSD_T].permute(0, 2, 1, 3)            # (Bb,H,T,P)
        L = torch.cumsum(a[:, c0:c0 + SSD_T], dim=1).transpose(1, 2)
        Bc, Cc = B_[:, None, c0:c0 + SSD_T], C_[:, None, c0:c0 + SSD_T]
        G = mm(Cc[:, 0], Bc[:, 0].transpose(-1, -2))[:, None]     # shared
        D = L[..., :, None] - L[..., None, :]                     # L_t - L_j
        M = torch.where(mask, G * torch.exp(torch.where(mask, D, 0.0)), 0.0)
        yc = (torch.exp(L)[..., None] * mm(Cc, state.transpose(-1, -2))
              + mm(M, X))
        y[:, c0:c0 + SSD_T] = yc.permute(0, 2, 1, 3)
        w = torch.exp(L[..., -1:] - L)                             # (Bb,H,T)
        state = (torch.exp(L[..., -1])[..., None, None] * state
                 + mm((X * w[..., None]).transpose(-1, -2), Bc))
    return y, state


def _ssd_case(case):
    """The case's padded inputs (torch), the unpadded length, and the
    reference's y and state: its Pallas scan (interpret mode) on the
    padded steps and its sequential oracle on the unpadded ones."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk import ops as JSSD
    raw = ssd_inputs(case)
    padded, S = _padded(raw, 4)
    pallas = JSSD.ssd_scan(*map(jnp.asarray, padded))
    oracle = JSSD.ssd_scan_reference(*map(jnp.asarray, raw))
    return _t(padded), S, [np.asarray(x) for x in pallas + oracle]


def _ssd_errors(got, S, want):
    """max |got - want| / max(|want|, 1) against the Pallas scan and the
    oracle, for y and the state."""
    y, st = (x.numpy() for x in got)
    y_k, st_k, y_o, st_o = want
    pairs = ((y, y_k), (st, st_k), (y[:, :S], y_o), (st, st_o))
    return [float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1.0)
            for g, w in pairs]


@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_split_bf16_ssd_matches_reference(case):
    """Split bf16 operands keep L4 inside SCAN_TOL against the Pallas scan
    and the sequential oracle, with a margin of 5x."""
    args, S, want = _ssd_case(case)
    y, st = emulate_ssd(*args)
    assert y.dtype == st.dtype == torch.float32
    y_k, st_k, y_o, st_o = want
    assert_rel_close(y.numpy(), y_k, SCAN_TOL)
    assert_rel_close(st.numpy(), st_k, SCAN_TOL)
    assert_rel_close(y[:, :S].numpy(), y_o, SCAN_TOL)
    assert_rel_close(st.numpy(), st_o, SCAN_TOL)
    assert max(_ssd_errors((y, st), S, want)) <= SCAN_TOL / 5


def test_ssd_one_chunk_matches_pallas_kernel():
    """One 128-step chunk (two of the kernel's) against
    ``ssd_chunk_padded`` itself."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.kernel import ssd_chunk_padded
    raw = ssd_inputs(SSD_CASES[0], seed=11)
    y, st = emulate_ssd(*_t(raw))
    y_k, st_k = ssd_chunk_padded(*map(jnp.asarray, raw), interpret=True)
    assert_rel_close(y.numpy(), np.asarray(y_k), SCAN_TOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), SCAN_TOL)


def test_single_rounding_record():
    """Why the operands are split: over SSD_CASES one rounding per operand
    moves L4 past SCAN_TOL, where bf16 hi + lo stays 5x inside it (and
    TF32 hi + lo, the first tensor-core design, 10x)."""
    errs = {mode: [] for mode in MODES}
    for case in SSD_CASES:
        args, S, want = _ssd_case(case)
        for mode, found in errs.items():
            found.append(max(_ssd_errors(emulate_ssd(*args, mode=mode), S,
                                         want)))
    assert max(errs["split"]) <= SCAN_TOL / 5, errs
    assert max(errs["tf32"]) <= SCAN_TOL / 10, errs
    assert max(errs["single"]) > SCAN_TOL, errs


def test_bf16_split_keeps_16_bits():
    """hi + lo recovers x to 2^-16 of its size, and each part is a bf16."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 10.0
    hi = bf16(x)
    lo = bf16(x - hi)
    assert torch.equal(bf16(hi), hi) and torch.equal(bf16(lo), lo)
    assert float(((x - hi - lo).abs() / x.abs()).max()) <= 2.0 ** -16
    assert float(((x - hi).abs() / x.abs()).max()) > 2.0 ** -10


# ---------------------------------------------------------------------------
# L3: the split plan, and the split / combine arithmetic
# ---------------------------------------------------------------------------

# (B, Hkv, S, hd, SMs): the serve shapes (Qwen3, zamba2, the ragged
# cache), the allocation test's, small caches, another SM count, a batch
# of one and a large batch
PLAN_CASES = [(8, 8, 4096, 128, 132), (8, 32, 4096, 112, 132),
              (8, 8, 4033, 128, 132), (2, 4, 4113, 128, 132),
              (2, 2, 300, 32, 132), (1, 1, 1, 64, 132), (1, 1, 33, 64, 132),
              (8, 8, 4096, 128, 114), (1, 8, 4096, 128, 132),
              (64, 8, 4096, 128, 132), (1, 1, 100_000, 128, 132),
              (4, 2, 700, 64, 16)]


@pytest.mark.parametrize("B,Hkv,S,hd,n_sm", PLAN_CASES)
def test_split_plan_covers_s_and_fills_the_card(B, Hkv, S, hd, n_sm):
    n, chunk = DA.split_plan(B, Hkv, S, hd, n_sm)
    tiles = -(-S // DA.TILE)
    assert chunk % DA.TILE == 0 and chunk >= DA.TILE
    assert (n - 1) * chunk < S <= n * chunk            # every slot, once
    assert n == 1 or chunk >= DA.MIN_TILES * DA.TILE   # no split too short
    blocks = B * Hkv * n
    # every SM gets a block where S has enough tiles for it, and the grid
    # stays one wave of BLOCKS_PER_SM blocks per SM unless B * Hkv alone
    # exceeds it
    assert blocks >= min(n_sm, B * Hkv * max(1, tiles // DA.MIN_TILES))
    assert blocks <= max(B * Hkv, DA.BLOCKS_PER_SM * n_sm)


def test_split_plan_at_the_serve_shapes():
    """Qwen3-4B's 64 (b, kv head) pairs get 4 splits of 1,024 slots and
    zamba2-7b's 256 pairs one: 256 blocks each, two on nearly every one
    of 132 SMs."""
    assert DA.split_plan(8, 8, 4096, 128, 132) == (4, 1024)
    assert DA.split_plan(8, 32, 4096, 112, 132) == (1, 4096)


def _lanes(hd):
    """(lanes per slot, lane groups per block, slots per group and tile)
    of the kernel at head size hd."""
    chunks = hd // 8
    lps = 4 if chunks <= 4 else 8 if chunks <= 8 else 16
    groups = 4 * (32 // lps)
    return lps, groups, DA.TILE // groups


def emulate_decode(q, k, v, kv_pos, q_pos, window, n_sm=132):
    """L3's arithmetic: scores in log2 units (q scaled by log2(e)/sqrt(hd)),
    an online softmax per lane group over batches of its slots in each
    32-slot tile of each split of ``split_plan``, the groups merged per
    block, the splits combined. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    n, chunk = DA.split_plan(B, Hkv, S, hd, n_sm)
    _, groups, spg = _lanes(hd)
    gb = 1 if G == 1 else 4 if G <= 4 else 16
    sb = min(spg, max(1, 16 // gb))
    valid = slot_valid(kv_pos, q_pos, window)
    qs = q.float().reshape(B, Hkv, G, hd) * (LOG2E / math.sqrt(hd))
    kf, vf = k.float(), v.float()
    ninf = -math.inf
    Ms, Ls, As = [], [], []
    for c in range(n):
        s_lo, s_hi = c * chunk, min(S, (c + 1) * chunk)
        m = torch.full((B, Hkv, G, groups), ninf)
        l = torch.zeros((B, Hkv, G, groups))
        acc = torch.zeros((B, Hkv, G, groups, hd))
        for t0 in range(s_lo, s_hi, DA.TILE):
            for b0 in range(0, spg, sb):
                idx = (t0 + torch.arange(groups)[:, None] * spg + b0
                       + torch.arange(sb)[None, :])          # (groups, sb)
                ok = (idx < s_hi) & valid[idx.clamp(max=S - 1)]
                idx = idx.clamp(max=S - 1)
                sc = torch.einsum("bhgd,bnshd->bhgns", qs, kf[:, idx])
                mx = torch.where(ok, sc, ninf).amax(-1)
                m_new = torch.maximum(m, mx)
                m_safe = torch.where(m_new == ninf, 0.0, m_new)
                corr = torch.where(m == ninf, 0.0, torch.exp2(m - m_safe))
                p = torch.where(ok, torch.exp2(sc - m_safe[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                acc = (acc * corr[..., None]
                       + torch.einsum("bhgns,bnshd->bhgnd", p, vf[:, idx]))
                m = m_new
        M = m.amax(-1)
        w = torch.where(m == ninf, 0.0,
                        torch.exp2(m - torch.where(M == ninf, 0.0,
                                                   M)[..., None]))
        Ms.append(M)
        Ls.append((l * w).sum(-1))
        As.append((acc * w[..., None]).sum(-2))
    M, L, A = torch.stack(Ms), torch.stack(Ls), torch.stack(As)
    Mx = M.amax(0)
    w = torch.where(M == ninf, 0.0,
                    torch.exp2(M - torch.where(Mx == ninf, 0.0, Mx)))
    out = (A * w[..., None]).sum(0) / (L * w).sum(0).clamp_min(1e-30)[
        ..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _decode_want(q, k, v, kv_pos, q_pos, window):
    from repro.kernels.decode_attention import ops as JDA
    from test_torch_attention import _jnp
    jargs = (_jnp(q), _jnp(k), _jnp(v), _jnp(kv_pos))
    return np.asarray(JDA.decode_attention_reference(*jargs, q_pos, window),
                      np.float32)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_split_decode_matches_reference(case):
    """At 132 SMs every case is cut into several splits of 64 slots; the
    empty and windowed layouts leave some splits with no valid slot."""
    window, qdt = case[7], case[8]
    q, k, v, kv_pos, q_pos = decode_inputs(case)
    n, _ = DA.split_plan(q.shape[0], k.shape[2], k.shape[1], q.shape[2], 132)
    assert n > 1
    got = emulate_decode(q, k, v, kv_pos, q_pos, window)
    assert got.dtype == q.dtype
    assert_rel_close(got.float().numpy(),
                     _decode_want(q, k, v, kv_pos, q_pos, window), RTOL[qdt])


@pytest.mark.parametrize("n_sm", [1, 8, 132])
def test_split_decode_with_empty_splits_and_any_plan(n_sm):
    """A 700-slot ring whose window leaves 238 slots valid, planned for 1,
    8 and 132 SMs (1, 4 and 11 splits; with more than one, some see no
    valid slot), and a cache with no valid slot at all (zeros)."""
    case = ("ring-700-window-f32-gqa4", 2, 700, 8, 2, 64, "ring", 240, "f32",
            "f32")
    q, k, v, kv_pos, q_pos = decode_inputs(case, seed=4)
    valid = slot_valid(kv_pos, q_pos, 240)
    n, chunk = DA.split_plan(2, 2, 700, 64, n_sm)
    splits = [bool(valid[c * chunk:(c + 1) * chunk].any()) for c in range(n)]
    assert all(splits) == (n == 1)
    got = emulate_decode(q, k, v, kv_pos, q_pos, 240, n_sm=n_sm)
    assert_rel_close(got.numpy(), _decode_want(q, k, v, kv_pos, q_pos, 240),
                     RTOL["f32"])
    none = emulate_decode(q, k, v, torch.full_like(kv_pos, -1), q_pos, 0,
                          n_sm=n_sm)
    assert float(none.abs().max()) == 0.0
