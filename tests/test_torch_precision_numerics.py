"""The arithmetic of kernel B1 (``csrc/bmf_precision.cu``), emulated on the
CPU and held against the JAX reference at the port's limit; and its
``cuda`` legs at the designs' edges.

K <= 16 runs one row per thread: the accumulate of B2
(``emulate_accum`` of test_torch_sweep_wkv_numerics.py: each live slot in
order adds one fma per entry of Λ's lower triangle and of η), then
τ·Λ mirrored to the full K x K.

16 < K <= 128 runs the tensor-core Gram kernel: K padded to a multiple of
16, the row's slots in chunks of 32, each chunk in steps of 8 slots (f32
factors: m16n8k8 TF32 products, each operand split x = hi + lo, hi
rounded to TF32 and lo = x - hi read truncated to TF32 by the tensor core,
and each product lo·hi + hi·lo + hi·hi) or 16 slots (bf16 factors:
one m16n8k16 bf16 product, exact for 0/1 weights; a chunk with another
weight scales the rows' operand A by w in f32 and splits it bf16
hi + lo). η is a slot-order f32 fma sum. ``emulate_gram`` does the same
with f32 matmuls of the rounded operands per step; ``mode="single"``
rounds each operand once (TF32 or bf16), the unsplit product.

Limit: ``RTOL`` of test_torch_bmf_precision.py, 1e-5 of the largest
reference entry, against the reference's Pallas kernel in interpret mode
and its dense oracle. Inputs are made with numpy from a seed
(``factor_case``).
"""
import numpy as np
import pytest
import torch

from repro_torch.data import sparse as TSP
from repro_torch.kernels.bmf_precision import ops as TOPS
from test_torch_bmf_precision import RTOL
from test_torch_scan_decode_numerics import bf16, tf32
from test_torch_sweep_wkv_numerics import emulate_accum, fma
from torch_helpers import (assert_rel_close, bf16_round,  # noqa: F401
                           cuda_device, factor_case)

CHUNK = 32           # slots per pipeline stage of the Gram kernel
# live lengths at the edges of the designs: empty, one slot, around a
# 16-slot bf16 step and an 8-slot TF32 step, around a 32-slot chunk
LIVE_EDGES = (0, 1, 15, 16, 17, 31, 33)


def live_case(seed, N, M, D, K, nnz=LIVE_EDGES, B=None, weights=False):
    """``factor_case`` with left-packed rows whose live lengths start with
    ``nnz`` (then M, then random), a masked slot below live in every third
    row, and with ``weights`` non-binary weights in (0, 3) on the live
    slots of every other row."""
    rng = np.random.default_rng(seed)
    c = factor_case(rng, N, M, D, K, B=B)
    lead = () if B is None else (B,)
    counts = rng.integers(0, M + 1, lead + (N,))
    edges = list(nnz) + [M]
    counts[..., :len(edges)] = edges[:N]
    mask = (np.arange(M) < counts[..., None]).astype(np.float32)
    mask[..., ::3, 0] = 0.0
    mask[counts == 0] = 0.0
    if weights:
        w = rng.uniform(0.05, 3.0, mask.shape).astype(np.float32)
        mask[..., ::2, :] *= w[..., ::2, :]
    c["mask"] = mask
    return c


# ---------------------------------------------------------------------------
# emulations
# ---------------------------------------------------------------------------


def emulate_row(idx, val, mask, other, tau):
    """K <= 16: (Λ (N, K, K), η (N, K)) as the row kernel forms them."""
    lam, eta = emulate_accum(idx, val, mask, other)
    low = torch.tril(lam)
    lam = low + torch.tril(lam, -1).transpose(-1, -2)
    return tau * lam, tau * eta


def _split(x, rnd):
    hi = rnd(x)
    return hi, rnd(x - hi)


def tf32_trunc(x):
    """The TF32 part of x that the tensor core reads: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_tf32(x):
    """x = hi + lo as the kernel splits it: hi rounded to TF32 (to nearest,
    ties away), lo = x - hi, read truncated to TF32."""
    hi = tf32(x)
    return hi, tf32_trunc(x - hi)


def emulate_gram(idx, val, mask, other, tau, dtype, mode="split"):
    """16 < K <= 128: (Λ, η) as the Gram kernel forms them on one block.
    ``other`` is f32 (bf16: already rounded); ``mode="single"`` rounds
    each operand once instead of splitting."""
    N, M = idx.shape
    K = other.shape[1]
    KP = -(-K // 16) * 16
    step = 8 if dtype == "fp32" else 16
    rnd = tf32 if dtype == "fp32" else bf16
    live = torch.where(mask != 0, torch.arange(1, M + 1), 0).amax(1)
    acc = torch.zeros((N, KP, KP))
    eta = torch.zeros((N, K))
    n_max = int(live.max()) if N else 0
    for c0 in range(0, n_max, CHUNK):
        s = torch.arange(c0, c0 + CHUNK)
        on = s[None, :] < live[:, None]                         # (N, 32)
        col = torch.clamp(s, max=M - 1)
        w = torch.where(on, mask[:, col], 0.0)
        r = torch.where(on, val[:, col], 0.0)
        V = torch.zeros((N, CHUNK, KP))
        V[..., :K] = torch.where((w != 0)[..., None],
                                 other[idx[:, col].long()], 0.0)
        binary = bool(((w == 0) | (w == 1)).all(1).all())
        for k0 in range(0, CHUNK, step):
            x = V[:, k0:k0 + step]                              # (N, S, KP)
            wx = w[:, k0:k0 + step, None] * x
            if mode == "single":
                acc = acc + rnd(wx).transpose(1, 2) @ rnd(x)
            elif dtype == "bf16":          # x exact in bf16
                if binary:
                    acc = acc + x.transpose(1, 2) @ x
                else:
                    hi, lo = _split(wx, bf16)
                    acc = acc + lo.transpose(1, 2) @ x
                    acc = acc + hi.transpose(1, 2) @ x
            else:
                bh, bl = _split_tf32(x)
                ah, al = (bh, bl) if binary else _split_tf32(wx)
                acc = acc + al.transpose(1, 2) @ bh
                acc = acc + ah.transpose(1, 2) @ bl
                acc = acc + ah.transpose(1, 2) @ bh
        for j in range(CHUNK):
            eta = fma((w[:, j] * r[:, j])[:, None], V[:, j, :K], eta)
    lam = tau * acc[:, :K, :K]
    lam = torch.tril(lam) + torch.tril(lam, -1).transpose(-1, -2)
    return lam, tau * eta


def _emulate(c, tau, dtype, mode="split"):
    other = bf16_round(c["other"]) if dtype == "bf16" else c["other"]
    t = {k: torch.from_numpy(c[k]) for k in ("idx", "val", "mask")}
    other = torch.from_numpy(other)
    if other.shape[-1] <= TOPS.ROW_K_MAX:
        return emulate_row(t["idx"], t["val"], t["mask"], other, tau)
    return emulate_gram(t["idx"], t["val"], t["mask"], other, tau, dtype,
                        mode)


def _reference(c, tau, dtype, pallas=True):
    """The reference's dense oracle and, with ``pallas``, its Pallas kernel
    in interpret mode, on the same inputs (bf16 factors as bf16)."""
    import jax.numpy as jnp
    from repro.kernels.bmf_precision import ops as JOPS
    other = jnp.asarray(c["other"], jnp.bfloat16 if dtype == "bf16"
                        else jnp.float32)
    args = (jnp.asarray(c["idx"]), jnp.asarray(c["val"]),
            jnp.asarray(c["mask"]), other, tau)
    out = [JOPS.precision_accum_reference(*args)]
    if pallas:
        out.append(JOPS.precision_accum_fused(*args, tm=128, interpret=True))
    return [tuple(np.asarray(x) for x in pair) for pair in out]


def _rel_err(got, want):
    lam, eta = (x.numpy() for x in got)
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1.0)
               for g, w in ((lam, want[0]), (eta, want[1])))


# ---------------------------------------------------------------------------
# K <= 16: one row per thread
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", [1, 8, 10, 16])
def test_row_accum_matches_pallas(K, dtype):
    """Live lengths 0, 1, 15, 16, 17, 31, 33 and the full M against the
    Pallas kernel and the dense oracle; Λ is exactly symmetric."""
    c = live_case(K, 12, 120, 37, K)
    lam, eta = _emulate(c, 1.7, dtype)
    assert torch.equal(lam, lam.transpose(-1, -2))
    for want in _reference(c, 1.7, dtype):
        assert_rel_close(lam.numpy(), want[0], RTOL)
        assert_rel_close(eta.numpy(), want[1], RTOL)
    assert float(lam[0].abs().max()) == 0.0          # the empty row


# ---------------------------------------------------------------------------
# 16 < K <= 128: split products on the tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", [17, 33, 100, 128])
def test_gram_split_matches_pallas(K, dtype):
    """3xTF32 (fp32) and exact bf16 products, in the kernel's chunk and
    step order, against the Pallas kernel and the dense oracle, with a
    margin of 5x; Λ is exactly symmetric."""
    c = live_case(K, 12, 96, 41, K)
    got = _emulate(c, 1.3, dtype)
    assert torch.equal(got[0], got[0].transpose(-1, -2))
    for want in _reference(c, 1.3, dtype):
        assert_rel_close(got[0].numpy(), want[0], RTOL)
        assert_rel_close(got[1].numpy(), want[1], RTOL)
        assert _rel_err(got, want) <= RTOL / 5
    assert float(got[0][0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gram_weights_other_than_zero_and_one(dtype):
    """Chunks holding weights other than 0 and 1 scale A by w and split it
    (bf16: hi + lo, two products); every other row carries such
    weights."""
    c = live_case(5, 10, 80, 29, 100, weights=True)
    assert np.unique(c["mask"]).size > 2
    got = _emulate(c, 2.0, dtype)
    for want in _reference(c, 2.0, dtype, pallas=dtype == "fp32"):
        assert_rel_close(got[0].numpy(), want[0], RTOL)
        assert_rel_close(got[1].numpy(), want[1], RTOL)


def test_gram_single_rounding_record():
    """Why the operands are split: one TF32 rounding of f32 factors, and
    one bf16 rounding of w·v for non-binary weights on bf16 factors, move
    Λ past RTOL, where the split stays 5x inside it."""
    cases = [("fp32", live_case(3, 10, 64, 23, 64)),
             ("bf16", live_case(4, 10, 64, 23, 64, weights=True))]
    for dtype, c in cases:
        want = _reference(c, 1.0, dtype, pallas=False)[0]
        split = _rel_err(_emulate(c, 1.0, dtype), want)
        single = _rel_err(_emulate(c, 1.0, dtype, "single"), want)
        assert split <= RTOL / 5, (dtype, split)
        assert single > RTOL, (dtype, single)


def test_gram_plan_table_is_the_kernels():
    """The Gram kernel's per-warp tile plan, read from its source, covers
    every lower 16 x 16 tile of Λ once for each K-block count, with at
    most 5 fragment blocks a warp (``plan_covers`` asserts the same when
    the kernel compiles)."""
    import re
    from pathlib import Path
    src = (Path(TOPS.__file__).resolve().parents[2] / "csrc"
           / "bmf_precision.cu").read_text()
    body = src[src.index("constexpr WarpPlan plan("):]
    body = body[:body.index("\n  }\n  return {0, {}, 0, {}, {}};")]
    cases = re.split(r"\n    case (\d+):", body)[1:]
    assert [int(nb) for nb in cases[::2]] == list(range(2, 9))
    for nb, text in zip(map(int, cases[::2]), cases[1::2]):
        seen = []
        for m in re.finditer(r"return \{(\d+), \{([\d, ]*)\}, (\d+), "
                             r"\{([\d, ]*)\}, \{([\d, ]*)\}\}", text):
            blk = [int(x) for x in m.group(2).split(",") if x.strip()]
            a = [int(x) for x in m.group(4).split(",") if x.strip()]
            b = [int(x) for x in m.group(5).split(",") if x.strip()]
            assert int(m.group(1)) == len(blk) <= 5
            assert int(m.group(3)) == len(a) == len(b)
            seen += [(blk[i], blk[j]) for i, j in zip(a, b)]
        want = [(i, j) for i in range(nb) for j in range(i + 1)]
        assert sorted(seen) == want, nb


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _on(c, device, dtype, tau=1.7):
    t = {k: torch.from_numpy(c[k]).to(device) for k in ("idx", "val", "mask",
                                                         "other")}
    other = t["other"].to(torch.bfloat16 if dtype == "bf16"
                          else torch.float32)
    return TOPS.precision_accum(t["idx"], t["val"], t["mask"], other, tau)


CUDA_KS = [1, 8, 10, 16, 17, 32, 33, 64, 100, 112, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", CUDA_KS)
def test_cuda_live_edges(cuda_device, K, dtype):
    """Rows with live 0, 1, 15, 16, 17, 31, 33 and M = 70 (not a multiple
    of 4: the scalar slot loads) in a batch of 3 blocks with their own
    factors, against the plain version."""
    c = live_case(K, 45, 70, 29, K, B=3)
    before = TOPS.precision_accum.launches
    lam, eta = _on(c, cuda_device, dtype)
    torch.cuda.synchronize()
    assert TOPS.precision_accum.launches == before + 1
    lam_p, eta_p = _on(c, "cpu", dtype)
    assert_rel_close(lam.cpu().numpy(), lam_p.numpy(), RTOL)
    assert_rel_close(eta.cpu().numpy(), eta_p.numpy(), RTOL)
    assert torch.equal(lam, lam.transpose(-1, -2))
    assert float(lam[:, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", [10, 100])
def test_cuda_weights_and_plane_widths(cuda_device, K, dtype):
    """Non-binary weights on every other row and planes 4-aligned (M =
    96, the 16-byte slot loads) against the plain version."""
    c = live_case(K + 1, 40, 96, 31, K, B=2, weights=True)
    lam, eta = _on(c, cuda_device, dtype, 0.9)
    lam_p, eta_p = _on(c, "cpu", dtype, 0.9)
    assert_rel_close(lam.cpu().numpy(), lam_p.numpy(), RTOL)
    assert_rel_close(eta.cpu().numpy(), eta_p.numpy(), RTOL)


@pytest.mark.cuda
def test_cuda_live_lengths_from_the_wrapper(cuda_device):
    """Given live lengths and computed ones launch the same kernel."""
    c = live_case(9, 33, 64, 19, 100, B=2)
    t = {k: torch.from_numpy(c[k]).to(cuda_device) for k in ("idx", "val",
                                                             "mask", "other")}
    live = TSP.row_live(t["mask"])
    a = TOPS.precision_accum(t["idx"], t["val"], t["mask"], t["other"], 1.0,
                             live)
    b = TOPS.precision_accum(t["idx"], t["val"], t["mask"], t["other"], 1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
