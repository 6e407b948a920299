"""The arithmetic of kernels B2 (``csrc/bmf_sweep.cu``) and L5
(``csrc/wkv6.cu``), emulated on the CPU and held against the JAX
reference at the port's limits; and their ``cuda`` legs at the designs'
edges.

B2, K <= 16, runs one row per thread: it adds each live slot's
w v vᵀ and w r v into Λ's lower triangle and η in slot order (one fma
per entry), forms A = τΛ + Λ_prior + jitter·I and b = τη + η_prior,
factors A by a right-looking Cholesky with one square root and one
correctly rounded reciprocal per column, solves L y = b forward, and
solves Lᵀ u = y + z backward (the reference's two backward systems, mean
and noise, in one). ``emulate_sweep`` does the same in f32, each fma as
one rounding of the exact f64 product and sum. Limit: 1e-5 of the largest
draw, the reference's own contract between its two sweep paths
(``bmf_sweep/ref.py``; ``RTOL`` of test_torch_bmf_sweep.py).

L5 runs its four products (r2 k2ᵀ, r2 (e^c S), A v and k2ᵀ v) on the
tensor cores over 64-step chunks, each f32 operand split as bf16
hi + lo and each product hi·hi + hi·lo + lo·hi, with the bonus
(r_t·u·k_t) on A's diagonal and the decays in log2 units. ``emulate_wkv``
does the same with f32 matmuls of the rounded operands (the split of
test_torch_scan_decode_numerics.py); ``mode="single"`` rounds each
operand once. Limit: ``SCAN_TOL`` (chip_smoke.py), 1e-4 of the largest
reference value.

Inputs are made with numpy from a seed (``factor_case`` and the cases and
inputs of test_torch_ssm_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bmf_sweep import ops as TSWEEP
from repro_torch.kernels.wkv6 import ops as WKV
from repro_torch.kernels.wkv6 import ref as WKVR
from test_torch_scan_decode_numerics import MODES, SCAN_TOL
from test_torch_ssm_kernels import WKV_CASES, _padded, _t, wkv_inputs
from torch_helpers import (assert_rel_close, bf16_round,  # noqa: F401
                           cuda_device, factor_case)

RTOL = 1e-5          # B2 against the reference (test_torch_bmf_sweep.py)
CUDA_RTOL = 1e-4     # a CUDA kernel against its plain version on the card
WKV_T = 64           # steps per chunk of L5
LOG2E = 1.4426950408889634
BUCKET_M = 1088      # padded slots of the MovieLens-20M phase-c bucket


# ---------------------------------------------------------------------------
# B2: one row per thread
# ---------------------------------------------------------------------------


def fma(a, b, c):
    """f32 fma: the exact product and sum, rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def emulate_accum(idx, val, mask, other):
    """The row accumulate of B1 and B2 for K <= 16 (``bmf_row_accum`` in
    ``csrc/bmf_common.cuh``) on one block: idx/val/mask (N, M), other
    (D, K) f32 (bf16 mode: already rounded). Each live slot in order adds
    one fma per entry: lam[i][c] += (w v_i) v_c, eta[i] += (w r) v_i.
    Returns the unscaled lam (N, K, K) (the kernels keep i >= c) and eta
    (N, K)."""
    N, M = idx.shape
    K = other.shape[1]
    live = torch.where(mask != 0, torch.arange(1, M + 1), 0).amax(1)
    lam = torch.zeros((N, K, K))
    eta = torch.zeros((N, K))
    for m in range(int(live.max()) if N else 0):
        on = m < live
        v = torch.where(on[:, None], other[idx[:, m].long()], 0.0)
        w = torch.where(on, mask[:, m], 0.0)
        wr = w * torch.where(on, val[:, m], 0.0)
        wv = w[:, None] * v
        lam = fma(wv[:, :, None], v[:, None, :], lam)
        eta = fma(wr[:, None], v, eta)
    return lam, eta


def emulate_sweep(idx, val, mask, pe, pL, z, other, tau, jitter=1e-6):
    """B2's arithmetic for K <= 16 on one block: idx/val/mask (N, M),
    pe/z (N, K), pL (N, K, K), other (D, K) f32 (bf16 mode: already
    rounded). Returns U (N, K) f32."""
    N = idx.shape[0]
    K = other.shape[1]
    lam, eta = emulate_accum(idx, val, mask, other)
    A = fma(torch.full_like(lam, tau), lam, pL)
    A = A + jitter * torch.eye(K)
    x = fma(torch.full_like(eta, tau), eta, pe)
    inv = torch.empty((N, K))
    for c in range(K):            # right-looking, lower triangle
        inv[:, c] = 1.0 / torch.sqrt(A[:, c, c])
        A[:, c + 1:, c] = A[:, c + 1:, c] * inv[:, c:c + 1]
        col = A[:, c + 1:, c]
        A[:, c + 1:, c + 1:] = fma(-col[:, :, None], col[:, None, :],
                                   A[:, c + 1:, c + 1:])
    for i in range(K):            # forward: y = L^-1 b
        acc = x[:, i]
        for c in range(i):
            acc = fma(-A[:, i, c], x[:, c], acc)
        x[:, i] = acc * inv[:, i]
    x = x + z                     # backward: u = L^-T (y + z)
    for i in range(K - 1, -1, -1):
        acc = x[:, i]
        for c in range(i + 1, K):
            acc = fma(-A[:, c, i], x[:, c], acc)
        x[:, i] = acc * inv[:, i]
    return x


def sweep_case(seed, N, M, D, K, nnz=None):
    """``factor_case`` with rows' live lengths set by ``nnz`` (left-packed
    masks; the rest random), and a masked slot below live in every third
    row."""
    rng = np.random.default_rng(seed)
    c = factor_case(rng, N, M, D, K)
    counts = rng.integers(0, M + 1, N)
    if nnz is not None:
        counts[:len(nnz)] = nnz
    mask = (np.arange(M) < counts[:, None]).astype(np.float32)
    mask[::3, 0] = 0.0
    mask[counts == 0] = 0.0
    c["mask"] = mask
    return c


def _jax_sweep(c, tau, dtype, **kw):
    import jax.numpy as jnp
    from repro.kernels.bmf_sweep import ops as JSWEEP
    j = {k: jnp.asarray(v) for k, v in c.items()}
    return np.asarray(JSWEEP.fused_sweep(
        j["z"], j["idx"], j["val"], j["mask"], j["pe"], j["pL"], j["other"],
        tau, dtype=dtype, **kw))


def _emulate(c, tau, dtype):
    other = bf16_round(c["other"]) if dtype == "bf16" else c["other"]
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return emulate_sweep(t["idx"], t["val"], t["mask"], t["pe"], t["pL"],
                         t["z"], torch.from_numpy(other), tau)


# live 0, 1, 31, 32, 33 and the full M, then random
LIVE_EDGES = (0, 1, 31, 32, 33, BUCKET_M)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", [1, 8, 10, 16])
def test_row_sweep_matches_pallas_at_bucket_m(K, dtype):
    """Rows with live 0, 1, 31, 32, 33 and the bucket's full M = 1,088
    slots, against the reference's Pallas kernel (interpret mode)."""
    c = sweep_case(K, 16, BUCKET_M, 61, K, nnz=LIVE_EDGES)
    got = _emulate(c, 2.0, dtype)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert_rel_close(got.numpy(), _jax_sweep(c, 2.0, dtype, force="pallas",
                                             interpret=True, n_stripe=16),
                     RTOL)


@pytest.mark.parametrize("N,M,D,K", [(5, 17, 23, 8), (19, 40, 31, 12),
                                     (40, 300, 29, 10), (33, 70, 29, 16)])
def test_row_sweep_matches_reference_striped(N, M, D, K):
    """The shapes of test_torch_bmf_sweep.py (K <= 16) against the
    reference's striped path, the same tile math as its Pallas kernel."""
    c = sweep_case(N, N, M, D, K, nnz=(0, 1, M))
    assert_rel_close(_emulate(c, 1.7, "fp32").numpy(),
                     _jax_sweep(c, 1.7, "fp32", force="ref"), RTOL)


def test_row_sweep_empty_row_is_the_prior_draw():
    """A row with no live slot factors the prior alone: u = Λ_p⁻¹η_p +
    L_p⁻ᵀz, the same draw as the plain version."""
    c = sweep_case(7, 6, 20, 13, 10, nnz=(0, 0, 5))
    got = _emulate(c, 1.3, "fp32")
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    want = TSWEEP.fused_sweep(t["z"], t["idx"], t["val"], t["mask"], t["pe"],
                              t["pL"], t["other"], 1.3)
    assert_rel_close(got[:2].numpy(), want[:2].numpy(), RTOL)


# ---------------------------------------------------------------------------
# L5: bf16 hi + lo products over 64-step chunks
# ---------------------------------------------------------------------------


def emulate_wkv(r, k, v, logw, u, s0, mode="split"):
    """L5's arithmetic on (B, S, H, N) f32 inputs: 64-step chunks, the
    cumulative decay in log2 units, r2 = r 2^{L_{t-1}-c}, k2 = k
    2^{c-L_t} with c = L_last / 2, the bonus on A's diagonal, every
    product through ``mode``'s rounding. Returns y (B, S, H, N) and the
    final state (B, H, N, N)."""
    mm = MODES[mode]
    B, S, H, N = r.shape
    below = torch.tril(torch.ones((WKV_T, WKV_T), dtype=torch.bool), -1)
    diag = torch.eye(WKV_T, dtype=torch.bool)
    state = s0.clone()
    y = torch.empty_like(r)
    for c0 in range(0, S, WKV_T):
        rb, kb, vb, wb = (x[:, c0:c0 + WKV_T].permute(0, 2, 1, 3)
                          for x in (r, k, v, logw))          # (B, H, T, N)
        w2 = wb * LOG2E
        L = torch.cumsum(w2, dim=2)
        c = 0.5 * L[:, :, -1:]
        r2 = rb * torch.exp2(L - w2 - c)
        k2 = kb * torch.exp2(c - L)
        ec = torch.exp2(c)[:, :, 0, :, None]                  # (B, H, N, 1)
        Sc = ec * state
        bonus = (rb * u[None, :, None, :] * kb).sum(-1)       # (B, H, T)
        A = torch.where(below, mm(r2, k2.transpose(-1, -2)), 0.0)
        A = torch.where(diag, bonus[..., None], A)
        yc = mm(r2, Sc) + mm(A, vb)
        y[:, c0:c0 + WKV_T] = yc.permute(0, 2, 1, 3)
        state = ec * (Sc + mm(k2.transpose(-1, -2), vb))
    return y, state


def _wkv_case(case):
    """The case's padded inputs (torch), the unpadded length, and the
    reference's y and state: its Pallas scan (interpret mode) on the
    padded steps and its sequential oracle on the unpadded ones."""
    import jax.numpy as jnp
    from repro.kernels.wkv6 import ops as JWKV
    raw = wkv_inputs(case)
    padded, S = _padded(raw, 4)
    pallas = JWKV.wkv6(*map(jnp.asarray, padded))
    oracle = JWKV.wkv6_reference(*map(jnp.asarray, raw))
    return _t(padded), S, [np.asarray(x) for x in pallas + oracle]


def _wkv_errors(got, S, want):
    """max |got - want| / max(|want|, 1) against the Pallas scan and the
    oracle, for y and the state."""
    y, st = (x.numpy() for x in got)
    y_k, st_k, y_o, st_o = want
    pairs = ((y, y_k), (st, st_k), (y[:, :S], y_o), (st, st_o))
    return [float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1.0)
            for g, w in pairs]


@pytest.mark.parametrize("case", WKV_CASES, ids=[c[0] for c in WKV_CASES])
def test_split_bf16_wkv_matches_reference(case):
    """Split bf16 operands keep L5 inside SCAN_TOL against the Pallas scan
    and the sequential oracle, with a margin of 5x; the strong-decay case
    runs factors up to 2^{+-46} inside a chunk."""
    args, S, want = _wkv_case(case)
    y, st = emulate_wkv(*args)
    assert y.dtype == st.dtype == torch.float32
    y_k, st_k, y_o, st_o = want
    assert_rel_close(y.numpy(), y_k, SCAN_TOL)
    assert_rel_close(st.numpy(), st_k, SCAN_TOL)
    assert_rel_close(y[:, :S].numpy(), y_o, SCAN_TOL)
    assert_rel_close(st.numpy(), st_o, SCAN_TOL)
    assert max(_wkv_errors((y, st), S, want)) <= SCAN_TOL / 5


def test_wkv_one_chunk_matches_pallas_kernel():
    """One 128-step chunk (two of the kernel's) against
    ``wkv_chunk_padded`` itself."""
    import jax.numpy as jnp
    from repro.kernels.wkv6.kernel import wkv_chunk_padded
    raw = wkv_inputs(WKV_CASES[0], seed=11)
    y, st = emulate_wkv(*_t(raw))
    y_k, st_k = wkv_chunk_padded(*map(jnp.asarray, raw), interpret=True)
    assert_rel_close(y.numpy(), np.asarray(y_k), SCAN_TOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), SCAN_TOL)


def test_wkv_single_rounding_record():
    """Why the operands are split: over WKV_CASES one bf16 rounding per
    operand moves L5 past SCAN_TOL, where hi + lo stays 5x inside it."""
    errs = {mode: [] for mode in ("split", "single")}
    for case in WKV_CASES:
        args, S, want = _wkv_case(case)
        for mode, found in errs.items():
            found.append(max(_wkv_errors(emulate_wkv(*args, mode=mode), S,
                                         want)))
    assert max(errs["split"]) <= SCAN_TOL / 5, errs
    assert max(errs["single"]) > SCAN_TOL, errs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _sweep_on(c, tau, dtype, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
    return TSWEEP.fused_sweep(t["z"], t["idx"], t["val"], t["mask"], t["pe"],
                              t["pL"], t["other"], tau, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("K", [1, 8, 10, 16, 17, 32])
def test_cuda_sweep_live_edges(cuda_device, K, dtype):
    """Rows with live 0, 1, 31, 32, 33 and M = 1,088 in one warp, the rest
    random (unsorted: the warp's rows have very unequal live lengths),
    on the row design (K <= 16) and the kept warp design (17, 32)."""
    c = sweep_case(K, 70, BUCKET_M, 61, K, nnz=LIVE_EDGES)
    before = TSWEEP.fused_sweep.launches
    U = _sweep_on(c, 2.0, dtype, cuda_device)
    torch.cuda.synchronize()
    assert TSWEEP.fused_sweep.launches == before + 1
    assert_rel_close(U.cpu().numpy(), _sweep_on(c, 2.0, dtype, "cpu").numpy(),
                     CUDA_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 4, 66])
def test_cuda_sweep_plane_widths(cuda_device, M):
    """Planes whose width is not a multiple of 4 take the scalar slot
    loads, the others the 16-byte ones; both agree with the plain
    version."""
    c = sweep_case(M, 45, M, 17, 10, nnz=(0, 1, M))
    assert_rel_close(_sweep_on(c, 1.5, "fp32", cuda_device).cpu().numpy(),
                     _sweep_on(c, 1.5, "fp32", "cpu").numpy(), CUDA_RTOL)


# (N, S, zero state, strong decay): both head sizes, one chunk, two, and
# the serve path's 4,096 steps
WKV_EDGE_CASES = [(n, s, zero, strong) for n in (32, 64)
                  for s in (64, 128, 4096)
                  for zero, strong in ((False, False), (True, False),
                                       (False, True))]


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,zero,strong", WKV_EDGE_CASES)
def test_cuda_wkv_kernel_edges(cuda_device, N, S, zero, strong):
    """The kernel on 64-step multiples (its own unit; the wrapper asks for
    the reference's 128) against the plain chunked version."""
    case = ("edge", 2, S, 3, N, 1.0 if strong else 0.0)
    r, k, v, logw, u, s0 = wkv_inputs(case, seed=S + N)
    if zero:
        s0 = np.zeros_like(s0)
    args = [t.to(cuda_device) for t in _t((r, k, v, logw, u, s0))]
    n0 = WKV.wkv6.launches
    y, st = WKV._launch(*args)
    assert WKV.wkv6.launches == n0 + 1
    y_p, st_p = WKVR.wkv_chunked(*args, chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert_rel_close(y.cpu().numpy(), y_p.cpu().numpy(), CUDA_RTOL)
    assert_rel_close(st.cpu().numpy(), st_p.cpu().numpy(), CUDA_RTOL)
