"""Kernels L4 (``ssd_scan``, the Mamba2 SSD scan) and L5 (``wkv6``, the
RWKV6 WKV recurrence) of the port against the JAX reference.

On the CPU each wrapper runs its plain chunked version. It is held
against the reference's Pallas kernels in interpret mode, on one chunk
(``ssd_chunk_padded`` / ``wkv_chunk_padded``) and over several chunks
(``ops.ssd_scan`` / ``ops.wkv6``, which run the Pallas kernel per chunk
inside a ``lax.scan``), and against the reference's sequential oracles.
The shapes are those of the reference's own kernel tests
(``tests/test_kernels.py``), plus a sequence that is not a multiple of 128,
padded with identity steps as the mixers pad it, and a strong-decay case.

Tolerance: 2e-4 relative to the largest reference value, the reference's
own limit for its kernels against the oracles (f32 sums in other orders
over up to 384 steps). The ``cuda`` legs hold each CUDA kernel against its
plain version on the card at 1e-4 (both f32; the kernel's 64-step chunks
and summation order differ from the plain version's 128-step chunks), and
check that a CUDA tensor that needs a gradient raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_chunk import ops as SSD
from repro_torch.kernels.ssd_chunk import ref as SSDR
from repro_torch.kernels.wkv6 import ops as WKV
from repro_torch.kernels.wkv6 import ref as WKVR
from torch_helpers import assert_rel_close, cuda_device  # noqa: F401

RTOL = 2e-4
CUDA_RTOL = 1e-4

# (B, S, H, P, N) of the reference's test_ssd_chunk_sweep, a ragged S
# padded to 256, and strong decay (a ≈ -2 per step: L reaches ~ -256 in a
# 128-step chunk)
SSD_CASES = [("1-128-2-64-64", 1, 128, 2, 64, 64, 1.0),
             ("2-256-3-32-16", 2, 256, 3, 32, 16, 1.0),
             ("1-384-1-64-64", 1, 384, 1, 64, 64, 1.0),
             ("2-200-3-32-16-ragged", 2, 200, 3, 32, 16, 1.0),
             ("1-256-2-64-64-strong", 1, 256, 2, 64, 64, 2.0)]
# (B, S, H, N) of the reference's test_wkv6_sweep, a ragged S, and strong
# decay (log w ≈ -1 per step)
WKV_CASES = [("1-128-2-64", 1, 128, 2, 64, 0.0),
             ("2-256-1-64", 2, 256, 1, 64, 0.0),
             ("1-384-4-32", 1, 384, 4, 32, 0.0),
             ("2-200-2-32-ragged", 2, 200, 2, 32, 0.0),
             ("1-256-2-64-strong", 1, 256, 2, 64, 1.0)]


def _pad(x, S_pad):
    """Zero steps appended along axis 1 (identity steps of both scans)."""
    pad = np.zeros((x.shape[0], S_pad - x.shape[1]) + x.shape[2:], x.dtype)
    return np.concatenate([x, pad], axis=1)


def ssd_inputs(case, seed=5):
    _, B, S, H, P, N, decay = case
    rng = np.random.default_rng(seed)
    xdt = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    if decay > 1:
        a = (-decay + 0.1 * rng.normal(size=(B, S, H))).astype(np.float32)
    else:
        a = (-np.exp(rng.normal(size=(B, S, H)) - 1)).astype(np.float32)
    B_ = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    C_ = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(B, H, P, N)) * 0.1).astype(np.float32)
    return xdt, a, B_, C_, s0


def wkv_inputs(case, seed=3):
    _, B, S, H, N, decay = case
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, S, H, N)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, N)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, S, H, N)).astype(np.float32)
    if decay:
        logw = (-decay + 0.1 * rng.normal(size=(B, S, H, N))
                ).astype(np.float32)
    else:
        logw = (-np.exp(rng.normal(size=(B, S, H, N)) - 2)
                ).astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _padded(arrays, n_seq):
    """Pad the sequence inputs (the first ``n_seq``) to a multiple of 128,
    as the mixers pad."""
    S = arrays[0].shape[1]
    S_pad = -(-S // 128) * 128
    return [_pad(a, S_pad) if i < n_seq else a
            for i, a in enumerate(arrays)], S


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# L4: ssd_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_plain_matches_reference(case):
    """The port's ssd_scan on the CPU against the reference's ops.ssd_scan
    (Pallas per chunk, interpret mode) and its sequential oracle over the
    unpadded steps."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk import ops as JSSD
    raw = ssd_inputs(case)
    (xdt, a, B_, C_, s0), S = _padded(raw, 4)
    y, st = SSD.ssd_scan(*_t((xdt, a, B_, C_, s0)))
    assert y.dtype == st.dtype == torch.float32
    y_k, st_k = JSSD.ssd_scan(*map(jnp.asarray, (xdt, a, B_, C_, s0)))
    assert_rel_close(y.numpy(), np.asarray(y_k), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), RTOL)
    y_o, st_o = JSSD.ssd_scan_reference(*map(jnp.asarray, raw))
    assert_rel_close(y[:, :S].numpy(), np.asarray(y_o), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_o), RTOL)


def test_ssd_plain_one_chunk_matches_pallas_kernel():
    """One 128-step chunk against ``ssd_chunk_padded`` itself."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.kernel import ssd_chunk_padded
    xdt, a, B_, C_, s0 = ssd_inputs(SSD_CASES[0], seed=11)
    y, st = SSD.ssd_scan(*_t((xdt, a, B_, C_, s0)))
    y_k, st_k = ssd_chunk_padded(*map(jnp.asarray, (xdt, a, B_, C_, s0)),
                                 interpret=True)
    assert_rel_close(y.numpy(), np.asarray(y_k), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), RTOL)


def test_ssd_sequential_matches_reference_oracle():
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk import ops as JSSD
    raw = ssd_inputs(SSD_CASES[3], seed=2)
    y, st = SSDR.ssd_sequential(*_t(raw))
    y_o, st_o = JSSD.ssd_scan_reference(*map(jnp.asarray, raw))
    assert_rel_close(y.numpy(), np.asarray(y_o), 1e-5)
    assert_rel_close(st.numpy(), np.asarray(st_o), 1e-5)


def test_ssd_rejects_bad_operands():
    xdt, a, B_, C_, s0 = _t(ssd_inputs(SSD_CASES[1]))
    with pytest.raises(ValueError, match="multiple"):
        SSD.ssd_scan(xdt[:, :200], a[:, :200], B_[:, :200], C_[:, :200], s0)
    with pytest.raises(ValueError):
        SSD.ssd_scan(xdt, a, B_, C_, s0[:, :1])


# ---------------------------------------------------------------------------
# L5: wkv6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", WKV_CASES, ids=[c[0] for c in WKV_CASES])
def test_wkv_plain_matches_reference(case):
    """The port's wkv6 on the CPU against the reference's ops.wkv6 (Pallas
    per chunk, interpret mode) and its sequential oracle over the unpadded
    steps."""
    import jax.numpy as jnp
    from repro.kernels.wkv6 import ops as JWKV
    raw = wkv_inputs(case)
    (r, k, v, logw, u, s0), S = _padded(raw, 4)
    y, st = WKV.wkv6(*_t((r, k, v, logw, u, s0)))
    assert y.dtype == st.dtype == torch.float32
    y_k, st_k = JWKV.wkv6(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    assert_rel_close(y.numpy(), np.asarray(y_k), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), RTOL)
    y_o, st_o = JWKV.wkv6_reference(*map(jnp.asarray, raw))
    assert_rel_close(y[:, :S].numpy(), np.asarray(y_o), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_o), RTOL)


def test_wkv_plain_one_chunk_matches_pallas_kernel():
    """One 128-step chunk against ``wkv_chunk_padded`` itself."""
    import jax.numpy as jnp
    from repro.kernels.wkv6.kernel import wkv_chunk_padded
    r, k, v, logw, u, s0 = wkv_inputs(WKV_CASES[0], seed=11)
    y, st = WKV.wkv6(*_t((r, k, v, logw, u, s0)))
    y_k, st_k = wkv_chunk_padded(*map(jnp.asarray, (r, k, v, logw, u, s0)),
                                 interpret=True)
    assert_rel_close(y.numpy(), np.asarray(y_k), RTOL)
    assert_rel_close(st.numpy(), np.asarray(st_k), RTOL)


def test_wkv_sequential_matches_reference_oracle():
    import jax.numpy as jnp
    from repro.kernels.wkv6 import ops as JWKV
    raw = wkv_inputs(WKV_CASES[3], seed=2)
    y, st = WKVR.wkv_sequential(*_t(raw))
    y_o, st_o = JWKV.wkv6_reference(*map(jnp.asarray, raw))
    assert_rel_close(y.numpy(), np.asarray(y_o), 1e-5)
    assert_rel_close(st.numpy(), np.asarray(st_o), 1e-5)


def test_wkv_rejects_bad_operands():
    r, k, v, logw, u, s0 = _t(wkv_inputs(WKV_CASES[1]))
    with pytest.raises(ValueError, match="multiple"):
        WKV.wkv6(r[:, :200], k[:, :200], v[:, :200], logw[:, :200], u, s0)
    with pytest.raises(ValueError):
        WKV.wkv6(r, k, v, logw, u[:, :1], s0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _alloc_peak(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _rounded(n):
    return (n + 511) // 512 * 512


@pytest.mark.cuda
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_cuda_ssd_kernel_matches_plain(case, zero_state, cuda_device):
    (xdt, a, B_, C_, s0), _ = _padded(ssd_inputs(case), 4)
    if zero_state:
        s0 = np.zeros_like(s0)
    args = [t.to(cuda_device) for t in _t((xdt, a, B_, C_, s0))]
    n0 = SSD.ssd_scan.launches
    (y, st), peak = _alloc_peak(lambda: SSD.ssd_scan(*args))
    assert SSD.ssd_scan.launches == n0 + 1
    assert peak <= _rounded(y.numel() * 4) + _rounded(st.numel() * 4)
    y_p, st_p = SSDR.ssd_chunked(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert_rel_close(y.cpu().numpy(), y_p.cpu().numpy(), CUDA_RTOL)
    assert_rel_close(st.cpu().numpy(), st_p.cpu().numpy(), CUDA_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("case", WKV_CASES, ids=[c[0] for c in WKV_CASES])
def test_cuda_wkv_kernel_matches_plain(case, zero_state, cuda_device):
    (r, k, v, logw, u, s0), _ = _padded(wkv_inputs(case), 4)
    if zero_state:
        s0 = np.zeros_like(s0)
    args = [t.to(cuda_device) for t in _t((r, k, v, logw, u, s0))]
    n0 = WKV.wkv6.launches
    (y, st), peak = _alloc_peak(lambda: WKV.wkv6(*args))
    assert WKV.wkv6.launches == n0 + 1
    assert peak <= _rounded(y.numel() * 4) + _rounded(st.numel() * 4)
    y_p, st_p = WKVR.wkv_chunked(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert_rel_close(y.cpu().numpy(), y_p.cpu().numpy(), CUDA_RTOL)
    assert_rel_close(st.cpu().numpy(), st_p.cpu().numpy(), CUDA_RTOL)


# L4 at its block and chunk boundaries: (B, S, H, P, N). Blocks hold two
# heads (an odd H leaves the last block one), chunks are 64 steps (the
# wrapper's S is a multiple of 128): one head, 3, 7 and 113 heads (zamba2's
# 112 plus one), both (P, N), one chunk pair and many
SSD_EDGE_CASES = [("1-128-1-64-64", 1, 128, 1, 64, 64, 1.0),
                  ("2-128-7-32-16", 2, 128, 7, 32, 16, 1.0),
                  ("1-640-3-64-64-strong", 1, 640, 3, 64, 64, 2.0),
                  ("1-256-113-64-64", 1, 256, 113, 64, 64, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_EDGE_CASES,
                         ids=[c[0] for c in SSD_EDGE_CASES])
def test_cuda_ssd_kernel_block_boundaries(case, cuda_device):
    args = [t.to(cuda_device) for t in _t(ssd_inputs(case, seed=9))]
    n0 = SSD.ssd_scan.launches
    y, st = SSD.ssd_scan(*args)
    assert SSD.ssd_scan.launches == n0 + 1
    y_p, st_p = SSDR.ssd_chunked(*args)
    assert_rel_close(y.cpu().numpy(), y_p.cpu().numpy(), CUDA_RTOL)
    assert_rel_close(st.cpu().numpy(), st_p.cpu().numpy(), CUDA_RTOL)


@pytest.mark.cuda
def test_cuda_kernels_refuse_gradients(cuda_device):
    """No VJP, on the card as in the reference: a CUDA tensor that needs a
    gradient raises, naming the training scan, instead of running the
    plain version."""
    xdt, a, B_, C_, s0 = (t.to(cuda_device)
                          for t in _t(ssd_inputs(SSD_CASES[0])))
    with pytest.raises(NotImplementedError, match="training scan"):
        SSD.ssd_scan(xdt.requires_grad_(), a, B_, C_, s0)
    r, k, v, logw, u, s0 = (t.to(cuda_device)
                            for t in _t(wkv_inputs(WKV_CASES[0])))
    with pytest.raises(NotImplementedError, match="training scan"):
        WKV.wkv6(r, k, v, logw.requires_grad_(), u, s0)
    with torch.no_grad():         # no gradient recorded: the kernel runs
        WKV.wkv6(r, k, v, logw, u, s0)
