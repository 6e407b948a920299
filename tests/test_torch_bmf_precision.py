"""Kernel B1 (bmf_precision): the port against the JAX reference.

On the CPU the port's wrapper runs its plain version; it is held against
the reference's dense oracle, its off-TPU chunked path and its Pallas
kernel in interpret mode, on the same numpy inputs. The ``cuda`` leg holds
the CUDA kernel against the plain version on the card.

Tolerances. fp32: 1e-5 relative to the largest entry — both sides sum the
same f32 products in different orders (the reference's own contract
between its two sweep paths is 1e-5). bf16: the same 1e-5 — both sides
round the factor to bf16 identically before the gather, a product of two
bf16 values is exact in f32, and the sums are f32 on both sides, so only
the summation order differs.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import sparse as TSP
from repro_torch.kernels.bmf_precision import ops as TOPS
from torch_helpers import (assert_rel_close, bf16_round,  # noqa: F401
                           cuda_device, factor_case)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    assert_rel_close(got, want, rtol)


def _jax_ops():
    from repro.kernels.bmf_precision import ops as JOPS
    return JOPS


@pytest.mark.parametrize("N,M,K", [(5, 17, 8), (16, 64, 10), (33, 100, 100),
                                   (8, 256, 16), (3, 512, 32)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_reference_oracle(N, M, K, dtype):
    import jax.numpy as jnp
    JOPS = _jax_ops()
    rng = np.random.default_rng(42)
    c = factor_case(rng, N, M, 50, K, empty_rows=(0,))
    other = bf16_round(c["other"]) if dtype == "bf16" else c["other"]
    t_other = torch.from_numpy(other)
    if dtype == "bf16":
        t_other = t_other.to(torch.bfloat16)
    lam, eta = TOPS.precision_accum(torch.from_numpy(c["idx"]),
                                    torch.from_numpy(c["val"]),
                                    torch.from_numpy(c["mask"]), t_other, 2.5)
    j_other = jnp.asarray(other, jnp.bfloat16 if dtype == "bf16"
                          else jnp.float32)
    lam_r, eta_r = JOPS.precision_accum_reference(
        jnp.asarray(c["idx"]), jnp.asarray(c["val"]), jnp.asarray(c["mask"]),
        j_other, 2.5)
    _close(lam, lam_r)
    _close(eta, eta_r)
    # the reference's off-TPU production path (N-striped XLA)
    lam_c, eta_c = JOPS.precision_accum_chunked(
        jnp.asarray(c["idx"]), jnp.asarray(c["val"]), jnp.asarray(c["mask"]),
        j_other, 2.5)
    _close(lam, lam_c)
    _close(eta, eta_c)
    assert float(lam[0].abs().max()) == 0.0    # empty row: exact zeros


def test_plain_matches_pallas_interpret():
    """All-padding M-tiles (M=300 pads to three tm=128 tiles, most rows
    live only in the first) and fully empty rows."""
    import jax.numpy as jnp
    JOPS = _jax_ops()
    rng = np.random.default_rng(7)
    c = factor_case(rng, 9, 300, 37, 12, empty_rows=(0, 8))
    c["mask"][1:8, 100:] = 0.0                  # tiles 2-3 dead for most rows
    lam, eta = TOPS.precision_accum(torch.from_numpy(c["idx"]),
                                    torch.from_numpy(c["val"]),
                                    torch.from_numpy(c["mask"]),
                                    torch.from_numpy(c["other"]), 1.3)
    lam_p, eta_p = JOPS.precision_accum_fused(
        jnp.asarray(c["idx"]), jnp.asarray(c["val"]), jnp.asarray(c["mask"]),
        jnp.asarray(c["other"]), 1.3, tm=128, interpret=True)
    _close(lam, lam_p)
    _close(eta, eta_p)


def test_leading_block_axis_and_live_lengths():
    """A stacked (B, N, M) batch equals the per-block reference, with the
    per-row live lengths given explicitly or computed by the wrapper."""
    import jax.numpy as jnp
    JOPS = _jax_ops()
    rng = np.random.default_rng(3)
    c = factor_case(rng, 11, 40, 23, 10, empty_rows=(4,), B=3)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    live = TSP.row_live(t["mask"])
    lam, eta = TOPS.precision_accum(t["idx"], t["val"], t["mask"],
                                    t["other"], 2.0, live=live)
    lam2, eta2 = TOPS.precision_accum(t["idx"], t["val"], t["mask"],
                                      t["other"], 2.0)
    torch.testing.assert_close(lam, lam2, rtol=0, atol=0)
    torch.testing.assert_close(eta, eta2, rtol=0, atol=0)
    for b in range(3):
        lam_r, eta_r = JOPS.precision_accum_reference(
            jnp.asarray(c["idx"][b]), jnp.asarray(c["val"][b]),
            jnp.asarray(c["mask"][b]), jnp.asarray(c["other"][b]), 2.0)
        _close(lam[b], lam_r)
        _close(eta[b], eta_r)


def test_truncated_rows():
    """CSR built with a truncating max_nnz bucket: the port's planes equal
    the reference's, and so do the statistics."""
    import jax.numpy as jnp
    from repro.data import sparse as JSP
    JOPS = _jax_ops()
    rng = np.random.default_rng(11)
    n_rows, n_cols, nnz = 19, 23, 400
    args = (rng.integers(0, n_rows, nnz).astype(np.int32),
            rng.integers(0, n_cols, nnz).astype(np.int32),
            rng.normal(size=nnz).astype(np.float32), n_rows, n_cols)
    csr = TSP.coo_to_padded_csr(TSP.COO(*args), max_nnz=16, as_numpy=True)
    jcsr = JSP.coo_to_padded_csr(JSP.COO(*args), max_nnz=16)
    for name in ("idx", "val", "mask"):
        np.testing.assert_array_equal(getattr(csr, name),
                                      np.asarray(getattr(jcsr, name)))
    other = rng.normal(size=(n_cols, 8)).astype(np.float32)
    lam, eta = TOPS.precision_accum(torch.from_numpy(csr.idx),
                                    torch.from_numpy(csr.val),
                                    torch.from_numpy(csr.mask),
                                    torch.from_numpy(other), 2.0)
    lam_r, eta_r = JOPS.precision_accum_reference(
        jcsr.idx, jcsr.val, jcsr.mask, jnp.asarray(other), 2.0)
    _close(lam, lam_r)
    _close(eta, eta_r)


def test_cpu_tensor_never_counts_a_launch():
    rng = np.random.default_rng(0)
    c = factor_case(rng, 4, 8, 5, 3)
    before = TOPS.precision_accum.launches
    TOPS.precision_accum(torch.from_numpy(c["idx"]),
                         torch.from_numpy(c["val"]),
                         torch.from_numpy(c["mask"]),
                         torch.from_numpy(c["other"]), 1.0)
    assert TOPS.precision_accum.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 10, 16, 32, 33, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, K, dtype):
    rng = np.random.default_rng(K)
    c = factor_case(rng, 37, 70, 29, K, empty_rows=(0, 36), B=3)
    c["mask"][:, 5:20, 40:] = 0.0
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in c.items()}
    other = t["other"].to(dtype)
    before = TOPS.precision_accum.launches
    lam, eta = TOPS.precision_accum(t["idx"], t["val"], t["mask"], other,
                                    1.7)
    torch.cuda.synchronize()
    assert TOPS.precision_accum.launches == before + 1
    lam_p, eta_p = TOPS.precision_accum(t["idx"].cpu(), t["val"].cpu(),
                                        t["mask"].cpu(), other.cpu(), 1.7)
    _close(lam.cpu(), lam_p)
    _close(eta.cpu(), eta_p)
    assert float(lam[:, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(32, 1024), (100, 2048)])
def test_cuda_kernel_never_materializes_the_gather(cuda_device, K, M):
    """The (B, N, M, K) gathered tensor never exists on the card: the peak
    allocation of a call stays near its outputs (the invariant the
    reference checks in test_kernels.py on its jaxpr), for the Gram kernel
    at K = 32 and at the paper's K = 100."""
    B, N, D = 2, 2048, 300
    g = torch.Generator(device=cuda_device).manual_seed(0)
    idx = torch.randint(0, D, (B, N, M), generator=g, device=cuda_device,
                        dtype=torch.int32)
    val = torch.randn((B, N, M), generator=g, device=cuda_device)
    mask = torch.ones((B, N, M), device=cuda_device)
    other = torch.randn((B, D, K), generator=g, device=cuda_device)
    live = TSP.row_live(mask)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lam, eta = TOPS.precision_accum(idx, val, mask, other, 1.0, live)
    torch.cuda.synchronize()
    out_bytes = lam.numel() * 4 + eta.numel() * 4
    gather_bytes = B * N * M * K * 4
    assert torch.cuda.max_memory_allocated() - base <= out_bytes + (1 << 20)
    assert gather_bytes > 16 * out_bytes
