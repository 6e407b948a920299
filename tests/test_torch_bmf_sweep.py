"""Kernel B2 (bmf_sweep): the port against the JAX reference.

On the CPU the port's wrapper runs its plain version; it is held against
the reference's striped-XLA path (``force="ref"``) at several shapes and
its Pallas kernel in interpret mode at one tiny shape, with the same z on
both sides. The ``cuda`` legs hold the CUDA kernel against the plain
version on the card.

Tolerances. fp32: 1e-5 relative to the largest draw — the reference's own
contract between its two sweep paths (``bmf_sweep/ref.py``); the two
packages sum, factor and solve in different orders. bf16: the same 1e-5 —
both sides round the other factor to bf16 identically, products of bf16
values are exact in f32, and everything after the gather is f32 on both
sides. Kernel vs plain on the card: 1e-4 — the kernel's right-looking
in-register Cholesky and its solves round in another order than
cuSOLVER's, and the conditional precision's condition number (up to ~1e2
here) amplifies that f32 rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import posterior as TPOST
from repro_torch.kernels.bmf_precision import ops as TPREC
from repro_torch.kernels.bmf_sweep import ops as TSWEEP
from torch_helpers import (assert_rel_close, bf16_round,  # noqa: F401
                           cuda_device, factor_case)

RTOL = 1e-5
CUDA_RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    assert_rel_close(got, want, rtol)


def _port(c, tau, dtype="fp32", device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
    return TSWEEP.fused_sweep(t["z"], t["idx"], t["val"], t["mask"], t["pe"],
                              t["pL"], t["other"], tau, dtype=dtype)


def _jax(c, tau, dtype="fp32", **kw):
    import jax.numpy as jnp
    from repro.kernels.bmf_sweep import ops as JSWEEP
    j = {k: jnp.asarray(v) for k, v in c.items()}
    return np.asarray(JSWEEP.fused_sweep(
        j["z"], j["idx"], j["val"], j["mask"], j["pe"], j["pL"], j["other"],
        tau, dtype=dtype, **kw))


@pytest.mark.parametrize("N,M,D,K", [(5, 17, 23, 8), (19, 40, 31, 12),
                                     (40, 300, 29, 10), (16, 64, 48, 32)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_reference_striped(N, M, D, K, dtype):
    rng = np.random.default_rng(3)
    c = factor_case(rng, N, M, D, K, empty_rows=(0, N - 1))
    U = _port(c, 1.7, dtype)
    assert U.shape == (N, K) and bool(torch.isfinite(U).all())
    _close(U, _jax(c, 1.7, dtype, force="ref"))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(3)
    c = factor_case(rng, 16, 300, 48, 8, empty_rows=(0, 15))
    _close(_port(c, 1.7, dtype),
           _jax(c, 1.7, dtype, force="pallas", interpret=True, n_stripe=16))


def test_empty_rows_reduce_to_prior_sample():
    """A row with no ratings samples from its prior conditional: the fused
    step equals sample_rows_noise on the bare prior, in both packages."""
    import jax.numpy as jnp
    from repro.core import posterior as JPOST
    rng = np.random.default_rng(5)
    c = factor_case(rng, 6, 20, 13, 8, empty_rows=(2,))
    U = _port(c, 1.3)
    want = TPOST.sample_rows_noise(
        TPOST.RowGaussians(eta=torch.from_numpy(c["pe"]),
                           Lambda=torch.from_numpy(c["pL"])),
        torch.from_numpy(c["z"]))
    _close(U[2], want[2])
    jwant = JPOST.sample_rows_noise(
        JPOST.RowGaussians(eta=jnp.asarray(c["pe"]),
                           Lambda=jnp.asarray(c["pL"])), jnp.asarray(c["z"]))
    _close(U[2], np.asarray(jwant)[2])


def test_leading_block_axis():
    rng = np.random.default_rng(9)
    c = factor_case(rng, 13, 50, 21, 10, empty_rows=(3,), B=3)
    U = _port(c, 2.0)
    for b in range(3):
        _close(U[b], _jax({k: v[b] for k, v in c.items()}, 2.0, force="ref"))


def test_large_k_route_matches_reference():
    """K > SWEEP_K_MAX: the reference leaves Pallas; the port takes B1 then
    torch linear algebra on the card, and its plain version on the CPU."""
    rng = np.random.default_rng(1)
    c = factor_case(rng, 7, 24, 19, 40, empty_rows=(1,))
    _close(_port(c, 2.0), _jax(c, 2.0, force="ref"))


def test_bf16_rounds_only_the_gathered_factor():
    """bf16 mode equals fp32 mode run on a bf16-rounded other factor."""
    rng = np.random.default_rng(4)
    c = factor_case(rng, 12, 30, 17, 10)
    c16 = dict(c, other=bf16_round(c["other"]))
    torch.testing.assert_close(_port(c, 1.5, "bf16"), _port(c16, 1.5),
                               rtol=1e-6, atol=1e-6)


def test_rejects_unknown_dtype():
    rng = np.random.default_rng(0)
    c = factor_case(rng, 4, 8, 5, 3)
    with pytest.raises(ValueError, match="sweep dtype"):
        _port(c, 1.0, "fp16")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 10, 16, 17, 32])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cuda_kernel_matches_plain(cuda_device, K, dtype):
    rng = np.random.default_rng(K)
    c = factor_case(rng, 37, 70, 29, K, empty_rows=(0, 36), B=3)
    c["mask"][:, 5:20, 40:] = 0.0
    before = TSWEEP.fused_sweep.launches
    U = _port(c, 1.7, dtype, device=cuda_device)
    torch.cuda.synchronize()
    assert TSWEEP.fused_sweep.launches == before + 1
    _close(U.cpu(), _port(c, 1.7, dtype), rtol=CUDA_RTOL)


@pytest.mark.cuda
def test_cuda_large_k_routes_through_b1(cuda_device):
    rng = np.random.default_rng(2)
    c = factor_case(rng, 21, 40, 19, 48, empty_rows=(0,), B=2)
    sweeps, accums = TSWEEP.fused_sweep.launches, TPREC.precision_accum.launches
    U = _port(c, 2.0, device=cuda_device)
    torch.cuda.synchronize()
    assert TSWEEP.fused_sweep.launches == sweeps
    assert TPREC.precision_accum.launches == accums + 1
    _close(U.cpu(), _port(c, 2.0), rtol=CUDA_RTOL)


@pytest.mark.cuda
def test_cuda_sweep_writes_only_the_sample(cuda_device):
    """Λ never reaches device memory: the peak allocation of a fused step
    is its (B, N, K) output, far below the (B, N, K, K) statistics."""
    from repro_torch.data.sparse import row_live
    rng = np.random.default_rng(0)
    c = factor_case(rng, 4096, 64, 97, 32, B=2)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in c.items()}
    live = row_live(t["mask"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    U = TSWEEP.fused_sweep(t["z"], t["idx"], t["val"], t["mask"], t["pe"],
                           t["pL"], t["other"], 2.0, live=live)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= U.numel() * 4 + (1 << 20)
