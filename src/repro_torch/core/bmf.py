"""Bayesian Probabilistic Matrix Factorization (Salakhutdinov & Mnih 2008)
(port of ``repro.core.bmf``).

Model:
    r_nd ~ N(u_nᵀ v_d, τ⁻¹)                   observed entries only
    u_n  ~ N(μ_U, Λ_U⁻¹),  (μ_U, Λ_U) ~ NW    (likewise for v_d)

Gibbs conditionals per row (the compute hot-spot, kernel B1):
    Λ_n = Λ_prior_n + τ Σ_{d∈Ω_n} v_d v_dᵀ
    η_n = η_prior_n + τ Σ_{d∈Ω_n} r_nd v_d
    u_n ~ N(Λ_n⁻¹ η_n, Λ_n⁻¹)

Every function takes optional leading block axes: planes (…, N, M),
factors (…, N, K). Random draws are passed in (``z``, the NW draws), so a
chain's noise comes only from its noise source (``repro_torch.noise``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import posterior as POST
from repro_torch.core.posterior import NormalWishart, RowGaussians
from repro_torch.data.sparse import PaddedCSR
from repro_torch.kernels.bmf_precision.ref import (gather_rows,
                                                   precision_accum_ref)


class BMFConfig(NamedTuple):
    K: int = 16
    tau: float = 2.0              # residual precision (paper: fixed alpha=2)
    n_samples: int = 60
    burnin: int = 20
    use_kernel: bool = False      # B1 bmf_precision kernel vs dense torch
    # shorter chains for PP phases b/c (None = same n_samples everywhere)
    phase_bc_samples: Optional[int] = None
    # one-kernel Gibbs sweep (kernel B2): the whole factor step — gather,
    # Λ/η accumulate, Cholesky, triangular solves, noise add — in one pass.
    # sweep_dtype: 'fp32', or 'bf16' (bf16 gather/accumulate, f32
    # factorization).
    sweep_fused: bool = False
    sweep_dtype: str = "fp32"


def sufficient_stats(csr: PaddedCSR, other: torch.Tensor, tau: float,
                     use_kernel: bool = False, live=None):
    """Per-row likelihood contributions (Λ_contrib (…, N, K, K), η_contrib
    (…, N, K)). The dense path gathers the whole (…, N, M, K) tensor;
    ``use_kernel=True`` routes through kernel B1, which gathers inside the
    kernel and skips each row's padded tail (``live``)."""
    if use_kernel:
        from repro_torch.kernels.bmf_precision import ops as KOPS
        return KOPS.precision_accum(csr.idx, csr.val, csr.mask, other, tau,
                                    live)
    # one gather of f32 rows: an index broadcast to (…, N, M, K) would be
    # an int64 buffer twice the gathered plane
    lead, tail = csr.idx.shape[:-2], other.shape[-2:]
    V = gather_rows(other.expand(lead + tail).reshape((-1,) + tail),
                    csr.idx.reshape((-1,) + csr.idx.shape[-2:]))
    V = V.reshape(csr.idx.shape + tail[-1:])                     # (…,N,M,K)
    return precision_accum_ref(V, csr.val, csr.mask, tau)


def sample_factor(z: torch.Tensor, csr: PaddedCSR, other: torch.Tensor,
                  tau: float, prior: RowGaussians, use_kernel: bool = False,
                  live=None) -> torch.Tensor:
    """Draw all rows of one factor from their Gibbs conditional, given the
    standard-normal noise z (…, N, K)."""
    Lam_c, eta_c = sufficient_stats(csr, other, tau, use_kernel, live)
    cond = RowGaussians(eta=prior.eta + eta_c, Lambda=prior.Lambda + Lam_c)
    return POST.sample_rows_noise(cond, z)


def sample_hyper_noise(X: torch.Tensor, nw_prior: NormalWishart, chi2,
                       lower, z):
    """(μ, Λ) ~ NW posterior given current factor rows X (…, N, K), from
    the caller's draws (see ``posterior.sample_nw_noise``)."""
    return POST.sample_nw_noise(POST.nw_posterior(nw_prior, X), chi2, lower,
                                z)


def sample_hyper(gen: torch.Generator, X: torch.Tensor,
                 nw_prior: NormalWishart):
    return POST.sample_nw(gen, POST.nw_posterior(nw_prior, X))


def predict(U: torch.Tensor, V: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """Pointwise predictions for test entries (…, n_test)."""
    Ur = torch.take_along_dim(U, rows[..., None].long(), dim=-2)
    Vc = torch.take_along_dim(V, cols[..., None].long(), dim=-2)
    return (Ur * Vc).sum(-1)


def init_factors(noise, N: int, D: int, K: int, scale: float = 0.1):
    """Initial factors (B, N, K) / (B, D, K) from the noise source."""
    zu, zv = noise.init(N, D, K)
    return scale * zu, scale * zv
