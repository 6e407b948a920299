"""Gaussian posterior algebra in natural parameters + Wishart sampling
(port of ``repro.core.posterior``).

Posterior Propagation combines per-row Gaussian posteriors multiplicatively
and divides away multiply-counted priors. In natural parameters
(eta = Λ μ, Λ = precision) both operations are additions/subtractions:

    N(μ1,Λ1⁻¹)·N(μ2,Λ2⁻¹) ∝ N(Λ⁻¹η, Λ⁻¹),  Λ = Λ1+Λ2, η = η1+η2
    N1 / N2               ->  Λ = Λ1-Λ2, η = η1-η2   (valid if Λ ≻ 0)

All functions are batched over leading axes: mu (..., N, K), Lambda
(..., N, K, K). Every random draw comes from an explicit
``torch.Generator`` or is passed in by the caller (the ``*_noise``
variants), never from the global RNG.

A Cholesky of a matrix that is not positive definite yields NaN, as
``jnp.linalg.cholesky`` does — never an exception: the chain-health guard
of ``core.engine`` detects a bad chain by its non-finite outputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RowGaussians(NamedTuple):
    """Per-row Gaussian beliefs over factor rows. eta = Λ μ."""
    eta: torch.Tensor      # (..., N, K)
    Lambda: torch.Tensor   # (..., N, K, K)

    @property
    def mean(self):
        return torch.cholesky_solve(self.eta[..., None],
                                    cholesky(self.Lambda))[..., 0]

    @property
    def cov(self):
        return _chol_inverse(cholesky(self.Lambda))

    def to(self, device) -> "RowGaussians":
        """The same rows on ``device`` (no copy where they lie there): how
        a posterior reaches a group on another device as its prior."""
        return RowGaussians(eta=self.eta.to(device, non_blocking=True),
                            Lambda=self.Lambda.to(device, non_blocking=True))


def _eye(K: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(K, dtype=like.dtype, device=like.device)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN-filled where A is not positive definite
    (``cholesky_ex`` reports failure in ``info`` instead of raising)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """inv(L Lᵀ) via triangular solves on the factor — no explicit
    inverse."""
    eye = _eye(L.shape[-1], L).expand(L.shape)
    return torch.cholesky_solve(eye, L)


def from_moments(mu, Lambda) -> RowGaussians:
    return RowGaussians(eta=(Lambda @ mu[..., None])[..., 0], Lambda=Lambda)


def from_moments_cov(mu, cov, ridge: float = 0.0) -> RowGaussians:
    """Natural params from (mean, COVARIANCE) moments via one Cholesky
    factor: η = Σ⁻¹μ and Λ = Σ⁻¹ share it."""
    if ridge:
        cov = cov + ridge * _eye(mu.shape[-1], cov)
    L = cholesky(cov)
    eta = torch.cholesky_solve(mu[..., None], L)[..., 0]
    return RowGaussians(eta=eta, Lambda=_chol_inverse(L))


def broadcast_prior(mu, Lambda, n_rows: int) -> RowGaussians:
    """Shared prior (mu (..., K), Lambda (..., K, K)) -> per-row natural
    params (..., n_rows, K) / (..., n_rows, K, K). Λ is an expanded view
    (stride 0 along rows); callers that need contiguous memory copy it."""
    K = mu.shape[-1]
    eta = (Lambda @ mu[..., None])[..., 0]
    eta = eta[..., None, :].expand(*eta.shape[:-1], n_rows, K)
    Lam = Lambda[..., None, :, :].expand(*Lambda.shape[:-2], n_rows, K, K)
    return RowGaussians(eta=eta, Lambda=Lam)


def product(a: RowGaussians, b: RowGaussians) -> RowGaussians:
    return RowGaussians(eta=a.eta + b.eta, Lambda=a.Lambda + b.Lambda)


def divide(a: RowGaussians, b: RowGaussians) -> RowGaussians:
    return RowGaussians(eta=a.eta - b.eta, Lambda=a.Lambda - b.Lambda)


def scale(a: RowGaussians, c: float) -> RowGaussians:
    return RowGaussians(eta=c * a.eta, Lambda=c * a.Lambda)


def from_samples(samples, ridge: float = 1e-4) -> RowGaussians:
    """Summarize MCMC draws (T, N, K) as per-row Gaussians: precision =
    inv(sample covariance + ridge·I)."""
    T = samples.shape[0]
    mean = samples.mean(0)
    centered = samples - mean
    cov = torch.einsum("tnk,tnl->nkl", centered, centered) / max(T - 1, 1)
    return from_moments_cov(mean, cov, ridge=ridge)


def sample_rows_noise(g: RowGaussians, z: torch.Tensor,
                      jitter: float = 1e-6) -> torch.Tensor:
    """One draw per row, x_n ~ N(Λ_n⁻¹ η_n, Λ_n⁻¹), with the standard
    normal ``z`` (..., N, K) supplied by the caller: x = Λ⁻¹η + L⁻ᵀz."""
    K = g.eta.shape[-1]
    L = cholesky(g.Lambda + jitter * _eye(K, g.Lambda))
    mu = torch.cholesky_solve(g.eta[..., None], L)[..., 0]
    delta = torch.linalg.solve_triangular(L.mT, z[..., None],
                                          upper=True)[..., 0]
    return mu + delta


def sample_rows(gen: torch.Generator, g: RowGaussians,
                jitter: float = 1e-6) -> torch.Tensor:
    z = torch.randn(g.eta.shape, generator=gen, dtype=g.eta.dtype,
                    device=g.eta.device)
    return sample_rows_noise(g, z, jitter)


# ---------------------------------------------------------------------------
# Wishart / Normal-Wishart (BPMF hyperpriors)
# ---------------------------------------------------------------------------


class NormalWishart(NamedTuple):
    mu0: torch.Tensor      # (..., K)
    beta0: torch.Tensor    # (...) scalar(s)
    W0: torch.Tensor       # (..., K, K) scale matrix
    nu0: torch.Tensor      # (...) degrees of freedom (> K-1)


def default_nw(K: int, device=None, dtype=torch.float32) -> NormalWishart:
    # scalars by ``full``, a fill on the device: ``torch.tensor`` would
    # copy from the host and wait for the device's queue to drain
    return NormalWishart(
        mu0=torch.zeros((K,), dtype=dtype, device=device),
        beta0=torch.full((), 2.0, dtype=dtype, device=device),
        W0=torch.eye(K, dtype=dtype, device=device),
        nu0=torch.full((), float(K), dtype=dtype, device=device),
    )


# candidates drawn per gamma variate: Marsaglia-Tsang accepts each with
# probability > 0.95 for shape >= 1, so all 16 fail with probability
# < 1e-20; such a variate is NaN and the chain-health guard catches it
_GAMMA_CANDIDATES = 16


def standard_gamma(gen: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws from an explicit generator (Marsaglia & Tsang
    2000, with the U^(1/alpha) boost for alpha < 1). Vectorized with a
    fixed candidate count, so it never waits on the device."""
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    shape = (_GAMMA_CANDIDATES,) + tuple(alpha.shape)
    x = torch.randn(shape, generator=gen, dtype=alpha.dtype,
                    device=alpha.device)
    u = torch.rand(shape, generator=gen, dtype=alpha.dtype,
                   device=alpha.device)
    v = (1 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = ok.to(torch.int8).argmax(dim=0, keepdim=True)
    g = torch.gather(d * v, 0, first)[0]
    g = torch.where(ok.any(dim=0), g, float("nan"))
    ub = torch.rand(alpha.shape, generator=gen, dtype=alpha.dtype,
                    device=alpha.device)
    return torch.where(boost, g * ub ** (1.0 / alpha), g)


def chi2(gen: torch.Generator, df: torch.Tensor) -> torch.Tensor:
    """χ²(df) = 2·Gamma(df/2)."""
    return 2.0 * standard_gamma(gen, df / 2.0)


def wishart_df(nu, K: int) -> torch.Tensor:
    """Degrees of freedom of the Bartlett diagonal: χ²(ν − i), i < K."""
    nu = torch.as_tensor(nu)
    i = torch.arange(K, dtype=nu.dtype, device=nu.device)
    return nu[..., None] - i


def sample_wishart_noise(W: torch.Tensor, chi2_diag: torch.Tensor,
                         lower: torch.Tensor) -> torch.Tensor:
    """Bartlett decomposition with caller-supplied draws: X ~ W_K(W, ν)
    given chi2_diag (..., K) ~ χ²(ν − i) and lower (..., K, K) standard
    normals (only the strictly-lower triangle is used)."""
    K = W.shape[-1]
    A = torch.diag_embed(torch.sqrt(chi2_diag)) + torch.tril(lower, -1)
    L = cholesky(W + 1e-6 * _eye(K, W))
    LA = L @ A
    return LA @ LA.mT


def sample_wishart(gen: torch.Generator, W: torch.Tensor, nu) -> torch.Tensor:
    K = W.shape[-1]
    c = chi2(gen, wishart_df(torch.as_tensor(nu, dtype=W.dtype,
                                             device=W.device), K))
    lower = torch.randn(W.shape, generator=gen, dtype=W.dtype,
                        device=W.device)
    return sample_wishart_noise(W, c, lower)


def nw_posterior(prior: NormalWishart, X: torch.Tensor) -> NormalWishart:
    """Conjugate NW update given rows X (..., N, K)."""
    N = X.shape[-2]
    xbar = X.mean(-2)
    Xc = X - xbar[..., None, :]
    S = Xc.mT @ Xc                                     # N * sample cov
    beta_n = prior.beta0 + N
    nu_n = prior.nu0 + N
    mu_n = (prior.beta0[..., None] * prior.mu0 + N * xbar) / beta_n[..., None]
    d = (xbar - prior.mu0)[..., :, None]
    W0_inv = _chol_inverse(cholesky(prior.W0))
    Wn_inv = (W0_inv + S
              + (prior.beta0 * N / beta_n)[..., None, None] * (d @ d.mT))
    Wn = _chol_inverse(cholesky(Wn_inv))
    return NormalWishart(mu0=mu_n, beta0=beta_n, W0=Wn, nu0=nu_n)


def sample_nw_noise(nw: NormalWishart, chi2_diag: torch.Tensor,
                    lower: torch.Tensor, z: torch.Tensor):
    """(mu, Lambda) ~ NW from caller-supplied draws: the Wishart's
    (chi2_diag, lower) and the mean's standard normal z (..., K)."""
    Lam = sample_wishart_noise(nw.W0, chi2_diag, lower)
    K = Lam.shape[-1]
    # mu ~ N(mu0, (β Λ)⁻¹): with βΛ = L Lᵀ, x = L⁻ᵀ z has that covariance
    L = cholesky(nw.beta0[..., None, None] * Lam + 1e-6 * _eye(K, Lam))
    mu = nw.mu0 + torch.linalg.solve_triangular(L.mT, z[..., None],
                                                upper=True)[..., 0]
    return mu, Lam


def sample_nw(gen: torch.Generator, nw: NormalWishart):
    """Draw (mu, Lambda) ~ NW."""
    K = nw.W0.shape[-1]
    c = chi2(gen, wishart_df(nw.nu0, K))
    lower = torch.randn(nw.W0.shape, generator=gen, dtype=nw.W0.dtype,
                        device=nw.W0.device)
    z = torch.randn(nw.mu0.shape, generator=gen, dtype=nw.mu0.dtype,
                    device=nw.mu0.device)
    return sample_nw_noise(nw, c, lower, z)
