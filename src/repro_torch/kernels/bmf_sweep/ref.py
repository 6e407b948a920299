"""Plain PyTorch version of the fused Gibbs sweep (port of the tile math of
``repro/kernels/bmf_sweep``: ``accum_tile``, ``sample_tile`` and the
striped ``sweep_ref_padded``).

It consumes the same padded planes as the kernel: rows are processed a
stripe at a time and each stripe's M axis a tile at a time, so no
(N, M, K) tensor of the whole plane exists, and the (N, K, K) precision
exists only per stripe. The factor step is ``posterior.sample_rows_noise``
written out: A = Λ + Λ_prior + jitter·I = LLᵀ, μ = L⁻ᵀL⁻¹(η + η_prior),
u = μ + L⁻ᵀz. bf16 factors are widened to f32 after the gather.
"""
from __future__ import annotations

import torch

from repro_torch.core.posterior import cholesky
from repro_torch.kernels.bmf_precision.ref import STRIPE_ELEMS, gather_rows

TM = 256          # slots per M-tile, as the reference's tile


def accum_tile(lam, eta, v, w, r, tau: float):
    """Fold one M-tile of gathered factor rows v (…, tm, K) with mask w and
    ratings r (…, tm) into the (Λ, η) accumulators."""
    v = v.float()
    vm = v * w[..., None]
    lam = lam + tau * (vm.mT @ v)
    eta = eta + tau * ((r * w)[..., None, :] @ v)[..., 0, :]
    return lam, eta


def sample_tile(lam, eta, prior_lam, prior_eta, z, jitter: float):
    """Add the prior, factor, and draw: u = Λ⁻¹η + L⁻ᵀz."""
    K = eta.shape[-1]
    eye = torch.eye(K, dtype=lam.dtype, device=lam.device)
    L = cholesky(lam + prior_lam + jitter * eye)
    b = (eta + prior_eta)[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    mu = torch.linalg.solve_triangular(L.mT, y, upper=True)
    delta = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)
    return (mu + delta)[..., 0]


def stripe_rows(B: int, M: int, K: int) -> int:
    """Rows of one stripe of ``sweep_ref_padded`` (its cost per stripe
    depends on nothing else)."""
    return max(1, STRIPE_ELEMS // max(B * min(M, TM) * K, 1))


def sweep_ref_padded(idx, val, mask, prior_eta, prior_lam, z, other,
                     tau: float, *, jitter: float = 1e-6, live=None):
    """idx/val/mask (B, N, M); prior_eta/z (B, N, K); prior_lam (B, N, K, K);
    other (B, D, K) -> U (B, N, K). ``live`` (B, N) trims each stripe's
    M loop to its longest live row (dead slots add exact zeros)."""
    B, N, M = idx.shape
    K = other.shape[-1]
    U = torch.empty((B, N, K), dtype=torch.float32, device=idx.device)
    ns = stripe_rows(B, M, K)
    for lo in range(0, N, ns):
        hi = min(lo + ns, N)
        m_end = M if live is None else int(live[:, lo:hi].max())
        lam = torch.zeros((B, hi - lo, K, K), dtype=torch.float32,
                          device=idx.device)
        eta = torch.zeros((B, hi - lo, K), dtype=torch.float32,
                          device=idx.device)
        for m0 in range(0, m_end, TM):
            m1 = min(m0 + TM, M)
            v = gather_rows(other, idx[:, lo:hi, m0:m1].contiguous())
            lam, eta = accum_tile(lam, eta, v, mask[:, lo:hi, m0:m1],
                                  val[:, lo:hi, m0:m1], tau)
        U[:, lo:hi] = sample_tile(lam, eta, prior_lam[:, lo:hi],
                                  prior_eta[:, lo:hi], z[:, lo:hi], jitter)
    return U
