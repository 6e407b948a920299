"""CCD++ coordinate descent MF (Yu et al. 2012, ref [18]; port of
``repro.baselines.ccd``).

Updates one latent dimension at a time across all rows, using the padded-CSR
residual formulation: for dimension k,

    u_nk <- ( Σ_d m_nd (r*_nd) v_dk ) / (reg + Σ_d m_nd v_dk²)

where r* is the residual excluding dimension k's current contribution.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.baselines.als import center, global_mean, init_factors
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.data.sparse import PaddedCSR

# elements of one row stripe's gathered (rows, M, K) factor tensor (1 GiB
# f32): the update is row-local, so stripes bound memory and change nothing
STRIPE_ELEMS = 1 << 28


class CCDConfig(NamedTuple):
    K: int = 16
    reg: float = 2.0
    n_iters: int = 10            # outer passes over all K dims


def _update_dim(csr: PaddedCSR, X, other, k, reg):
    """One coordinate update of X[:, k] given the other factor, in place."""
    N, M = csr.idx.shape
    K = other.shape[-1]
    ns = max(1, STRIPE_ELEMS // max(M * K, 1))
    for lo in range(0, N, ns):
        hi = min(lo + ns, N)
        idx = csr.idx[lo:hi]
        Vg = other.index_select(0, idx.reshape(-1).long()).reshape(
            hi - lo, M, K)                                # (n, M, K)
        Xs = X[lo:hi]
        pred = torch.einsum("nmk,nk->nm", Vg, Xs)          # full prediction
        vk = Vg[..., k]
        resid_k = csr.val[lo:hi] - pred + Xs[:, k][:, None] * vk
        mask = csr.mask[lo:hi]
        num = torch.sum(mask * resid_k * vk, dim=1)
        den = reg + torch.sum(mask * vk ** 2, dim=1)
        X[lo:hi, k] = num / den
    return X


def run_ccd(noise, csr_rows: PaddedCSR, csr_cols: PaddedCSR,
            test_rows, test_cols, cfg: CCDConfig, device=None):
    """Returns (U, V, predictions of the test entries). Runs on ``device``
    (default: the GPU)."""
    dev = resolve_device(device)
    rows, cols = GIBBS._csr_to(csr_rows, dev), GIBBS._csr_to(csr_cols, dev)
    U, V = init_factors(noise, rows.n_rows, cols.n_rows, cfg.K, dev,
                        scale=0.3)
    mean = global_mean(rows)
    rows, cols = center(rows, mean), center(cols, mean)
    for _ in range(cfg.n_iters):
        for k in range(cfg.K):
            U = _update_dim(rows, U, V, k, cfg.reg)
            V = _update_dim(cols, V, U, k, cfg.reg)
    pred = BMF.predict(U, V, GIBBS._to(test_rows, dev),
                       GIBBS._to(test_cols, dev)) + mean
    return U, V, pred
