"""Alternating Least Squares MF baseline (Koren et al. 2009, ref [14];
port of ``repro.baselines.als``).

Same padded-CSR data path as the Gibbs sampler; each half-iteration solves
the ridge-regularized normal equations per row — the BMF conditional mode
instead of a posterior draw — so it shares ``bmf.sufficient_stats``:
``use_kernel=True`` runs kernel B1 there, on one padded CSR of the whole
matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.data.sparse import PaddedCSR


class ALSConfig(NamedTuple):
    K: int = 16
    reg: float = 2.0
    n_iters: int = 20
    use_kernel: bool = False


def solve_factor(csr: PaddedCSR, other: torch.Tensor, reg: float,
                 use_kernel: bool = False) -> torch.Tensor:
    Lam, eta = BMF.sufficient_stats(csr, other, tau=1.0, use_kernel=use_kernel)
    K = other.shape[-1]
    Lam = Lam + reg * torch.eye(K, dtype=Lam.dtype, device=Lam.device)
    # solve_ex: no error check, so no wait for the device (Λ + reg·I ≻ 0)
    return torch.linalg.solve_ex(Lam, eta[..., None])[0][..., 0]


def center(csr: PaddedCSR, mean: torch.Tensor) -> PaddedCSR:
    """The planes with ``mean`` taken from every live rating."""
    return PaddedCSR(idx=csr.idx, val=(csr.val - mean) * csr.mask,
                     mask=csr.mask, n_cols=csr.n_cols)


def global_mean(csr: PaddedCSR) -> torch.Tensor:
    return (csr.val * csr.mask).sum() / torch.clamp(csr.mask.sum(), min=1.0)


def init_factors(noise, N: int, D: int, K: int, dev, scale: float = 0.1):
    """``bmf.init_factors`` for one chain: (N, K), (D, K). ``noise``: an
    int seed or a batch-1 noise source (a tape replays the reference's
    key split)."""
    U, V = BMF.init_factors(GIBBS.as_noise(noise, 1, dev), N, D, K, scale)
    return U[0].to(dev), V[0].to(dev)


def run_als(noise, csr_rows: PaddedCSR, csr_cols: PaddedCSR,
            test_rows, test_cols, cfg: ALSConfig, device=None):
    """Returns (U, V, predictions of the test entries). Runs on ``device``
    (default: the GPU)."""
    dev = resolve_device(device)
    rows, cols = GIBBS._csr_to(csr_rows, dev), GIBBS._csr_to(csr_cols, dev)
    U, V = init_factors(noise, rows.n_rows, cols.n_rows, cfg.K, dev)
    # global-mean centering (standard ALS practice; BMF handles the mean
    # through the adaptive NW hyperprior instead)
    mean = global_mean(rows)
    rows_c, cols_c = center(rows, mean), center(cols, mean)
    for _ in range(cfg.n_iters):
        U = solve_factor(rows_c, V, cfg.reg, cfg.use_kernel)
        V = solve_factor(cols_c, U, cfg.reg, cfg.use_kernel)
    pred = BMF.predict(U, V, GIBBS._to(test_rows, dev),
                       GIBBS._to(test_cols, dev)) + mean
    return U, V, pred
