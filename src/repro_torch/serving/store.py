"""Device-resident posterior store — a trained ``PPResult`` made servable
(port of ``repro.serving.store``).

``run_pp``'s aggregated posteriors live in PERMUTED row/col space (the
load-balancing permutation the partition applied); a store is those same
natural parameters gathered back to ORIGINAL user/item ids, plus the
derived moment summaries scoring needs (posterior means) and ``n_slots``
item-factor posterior samples for Thompson scoring. The build runs on the
result's device: only the permutation index vectors (host numpy) move.

Layout (all tensors on one device, original id space):

  U         RowGaussians (N, K) / (N, K, K)   user posterior, natural params
  V         RowGaussians (M, K) / (M, K, K)   item posterior
  U_mean    (N, K)      Λ⁻¹η via jittered Cholesky (matches the scoring path)
  V_mean    (M, K)
  V_samples (S, M, K)   slot s = one joint posterior draw of ALL item rows
  tau       ()          rating precision the fold-in conditional reuses

A Thompson request pairs a fresh user-factor draw with ONE slot (a
coherent item-matrix sample), so item-side uncertainty enters scoring
without per-request (M, K, K) sampling work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import to_device
from repro_torch.core import posterior as POST
from repro_torch.core.posterior import RowGaussians


# rows per batched eigh call: on the H100 cuSOLVER's batched eigensolver
# refused the 138,493 10 x 10 precisions of the MovieLens-20M users in one
# call (CUSOLVER_STATUS_INVALID_VALUE); the projection is row-local, so
# chunks change nothing
EIGH_ROWS = 1 << 14


def _project_pd(Lambda: torch.Tensor, rel_floor: float = 1e-4) -> torch.Tensor:
    """Project per-row precisions (N, K, K) onto the PD cone.

    The divide-away aggregation subtracts multiply-counted priors from
    SAMPLE-ESTIMATED per-block precisions; for weakly observed rows the
    estimation noise makes the difference indefinite, which would NaN
    every Cholesky in the serving path. Symmetrize, then clamp each
    eigenvalue to its MAGNITUDE, floored at ``rel_floor`` × the row's
    largest magnitude. The result does not depend on the eigenvectors'
    signs or order, which differ between LAPACK and cuSOLVER."""
    sym = (Lambda + Lambda.mT) / 2
    out = torch.empty_like(sym)
    for lo in range(0, sym.shape[0], EIGH_ROWS):
        ev, Q = torch.linalg.eigh(sym[lo:lo + EIGH_ROWS])
        mag = ev.abs()
        floor = torch.clamp(rel_floor * mag.amax(-1, keepdim=True),
                            min=1e-6)
        out[lo:lo + EIGH_ROWS] = torch.einsum(
            "nik,nk,njk->nij", Q, torch.maximum(mag, floor), Q)
    return out


def _posterior_mean(g: RowGaussians, jitter: float) -> torch.Tensor:
    """μ = (Λ + jitter·I)⁻¹ η via Cholesky — the same factor and solve as
    the scoring path and ``sample_rows_noise``. ``POST.cholesky`` is NaN
    where Λ is not PD and never raises (nor waits for the device)."""
    K = g.eta.shape[-1]
    eye = torch.eye(K, dtype=g.Lambda.dtype, device=g.Lambda.device)
    L = POST.cholesky(g.Lambda + jitter * eye)
    return torch.cholesky_solve(g.eta[..., None], L)[..., 0]


class PosteriorStore(NamedTuple):
    U: RowGaussians            # (N, K) / (N, K, K), original user ids
    V: RowGaussians            # (M, K) / (M, K, K), original item ids
    U_mean: torch.Tensor       # (N, K)
    V_mean: torch.Tensor       # (M, K)
    V_samples: torch.Tensor    # (S, M, K)
    tau: torch.Tensor          # () f32

    @property
    def n_users(self) -> int:
        return self.U_mean.shape[0]

    @property
    def n_items(self) -> int:
        return self.V_mean.shape[0]

    @property
    def K(self) -> int:
        return self.V_mean.shape[-1]

    @property
    def n_slots(self) -> int:
        return self.V_samples.shape[0]

    @classmethod
    def from_pp_result(cls, res, seed: int = 0, n_slots: int = 8,
                       jitter: float = 1e-6,
                       generator: Optional[torch.Generator] = None
                       ) -> "PosteriorStore":
        """Build a store from any executor's ``PPResult``, on the device of
        its aggregated posteriors.

        The result must carry the serving seam (``row_perm``/``col_perm``/
        ``tau``, populated by ``engine.run_phase_graph``). The item-slot
        noise comes from ``generator`` (a ``torch.Generator`` on the
        store's device), or from one seeded with ``seed``."""
        if res.row_perm is None or res.col_perm is None or res.tau is None:
            raise ValueError(
                "PPResult lacks the serving export seam (row_perm/col_perm/"
                "tau are None) — re-run training with the current engine; "
                "pre-seam checkpointed results cannot be served")
        dev = res.V_agg.eta.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        M, K = res.V_agg.eta.shape
        z = torch.randn((int(n_slots), M, K), generator=generator,
                        device=dev)
        return _build_store(res.U_agg, res.V_agg,
                            to_device(res.row_perm.astype("int64"), dev),
                            to_device(res.col_perm.astype("int64"), dev),
                            torch.full((), float(res.tau), device=dev), z,
                            jitter=float(jitter))


def _build_store(U_agg: RowGaussians, V_agg: RowGaussians, row_perm,
                 col_perm, tau, z_slots: torch.Tensor,
                 jitter: float) -> PosteriorStore:
    """``z_slots`` (S, M, K): the standard normals of the S item-slot draws,
    in original item order."""
    # perm maps original id -> permuted position, so the ORIGINAL-space
    # posteriors are one device gather per factor side; precisions are
    # PD-projected so every downstream Cholesky is well-defined
    U = RowGaussians(eta=U_agg.eta[row_perm],
                     Lambda=_project_pd(U_agg.Lambda[row_perm]))
    V = RowGaussians(eta=V_agg.eta[col_perm],
                     Lambda=_project_pd(V_agg.Lambda[col_perm]))
    # one Cholesky of V serves every slot (z broadcasts over it)
    V_samples = POST.sample_rows_noise(V, z_slots, jitter=jitter)
    return PosteriorStore(U=U, V=V,
                          U_mean=_posterior_mean(U, jitter),
                          V_mean=_posterior_mean(V, jitter),
                          V_samples=V_samples, tau=tau)


def abstract_store(n_users: int, n_items: int, K: int,
                   n_slots: int) -> PosteriorStore:
    """A shape-only store (tensors on the ``meta`` device): lets a
    ``MicroBatchRouter`` build its bucket plan without training anything
    (the router only reads n_items/K from the store)."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return PosteriorStore(
        U=RowGaussians(eta=t(n_users, K), Lambda=t(n_users, K, K)),
        V=RowGaussians(eta=t(n_items, K), Lambda=t(n_items, K, K)),
        U_mean=t(n_users, K), V_mean=t(n_items, K),
        V_samples=t(n_slots, n_items, K), tau=t())
