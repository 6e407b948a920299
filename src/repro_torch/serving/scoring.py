"""Batched top-K scoring over a ``PosteriorStore`` (port of
``repro.serving.scoring``).

One call per fixed-shape request batch: gather user posterior rows →
fold-in conditional over in-request feedback → score against the item
factors → mask seen items → top-k. Two modes share everything up to the
score matrix:

  mean      μ_u = (Λ_u + jitter·I)⁻¹ η_u, scores = μ_u @ V_meanᵀ — exact
            posterior-mean ranking, deterministic (reads no draw).
  thompson  u = μ_u + L_u⁻ᵀ z per request (z ~ N(0, I) supplied in the
            batch), scored against ONE stored item-posterior sample slot
            (also in the batch) — Thompson sampling over the joint
            posterior.

Fold-in conditional: for feedback (j, r) supplied with the request, the
user row's conditional posterior given the trained item means is the
conjugate update

    Λ ← Λ + τ Σ_f m_f v_f v_fᵀ        η ← η + τ Σ_f m_f r_f v_f

— the likelihood form of the Gibbs sweep, so a cold-start request
(user_id < 0, identity prior) folded over its history approximates the
trained row.

The reference derives each request's draws from a PRNG key inside its
jitted call; here a ``RequestBatch`` carries the draws themselves (``z``
and ``slot``), made on the host by the router's seeded generator, so a
warm call never reads anything back from the device. Seen items are set
to -inf in a (B, M + 1) score buffer whose last column takes the padded
seen slots and is dropped (the reference's out-of-bounds scatter-drop):
no (B, M) mask is formed. The top-k is a stable descending sort, so among
equal scores the lowest item id wins, as ``lax.top_k`` does (the -inf
tail included); ``torch.topk`` promises no order among ties.

Item and user ids must lie in range: unlike the reference's gathers and
scatters, torch's raise on the host and assert on the device for an id
out of range. The router checks them on the host.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import posterior as POST
from repro_torch.core.posterior import RowGaussians
from repro_torch.serving.store import (PosteriorStore, _build_store,
                                       _posterior_mean)

MODES = ("mean", "thompson")


class RequestBatch(NamedTuple):
    """One fixed-shape scoring batch. Pad rows with user_id = -1 and
    all-zero masks; pad slots in seen/fold lists with mask 0."""
    user_ids: torch.Tensor   # (B,)   int, -1 = cold-start (identity prior)
    seen_idx: torch.Tensor   # (B, L) int item ids to exclude from top-K
    seen_mask: torch.Tensor  # (B, L) f32 1 = real, 0 = padding
    fold_idx: torch.Tensor   # (B, F) int fold-in feedback item ids
    fold_val: torch.Tensor   # (B, F) f32 fold-in ratings
    fold_mask: torch.Tensor  # (B, F) f32
    z: torch.Tensor          # (B, K) f32 standard normals (thompson)
    slot: torch.Tensor       # (B,)   int item sample slot (thompson)


class TopK(NamedTuple):
    ids: torch.Tensor        # (B, k) int32 item ids, best first
    scores: torch.Tensor     # (B, k) f32, -inf on invalid slots
    valid: torch.Tensor      # (B, k) bool — False when < k scorable items


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for an int tensor ``ids`` of any shape."""
    flat = table.index_select(0, ids.reshape(-1).long())
    return flat.reshape(ids.shape + table.shape[1:])


def _fold_in(g: RowGaussians, batch: RequestBatch, V_mean, tau):
    """Conjugate per-request conditional update against fixed item means."""
    v = _rows(V_mean, batch.fold_idx)                        # (B, F, K)
    m = batch.fold_mask
    Lam = g.Lambda + tau * torch.einsum("bf,bfk,bfl->bkl", m, v, v)
    eta = g.eta + tau * torch.einsum("bf,bf,bfk->bk", m, batch.fold_val, v)
    return RowGaussians(eta=eta, Lambda=Lam)


def score_topk(store: PosteriorStore, batch: RequestBatch, k: int,
               mode: str = "mean", jitter: float = 1e-6) -> TopK:
    if mode not in MODES:
        raise ValueError(f"unknown scoring mode {mode!r} (expected {MODES})")
    B = batch.user_ids.shape[0]
    M, K = store.V_mean.shape

    cold = batch.user_ids < 0
    uid = torch.where(cold, 0, batch.user_ids)
    eye = torch.eye(K, dtype=store.U.Lambda.dtype, device=cold.device)
    g = RowGaussians(
        eta=torch.where(cold[:, None], 0.0, _rows(store.U.eta, uid)),
        Lambda=torch.where(cold[:, None, None], eye,
                           _rows(store.U.Lambda, uid)))
    g = _fold_in(g, batch, store.V_mean, store.tau)

    if mode == "mean":
        mu = _posterior_mean(g, jitter)                      # (B, K)
        scores = mu @ store.V_mean.T                         # (B, M)
    else:
        u = POST.sample_rows_noise(g, batch.z, jitter=jitter)  # (B, K)
        scores = torch.einsum("bk,bmk->bm", u,
                              _rows(store.V_samples, batch.slot))

    # seen masking: padded slots go to the extra column M, dropped after
    seen_col = torch.where(batch.seen_mask > 0, batch.seen_idx.long(), M)
    scores = torch.nn.functional.pad(scores, (0, 1))
    scores = scores.scatter_(1, seen_col, float("-inf"))[:, :M]

    # stable: among equal scores the lowest index comes first
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return TopK(ids=idx.to(torch.int32), scores=vals,
                valid=vals > float("-inf"))


def scoring_budget(n_users: int, n_items: int, K: int, batch: int,
                   n_slots: int, slack: float = 2.0) -> int:
    """Largest buffer the scoring path legitimately holds: the store
    precision tensors (N·K² f32), the resident sample slots (S·M·K), or
    the per-batch gathered slots (B·M·K) — whichever is bigger, times
    ``slack`` for layout headroom. Scoring ALL users against all items at
    once (the dense N×M matrix) exceeds it at the lint dims."""
    store_side = max(n_users, n_items) * K * K
    slots = n_slots * n_items * K
    gathered = batch * n_items * K
    return int(slack * 4 * max(store_side, slots, gathered))


# ---------------------------------------------------------------------------
# static-analyzer hooks (launch.bmf_lint)
# ---------------------------------------------------------------------------


class TracedScoring(NamedTuple):
    """What the analyzer needs from one scoring call: every op it ran
    (``analysis.optrace.OpRecord``)."""
    ops: List


def trace_scoring(n_users: int, n_items: int, K: int, batch: int,
                  n_seen: int, n_fold: int, n_slots: int, k: int,
                  mode: str, *, device=None) -> TracedScoring:
    """Run ``score_topk`` once for one shape bucket on a seeded random
    store and request batch (cold starts and padding slots included),
    under the op recorder — the serving analogue of
    ``gibbs.trace_chain``."""
    from repro_torch.analysis import optrace as OPT
    from repro_torch.core.gibbs import lint_prior
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    store = _build_store(lint_prior(rng, (n_users,), K, dev),
                         lint_prior(rng, (n_items,), K, dev),
                         t(np.arange(n_users), np.int64),
                         t(np.arange(n_items), np.int64),
                         torch.full((), 2.0, device=dev),
                         t(rng.normal(size=(n_slots, n_items, K))),
                         jitter=1e-6)
    uid = rng.integers(-1, n_users, batch)
    reqs = RequestBatch(
        user_ids=t(uid, np.int32),
        seen_idx=t(rng.integers(0, n_items, (batch, n_seen)), np.int32),
        seen_mask=t(rng.random((batch, n_seen)) < 0.7),
        fold_idx=t(rng.integers(0, n_items, (batch, n_fold)), np.int32),
        fold_val=t(rng.normal(size=(batch, n_fold))),
        fold_mask=t(rng.random((batch, n_fold)) < 0.5),
        z=t(rng.normal(size=(batch, K))),
        slot=t(rng.integers(0, n_slots, batch), np.int32))
    with OPT.record() as tr:
        score_topk(store, reqs, k=k, mode=mode)
    return TracedScoring(ops=tr.ops)
