"""Micro-batching request plane for the scoring path (port of
``repro.serving.router``).

Requests arrive one at a time with ragged seen/fold lists; scoring wants
fixed shapes. The router closes the gap with a ladder of power-of-two
candidate shapes, coalesced through ``partition.coalesce_shapes`` under a
padded-footprint waste budget, so the whole ladder maps to a handful of
batch shapes (the plan).

Batching rule: a request waits at most ``latency_budget_s`` — a batch
dispatches as soon as it is full (``max_batch``) OR its oldest request's
wait exceeds the budget. ``poll(now)`` drives the clock (callers pass
``now`` explicitly in tests; wall-clock by default); ``flush`` force-
dispatches the tail.

The router is host-side and synchronous: its job is shape management and
latency accounting. A batch is padded in host numpy, its Thompson draws
(``z``, ``slot``) come from the router's seeded numpy generator, and it
moves to the store's device by non-blocking copies from pinned memory;
the ids, scores and valid flags come back in one copy, which waits for
the scoring call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core.partition import coalesce_shapes
from repro_torch.serving.scoring import MODES, RequestBatch, score_topk
from repro_torch.serving.store import PosteriorStore


@dataclass
class Request:
    """One recommendation request. ``seen`` items are excluded from the
    top-K; ``fold_items``/``fold_ratings`` are in-request feedback folded
    into the user's conditional posterior (cold-start: user_id = -1)."""
    user_id: int
    seen: Sequence[int] = ()
    fold_items: Sequence[int] = ()
    fold_ratings: Sequence[float] = ()


@dataclass
class Ticket:
    """Handle returned by ``submit``; filled in when its batch dispatches."""
    t_submit: float
    done: bool = False
    ids: Optional[np.ndarray] = None       # (k,)
    scores: Optional[np.ndarray] = None    # (k,)
    valid: Optional[np.ndarray] = None     # (k,)
    latency_s: float = 0.0


def _ladder(lo: int, hi: int) -> List[int]:
    """Power-of-two rungs lo..>=hi (plus hi itself)."""
    out, v = [], max(1, lo)
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return sorted(set(out))


@dataclass
class ScoringWorker:
    """One scoring endpoint: a store plus the (k, mode) it scores with."""
    store: PosteriorStore
    k: int
    mode: str

    def score(self, batch: RequestBatch):
        return score_topk(self.store, batch, k=self.k, mode=self.mode)


class MicroBatchRouter:
    """Coalesce requests into shape-bucketed fixed batches under a latency
    budget and dispatch them to scoring workers."""

    def __init__(self, store: PosteriorStore, k: int = 10,
                 mode: str = "mean", latency_budget_s: float = 0.005,
                 max_batch: int = 32, max_seen: int = 64, max_fold: int = 8,
                 max_waste: float = 1.5, n_workers: int = 1, seed: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown scoring mode {mode!r} "
                             f"(expected {MODES})")
        self.k, self.mode = int(k), mode
        self.latency_budget_s = float(latency_budget_s)
        self.max_batch, self.max_seen = int(max_batch), int(max_seen)
        self.max_fold = int(max_fold)
        self.workers = [ScoringWorker(store, self.k, mode)
                        for _ in range(max(1, n_workers))]
        self._next_worker = 0
        self._rng = np.random.default_rng(seed)
        self._queue: List[Tuple[Request, Ticket]] = []
        self._n_users, self._n_items = store.n_users, store.n_items
        self._K, self._n_slots = store.K, store.n_slots
        self._device = store.V_mean.device
        # per-request padded cost of one batch: the (M, K) score row /
        # gathered sample slot DOMINATES the seen/fold request-plane
        # arrays, so all (L, F) variants of a batch rung coalesce into one
        # shape, while batch rungs stay distinct (doubling B is 2x real
        # work, over a max_waste < 2 budget)
        self._req_cost = store.n_items * store.K
        cand = {(b, l, f): (b, l, f)
                for b in _ladder(1, self.max_batch)
                for l in _ladder(1, self.max_seen)
                for f in _ladder(1, self.max_fold)}
        self.bucket_table: Dict[Tuple[int, int, int], Tuple[int, int, int]] \
            = coalesce_shapes(cand, self._footprint, max_waste=max_waste)
        self.dispatches: List[Tuple[Tuple[int, int, int], int]] = []
        self.latencies_s: List[float] = []

    def _footprint(self, shape: Tuple[int, int, int]) -> float:
        b, l, f = shape
        return float(b * (l + f + self._req_cost))

    @property
    def plan_signatures(self) -> List[Tuple[int, int, int]]:
        """Distinct batch shapes the ladder coalesces to."""
        return sorted(set(self.bucket_table.values()))

    def bucket_for(self, n_reqs: int, n_seen: int, n_fold: int):
        """Smallest ladder rung >= each dim, then its coalesced shape."""
        def rung(v, hi):
            for r in _ladder(1, hi):
                if r >= v:
                    return r
            raise ValueError(f"request dim {v} exceeds router cap {hi}")
        return self.bucket_table[(rung(n_reqs, self.max_batch),
                                  rung(max(1, n_seen), self.max_seen),
                                  rung(max(1, n_fold), self.max_fold))]

    # -- request plane ------------------------------------------------------

    def _check_ids(self, req: Request):
        """Ids index the store on the device, where an id out of range is
        a device assert: check them here."""
        if req.user_id >= self._n_users:
            raise ValueError(f"user id {req.user_id} outside the store's "
                             f"{self._n_users} users (use -1 for cold start)")
        for name, ids in (("seen", req.seen), ("fold", req.fold_items)):
            if len(ids) and not (min(ids) >= 0
                                 and max(ids) < self._n_items):
                raise ValueError(f"{name} item ids outside "
                                 f"[0, {self._n_items})")

    def submit(self, req: Request, now: Optional[float] = None) -> Ticket:
        if len(req.seen) > self.max_seen:
            raise ValueError(f"seen list ({len(req.seen)}) exceeds "
                             f"max_seen={self.max_seen}")
        if len(req.fold_items) > self.max_fold:
            raise ValueError(f"fold list ({len(req.fold_items)}) exceeds "
                             f"max_fold={self.max_fold}")
        if len(req.fold_items) != len(req.fold_ratings):
            raise ValueError("fold_items and fold_ratings length mismatch")
        self._check_ids(req)
        t = Ticket(t_submit=time.monotonic() if now is None else now)
        self._queue.append((req, t))
        if len(self._queue) >= self.max_batch:
            self._dispatch(self._queue[:self.max_batch], now)
        return t

    def poll(self, now: Optional[float] = None) -> int:
        """Dispatch the pending batch iff its oldest request has waited
        past the latency budget. Returns requests dispatched."""
        now_eff = time.monotonic() if now is None else now
        if self._queue and \
                now_eff - self._queue[0][1].t_submit >= self.latency_budget_s:
            return self._dispatch(self._queue, now)
        return 0

    def flush(self, now: Optional[float] = None) -> int:
        """Force-dispatch everything pending (shutdown / bench tail)."""
        n = 0
        while self._queue:
            n += self._dispatch(self._queue[:self.max_batch], now)
        return n

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, pairs, now: Optional[float]) -> int:
        pairs = list(pairs)
        del self._queue[:len(pairs)]
        reqs = [r for r, _ in pairs]
        shape = self.bucket_for(
            len(reqs),
            max((len(r.seen) for r in reqs), default=0),
            max((len(r.fold_items) for r in reqs), default=0))
        out = self._worker().score(self._pad_batch(reqs, shape))
        # one copy back: ids (int32), scores (f32) and valid as bytes; it
        # waits for the scoring call, so wall-clock latency includes it
        B, k = out.ids.shape
        packed = torch.cat([out.ids.contiguous().view(torch.uint8),
                            out.scores.contiguous().view(torch.uint8),
                            out.valid.view(torch.uint8)], dim=1)
        host = packed.cpu().numpy()
        ids = host[:, :4 * k].copy().view(np.int32)
        scores = host[:, 4 * k:8 * k].copy().view(np.float32)
        valid = host[:, 8 * k:].astype(bool)
        # explicit-now callers keep a deterministic clock for tests
        t_done = time.monotonic() if now is None else now
        for i, (_, t) in enumerate(pairs):
            t.ids, t.scores, t.valid = ids[i], scores[i], valid[i]
            t.done = True
            t.latency_s = max(0.0, t_done - t.t_submit)
            self.latencies_s.append(t.latency_s)
        self.dispatches.append((shape, len(pairs)))
        return len(pairs)

    def _worker(self) -> ScoringWorker:
        w = self.workers[self._next_worker]
        self._next_worker = (self._next_worker + 1) % len(self.workers)
        return w

    def _pad_batch(self, reqs: List[Request], shape) -> RequestBatch:
        B, L, F = shape
        uid = np.full((B,), -1, np.int32)
        s_idx = np.zeros((B, L), np.int32)
        s_msk = np.zeros((B, L), np.float32)
        f_idx = np.zeros((B, F), np.int32)
        f_val = np.zeros((B, F), np.float32)
        f_msk = np.zeros((B, F), np.float32)
        for i, r in enumerate(reqs):
            uid[i] = r.user_id
            ns, nf = len(r.seen), len(r.fold_items)
            s_idx[i, :ns] = np.asarray(r.seen, np.int32)
            s_msk[i, :ns] = 1.0
            f_idx[i, :nf] = np.asarray(r.fold_items, np.int32)
            f_val[i, :nf] = np.asarray(r.fold_ratings, np.float32)
            f_msk[i, :nf] = 1.0
        z = self._rng.standard_normal((B, self._K), dtype=np.float32)
        slot = self._rng.integers(0, self._n_slots, size=B).astype(np.int32)
        dev = self._device
        return RequestBatch(*(to_device(a, dev) for a in (
            uid, s_idx, s_msk, f_idx, f_val, f_msk, z, slot)))
