"""BMF-PP serving CLI — train, build the posterior store, serve top-K
(port of ``repro.launch.bmf_serve``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.bmf_serve \
      --dataset movielens --blocks 4 --samples 20 \
      --mode thompson --requests 256 --check [--device cuda|cpu]

Pipeline: ``run_pp`` with the chosen executor, then
``PosteriorStore.from_pp_result`` (built on the result's device), then a
``MicroBatchRouter`` pumping ``--requests`` recommendation requests built
from real users (each masks its own training items as seen). Reports
per-request p50/p99 latency and QPS.

``--check`` (mean mode) verifies every served top-K against a dense numpy
brute-force ranking over the store means: each returned item's score must
be within 1e-5 of the k-th best brute-force score.

``--executor`` picks the training executor; 'sharded' runs each bucket's
batch on the default topology (one device group per visible device).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import pp as PP
from repro_torch.core.partition import partition, suggest_grid
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import train_test_split
from repro_torch.serving import MicroBatchRouter, PosteriorStore, Request
from repro_torch.serving.scoring import MODES


def user_ratings(train):
    """Each user's training ratings in their order in ``train``: (sorted
    user ids, start offsets, items, ratings)."""
    order = np.argsort(train.row, kind="stable")
    users, starts = np.unique(train.row[order], return_index=True)
    return (users, np.append(starts, len(order)), train.col[order],
            train.val[order])


def build_requests(train, n_requests: int, max_seen: int, seed: int):
    """One request per (cycled) user: mask the user's training items
    (truncated to the router's seen cap). The same requests as the
    reference's dict-of-lists loop, from one stable sort."""
    users, starts, items, _ = user_ratings(train)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        i = int(rng.integers(len(users)))
        lo = starts[i]
        hi = min(starts[i + 1], lo + max_seen)
        out.append(Request(user_id=int(users[i]),
                           seen=[int(c) for c in items[lo:hi]]))
    return out


def check_parity(router, tickets, reqs, store, tol: float = 1e-5):
    """Brute-force dense reference over store means: every served item's
    score must reach the k-th best masked score (the tolerance absorbs
    the device's and numpy's reduction orders)."""
    U = store.U_mean.cpu().numpy()
    V = store.V_mean.cpu().numpy()
    k = router.k
    for t, r in zip(tickets, reqs):
        scores = U[r.user_id] @ V.T
        scores[np.asarray(r.seen, int)] = -np.inf
        kth = np.sort(scores)[::-1][min(k, len(scores)) - 1]
        served = scores[t.ids[t.valid]]
        assert served.size == min(k, int(np.isfinite(scores).sum()))
        assert (served >= kth - tol).all(), (r.user_id, served, kth)
    print(f"parity check OK: {len(tickets)} request(s) match the dense "
          f"brute-force top-{k} within {tol}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="movielens",
                    choices=list(SYN.PRESETS))
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--k", type=int, default=0, help="0 = preset K (cap 16)")
    ap.add_argument("--executor", default="stacked",
                    choices=["serial", "stacked", "sharded", "async",
                             "streaming"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8,
                    help="item posterior sample slots S in the store")
    ap.add_argument("--mode", default="mean", choices=list(MODES))
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-seen", type=int, default=64)
    ap.add_argument("--latency-budget-ms", type=float, default=2.0)
    ap.add_argument("--check", action="store_true",
                    help="verify served top-K against a dense numpy "
                         "brute-force ranking (mean mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    coo, p = SYN.generate(args.dataset, seed=args.seed)
    train, test = train_test_split(coo, 0.1, seed=args.seed + 1)
    K = args.k or min(p.K, 16)
    cfg = BMF.BMFConfig(K=K, n_samples=args.samples,
                        burnin=args.samples // 3)
    I, J = suggest_grid(train.n_rows, train.n_cols, args.blocks)
    part = partition(train, I, J)
    print(f"dataset={args.dataset} N={train.n_rows} M={train.n_cols} "
          f"grid={I}x{J} K={K} executor={args.executor} device={dev}")

    t0 = time.time()
    res = PP.run_pp(args.seed, part, cfg, test, executor=args.executor,
                    device=dev)
    print(f"trained: RMSE={res.rmse:.4f} wall={time.time() - t0:.1f}s")

    t0 = time.time()
    store = PosteriorStore.from_pp_result(res, seed=args.seed + 2,
                                          n_slots=args.slots)
    sync()
    print(f"store: {store.n_users} users x {store.n_items} items, "
          f"K={store.K}, {store.n_slots} sample slot(s), "
          f"built in {time.time() - t0:.2f}s")

    router = MicroBatchRouter(store, k=args.topk, mode=args.mode,
                              latency_budget_s=args.latency_budget_ms / 1e3,
                              max_batch=args.max_batch,
                              max_seen=args.max_seen,
                              seed=args.seed + 3)
    print(f"router: {len(router.plan_signatures)} batch shape(s): "
          f"{router.plan_signatures}")

    reqs = build_requests(train, args.requests, args.max_seen,
                          args.seed + 4)
    # warm the full-batch shape so measured latency is serving, not the
    # first call's set-up
    for r in reqs[:args.max_batch]:
        router.submit(r)
    router.flush()
    router.latencies_s.clear()
    router.dispatches.clear()

    t0 = time.time()
    for r in reqs:
        router.submit(r)
        router.poll()
    router.flush()
    wall = time.time() - t0
    lat = np.asarray(router.latencies_s)
    print(f"served {len(lat)} request(s) in {wall:.2f}s  "
          f"QPS={len(lat) / max(wall, 1e-9):.0f}  "
          f"p50={np.percentile(lat, 50) * 1e3:.2f}ms  "
          f"p99={np.percentile(lat, 99) * 1e3:.2f}ms  "
          f"dispatches={len(router.dispatches)}")

    if args.check:
        router2 = MicroBatchRouter(store, k=args.topk, mode="mean",
                                   latency_budget_s=0.0,
                                   max_batch=args.max_batch,
                                   max_seen=args.max_seen,
                                   seed=args.seed + 5)
        check_reqs = reqs[:min(64, len(reqs))]
        tickets = [router2.submit(r) for r in check_reqs]
        router2.flush()
        check_parity(router2, tickets, check_reqs, store)


if __name__ == "__main__":
    main()
