"""BMF-PP training entry point — the paper's end-to-end pipeline, on the GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.bmf_train \
      --dataset movielens --blocks 4 --samples 8 --fused-sweep \
      [--executor serial|stacked] [--device cuda|cpu]

--executor picks the phase-graph engine executor (core.engine): 'stacked'
(default) runs each PP phase's shape bucket as ONE batched chain; 'serial'
is the reference per-block loop. --fused-sweep runs each factor step as
one pass of kernel B2 (--sweep-dtype bf16 for the mixed-precision mode).

The reference CLI's --window, --distributed, --topology, --ckpt,
--ckpt-dir, --ckpt-every, --resume, --on-fault and --max-retries wait for
the modules they drive (ROADMAP §A).
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import pp as PP
from repro_torch.core.partition import (nnz_balance_stats, partition,
                                        suggest_grid)
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import train_test_split


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="movielens",
                    choices=list(SYN.PRESETS))
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--samples", type=int, default=60)
    ap.add_argument("--k", type=int, default=0, help="0 = preset K (capped 16)")
    ap.add_argument("--executor", default="stacked",
                    choices=["serial", "stacked"],
                    help="phase-graph engine executor (core.engine)")
    ap.add_argument("--phase-bc-samples", type=int, default=0)
    ap.add_argument("--fused-sweep", action="store_true",
                    help="one-kernel Gibbs sweep (kernel B2, bmf_sweep)")
    ap.add_argument("--sweep-dtype", default="fp32",
                    choices=["fp32", "bf16"],
                    help="fused-sweep precision: bf16 gather + accumulate, "
                         "f32 factorization; only with --fused-sweep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    coo, p = SYN.generate(args.dataset, seed=args.seed)
    train, test = train_test_split(coo, 0.1, seed=args.seed + 1)
    K = args.k or min(p.K, 16)
    cfg = BMF.BMFConfig(K=K, n_samples=args.samples,
                        burnin=args.samples // 3,
                        phase_bc_samples=args.phase_bc_samples or None,
                        sweep_fused=args.fused_sweep,
                        sweep_dtype=args.sweep_dtype)

    I, J = suggest_grid(train.n_rows, train.n_cols, args.blocks)
    part = partition(train, I, J)
    print(f"dataset={args.dataset} N={train.n_rows} D={train.n_cols} "
          f"nnz={train.nnz} grid={I}x{J} K={K} device={device}")
    print("block nnz balance:", nnz_balance_stats(part))

    res = PP.run_pp(args.seed, part, cfg, test, verbose=True,
                    executor=args.executor, device=device)
    print(f"executor={res.executor}  RMSE={res.rmse:.4f}  "
          f"wall={res.wall_time_s:.1f}s  "
          f"phases={ {k: round(v, 2) for k, v in res.phase_times_s.items()} }")
    if res.faults:
        print(f"faults: {len(res.faults)} event(s), "
              f"{res.n_retries} retr{'y' if res.n_retries == 1 else 'ies'} — "
              + "; ".join(f"{f.kind}@{f.coord}:{f.action}"
                          for f in res.faults))
    print(f"modeled 16-worker wall: {res.modeled_parallel_s(16):.1f}s")
    return res


if __name__ == "__main__":
    main()
