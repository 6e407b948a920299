"""BMF-PP training entry point — the paper's end-to-end pipeline, on the GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.bmf_train \
      --dataset movielens --blocks 4 --samples 8 --fused-sweep \
      [--executor serial|stacked|sharded|async|streaming] [--window W] \
      [--topology BLOCK DATA [--comm gather|psum|scatter]] [--distributed] \
      [--ckpt-dir DIR [--ckpt-every N] [--resume]] [--device cuda|cpu]

--executor picks the phase-graph engine executor (core.engine): 'stacked'
(default) runs each PP phase's shape bucket as ONE batched chain; 'serial'
is the reference per-block loop; 'sharded' splits each bucket's batch over
the --topology's device groups; 'async' dispatches each block the moment
its prior sources resolve (phases b and c overlap); 'streaming' moves the
blocks through a bounded window of --window device buffers, copying the
next chunk while the current one computes. --fused-sweep runs each factor
step as one pass of kernel B2 (--sweep-dtype bf16 for the mixed-precision
mode).

Fault tolerance: --on-fault/--max-retries set the engine's chain-health
policy; --ckpt-dir persists each resolved block's posteriors so a killed
run restarts with --resume and finishes bitwise identical to an
uninterrupted one; --ckpt saves the aggregated posteriors.

--topology B D places the run on B device groups of D slots each
(core.topology.Topology; the slots round-robin over the visible devices,
so one GPU holds them all as streams): the groups run blocks side by side
and each block's Gibbs sweep is sharded over its group's D slots — the
paper's combined system — with --comm picking the intra-block exchange.
It composes with --executor sharded, async, streaming ('gather' only) and
serial (B = 1). --distributed shards each block's chain over the visible
devices (Topology(1, n)) and forces the serial executor.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
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
                    choices=["serial", "stacked", "sharded", "async",
                             "streaming"],
                    help="phase-graph engine executor (core.engine)")
    ap.add_argument("--window", type=int, default=0,
                    help="streaming executor window size W (0 = default)")
    ap.add_argument("--topology", type=int, nargs=2, default=None,
                    metavar=("BLOCK", "DATA"),
                    help="placement: BLOCK device groups x DATA slots per "
                         "group (core.topology)")
    ap.add_argument("--comm", default=None, choices=["gather", "psum",
                                                     "scatter"],
                    help="intra-block exchange at DATA > 1 "
                         "(core.distributed.COMM_MODES; default gather)")
    ap.add_argument("--distributed", action="store_true",
                    help="shard each block's chain over the visible "
                         "devices (forces --executor serial)")
    ap.add_argument("--phase-bc-samples", type=int, default=0)
    ap.add_argument("--fused-sweep", action="store_true",
                    help="one-kernel Gibbs sweep (kernel B2, bmf_sweep)")
    ap.add_argument("--sweep-dtype", default="fp32",
                    choices=["fp32", "bf16"],
                    help="fused-sweep precision: bf16 gather + accumulate, "
                         "f32 factorization; only with --fused-sweep")
    ap.add_argument("--ckpt", default="",
                    help="save the aggregated posteriors here (npz + json)")
    ap.add_argument("--ckpt-dir", default="",
                    help="block-level phase-graph checkpoint directory: "
                         "each resolved block's posteriors persist there "
                         "(atomic per-block files), making the run "
                         "resumable with --resume")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="flush block checkpoints every N resolves "
                         "(a kill loses at most N-1 blocks)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --ckpt-dir: restored blocks are "
                         "skipped and the finished run is bitwise identical "
                         "to an uninterrupted one")
    ap.add_argument("--on-fault", default="raise",
                    choices=["raise", "degrade"],
                    help="after --max-retries failed re-runs of a faulty "
                         "block: raise, or degrade it to its propagated "
                         "prior (recorded in the fault ledger)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="bounded re-runs of an unhealthy block (fresh "
                         "seed + jittered prior)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir (the directory the "
                         "interrupted run checkpointed into)")
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

    from repro_torch.core.topology import Topology, visible_devices
    topology = mesh = None
    if args.topology and args.distributed:
        raise SystemExit("--topology and --distributed are exclusive "
                         "(--distributed is Topology(1, n_devices))")
    slots = (visible_devices() if device.type == "cuda" else (device,))
    if args.topology:
        b, d = args.topology
        topology = Topology(b, d, devices=tuple(
            slots[k % len(slots)] for k in range(b * d)))
        print(topology.describe())
    if args.distributed:
        mesh = Topology(1, len(slots), devices=slots)
        print(f"distributed: {len(slots)}-way intra-block chain per block "
              f"(serial executor)")

    res = PP.run_pp(args.seed, part, cfg, test, verbose=True,
                    executor=args.executor, device=device,
                    topology=topology, distributed_mesh=mesh,
                    comm=args.comm,
                    window=args.window or None, on_fault=args.on_fault,
                    max_retries=args.max_retries,
                    checkpoint_dir=args.ckpt_dir or None,
                    ckpt_every=args.ckpt_every,
                    resume_from=args.ckpt_dir if args.resume else None)
    print(f"executor={res.executor}  RMSE={res.rmse:.4f}  "
          f"wall={res.wall_time_s:.1f}s  "
          f"phases={ {k: round(v, 2) for k, v in res.phase_times_s.items()} }")
    if res.resumed_blocks:
        print(f"resumed {res.resumed_blocks} block(s) from {args.ckpt_dir}")
    if res.faults:
        print(f"faults: {len(res.faults)} event(s), "
              f"{res.n_retries} retr{'y' if res.n_retries == 1 else 'ies'} — "
              + "; ".join(f"{f.kind}@{f.coord}:{f.action}"
                          for f in res.faults))
    print(f"modeled 16-worker wall: {res.modeled_parallel_s(16):.1f}s")
    if res.block_spans_s:
        print(f"measured critical path: {res.critical_path_s():.1f}s "
              f"(dispatch→resolve spans, dependency chain)")
    if args.ckpt:
        ckpt.save(args.ckpt, {"U_eta": res.U_agg.eta, "U_Lam": res.U_agg.Lambda,
                              "V_eta": res.V_agg.eta, "V_Lam": res.V_agg.Lambda},
                  extra={"rmse": res.rmse, "grid": [I, J]})
        print("checkpoint ->", args.ckpt)
    return res


if __name__ == "__main__":
    main()
