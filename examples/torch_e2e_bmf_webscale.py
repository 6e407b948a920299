"""End-to-end driver of the PyTorch port (twin of ``e2e_bmf_webscale.py``):
the paper's full pipeline at the largest synthetic preset, the
yahoo-analogue dataset (10k x 6.2k, ~2.6M ratings): balanced partitioning,
three-phase Posterior Propagation through the stacked executor (or the
streaming one), posterior aggregation, RMSE evaluation and a checkpoint of
the aggregated posterior through ``checkpoint/ckpt.py``.

  PYTHONPATH=src python examples/torch_e2e_bmf_webscale.py [--fast]
      [--streaming] [--device cuda|cpu]

``--dataset`` and ``--samples`` override what ``--fast`` picks (movielens
and 30 samples; yahoo and 120 without it). The run must beat the mean
predictor.
"""
import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.core import bmf as BMF
from repro_torch.core import pp as PP
from repro_torch.core.partition import (nnz_balance_stats, partition,
                                        suggest_grid)
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import train_test_split

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="smaller dataset + chains (CI-friendly)")
    ap.add_argument("--streaming", action="store_true",
                    help="oversized grid streamed through a bounded window "
                         "of reused block buffers (the configuration for "
                         "grids that exceed device memory under the stacked "
                         "executor)")
    ap.add_argument("--dataset", default=None,
                    help="synthetic preset (default: movielens with --fast, "
                         "else yahoo)")
    ap.add_argument("--samples", type=int, default=None,
                    help="Gibbs sweeps per chain (default: 30 with --fast, "
                         "else 120)")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "torch_bmf_pp"),
                    help="checkpoint path (PATH.npz and its PATH.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dataset = args.dataset or ("movielens" if args.fast else "yahoo")
    samples = args.samples or (30 if args.fast else 120)
    coo, preset = SYN.generate(dataset, seed=0)
    train, test = train_test_split(coo, 0.1, seed=1)
    print(f"[{dataset}] {train.n_rows} x {train.n_cols}, nnz={train.nnz} "
          f"on {device}")

    K = min(preset.K, 16)
    cfg = BMF.BMFConfig(K=K, n_samples=samples, burnin=samples // 3)
    n_blocks = 32 if args.streaming else 4
    I, J = suggest_grid(train.n_rows, train.n_cols, n_blocks=n_blocks)
    part = partition(train, I, J)
    print(f"grid {I}x{J}, balance {nnz_balance_stats(part)}")

    t0 = time.time()
    # stacked executor: each PP phase bucket runs as ONE batched Gibbs
    # call; --streaming instead bounds the live footprint to a 4-block
    # window (prefetched, reused, critical-path-first)
    executor = "streaming" if args.streaming else "stacked"
    res = PP.run_pp(0, part, cfg, test, executor=executor,
                    window=4 if args.streaming else None, verbose=True,
                    device=device)
    print(f"BMF+PP[{res.executor}] RMSE={res.rmse:.4f} in "
          f"{time.time() - t0:.1f}s ({res.n_test} test ratings)")
    print(f"phase times: { {k: round(v, 1) for k, v in res.phase_times_s.items()} }")
    print(f"modeled 16-worker wall: {res.modeled_parallel_s(16):.1f}s")
    base = float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))
    assert res.rmse < base, f"PP {res.rmse} must beat the mean {base}"

    Path(args.ckpt).parent.mkdir(parents=True, exist_ok=True)
    ckpt.save(args.ckpt, {
        "U_eta": res.U_agg.eta, "U_Lam": res.U_agg.Lambda,
        "V_eta": res.V_agg.eta, "V_Lam": res.V_agg.Lambda},
        extra={"rmse": res.rmse, "dataset": dataset})
    print(f"aggregated posterior checkpointed -> {args.ckpt}.npz")
    print("OK")
    return res


if __name__ == "__main__":
    main()
