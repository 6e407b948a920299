"""Block-size exploration of the PyTorch port (twin of
``pp_block_exploration.py``, paper Figure 3): how the I×J grid trades
wall-clock against RMSE, and why ~square blocks win; each grid through the
serial executor (one chain per block) and the stacked one (one batched
chain per phase bucket: the same chains).

  PYTHONPATH=src python examples/torch_pp_block_exploration.py
      [--device cuda|cpu]

``--dataset`` and ``--samples`` shrink the run (defaults: movielens, 30).
The stacked run's RMSE must equal the serial run's within 1e-4.
"""
import argparse
import math

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import pp as PP
from repro_torch.core.partition import partition
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import train_test_split

GRIDS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1)]
# serial vs stacked RMSE: the same chains in other batch shapes, so only
# rounding separates them (the port's PP RMSE limit across executors)
RMSE_TOL = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="movielens")
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    coo, preset = SYN.generate(args.dataset, seed=0)
    train, test = train_test_split(coo, 0.1, seed=1)
    cfg = BMF.BMFConfig(K=preset.K, n_samples=args.samples,
                        burnin=args.samples // 3)

    print(f"{'grid':>6} {'rmse':>8} {'serial_s':>9} {'stacked_s':>9} "
          f"{'par16_s':>8} {'squareness':>10}")
    rows = []
    for (I, J) in GRIDS:
        part = partition(train, I, J)
        res = PP.run_pp(0, part, cfg, test, device=device)
        # same blocks through the phase-graph engine's stacked executor:
        # one batched Gibbs call per phase bucket instead of the per-block
        # loop (identical chains: the same per-block noise, same padding)
        res_stk = PP.run_pp(0, part, cfg, test, executor="stacked",
                            device=device)
        sq = abs(math.log((train.n_rows / I) / (train.n_cols / J)))
        print(f"{I}x{J:<4} {res.rmse:8.4f} {res.wall_time_s:9.2f} "
              f"{res_stk.wall_time_s:9.2f} "
              f"{res.modeled_parallel_s(16):8.2f} {sq:10.2f}")
        assert abs(res.rmse - res_stk.rmse) <= RMSE_TOL, \
            f"{I}x{J}: serial {res.rmse} vs stacked {res_stk.rmse}"
        rows.append((I, J, res.rmse, res_stk.rmse))
    print("\nlower squareness == closer to square blocks; the best "
          "time/RMSE points cluster there (paper §3.3). stacked_s is the "
          "phase-graph engine's batched execution of the same grid.")
    print("OK")
    return rows


if __name__ == "__main__":
    main()
