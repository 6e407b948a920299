"""Distributed BMF inside one block in the PyTorch port (twin of
``distributed_block.py``; paper ref [16], Fig. 2 pattern): rows of U
split over 8 data slots of one device group (``Topology(1, 8)``), V's
sufficient statistics summed over the slots: the 'limited communication'
structure. On one GPU the 8 slots are 8 streams of that card.

  PYTHONPATH=src python examples/torch_distributed_block.py
      [--device cuda|cpu]

``--dataset`` and ``--samples`` shrink the run (defaults: movielens, 40).
The chain must beat the mean predictor.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import distributed as DIST
from repro_torch.core import gibbs as GIBBS
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import coo_to_padded_csr, train_test_split

SLOTS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="movielens")
    ap.add_argument("--samples", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    topo = Topology(1, SLOTS, devices=(device,) * SLOTS)
    coo, preset = SYN.generate(args.dataset, seed=0)
    train, test = train_test_split(coo, 0.1, seed=1)
    csr_r = coo_to_padded_csr(train, device=device)
    csr_c = coo_to_padded_csr(train.transpose(), device=device)
    cfg = BMF.BMFConfig(K=preset.K, n_samples=args.samples,
                        burnin=args.samples * 3 // 8)

    res = DIST.run_gibbs_distributed(0, csr_r, csr_c, test.row, test.col,
                                     cfg, topo, device=device)
    rmse = float(GIBBS.rmse_from_acc(res.acc, test.val))

    comm = DIST.sweep_comm_bytes(train.n_cols, cfg.K)
    print(f"{SLOTS}-way distributed Gibbs on {topo.describe()}: "
          f"RMSE={rmse:.4f}")
    print(f"communication per sweep: {comm/1e3:.1f} KB "
          f"(D*(K^2+K) floats — independent of the {train.nnz} ratings)")
    base = float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))
    assert rmse < base, f"distributed chain {rmse} must beat the mean {base}"
    print("OK")
    return rmse


if __name__ == "__main__":
    main()
