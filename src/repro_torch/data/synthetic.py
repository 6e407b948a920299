"""Synthetic rating-matrix generators matched to the paper's Table 1
(port of ``repro.data.synthetic``; same presets, same draws, same arrays).

| preset        | paper rows | cols  | nnz    | scale | K   | ratings/row |
|---------------|-----------|-------|--------|-------|-----|-------------|
| movielens     | 138.5K    | 27.3K | 20.0M  | 1-5   | 10  | 144         |
| netflix       | 480.2K    | 17.8K | 100.5M | 1-5   | 100 | 209         |
| yahoo         | 1.0M      | 625K  | 262.8M | 0-100 | 100 | 263         |
| amazon        | 21.2M     | 9.7M  | 82.5M  | 1-5   | 10  | 4           |
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.data.sparse import COO


@dataclass(frozen=True)
class DatasetPreset:
    name: str
    n_rows: int
    n_cols: int
    ratings_per_row: float
    scale_lo: float
    scale_hi: float
    K: int                 # latent dim used by ALL methods (paper Table 1)
    true_rank: int         # rank of the generating factors


# reduction ~1/100 on rows/cols (nnz scales with rows × ratings/row)
PRESETS: Dict[str, DatasetPreset] = {
    "movielens": DatasetPreset("movielens", 1385, 273, 144, 1, 5, 10, 8),
    "netflix": DatasetPreset("netflix", 4802, 178, 209, 1, 5, 100, 12),
    "yahoo": DatasetPreset("yahoo", 10_000, 6250, 263, 0, 100, 100, 12),
    "amazon": DatasetPreset("amazon", 21_200, 9700, 4, 1, 5, 10, 6),
    # small preset for unit tests / examples
    "mini": DatasetPreset("mini", 400, 120, 30, 1, 5, 8, 5),
}


def generate(preset: str | DatasetPreset, seed: int = 0,
             noise_std: float = 0.35) -> Tuple[COO, DatasetPreset]:
    """Low-rank + Gaussian noise ratings, clipped to the preset scale."""
    p = PRESETS[preset] if isinstance(preset, str) else preset
    rng = np.random.default_rng(seed)
    nnz = int(p.n_rows * p.ratings_per_row)

    # bounded power-law popularity
    row_w = (np.arange(p.n_rows) + 1.0) ** -0.7
    col_w = (np.arange(p.n_cols) + 1.0) ** -0.6
    rng.shuffle(row_w)
    rng.shuffle(col_w)
    row_p = row_w / row_w.sum()
    col_p = col_w / col_w.sum()
    # oversample then dedupe to hit the target nnz
    rows = rng.choice(p.n_rows, size=int(nnz * 1.6), p=row_p).astype(np.int32)
    cols = rng.choice(p.n_cols, size=int(nnz * 1.6), p=col_p).astype(np.int32)
    key = rows.astype(np.int64) * p.n_cols + cols
    _, uniq = np.unique(key, return_index=True)
    # shuffle BEFORE truncating: np.unique returns indices sorted by
    # row-major key, so uniq[:nnz] alone would keep only the smallest row
    # ids and cut the tail rows off instead of thinning the drawn
    # popularity profile uniformly
    uniq = rng.permutation(uniq)[:nnz]
    rows, cols = rows[uniq], cols[uniq]

    r = p.true_rank
    scale_mid = 0.5 * (p.scale_lo + p.scale_hi)
    spread = 0.5 * (p.scale_hi - p.scale_lo)
    U = rng.normal(0, 1, (p.n_rows, r))
    V = rng.normal(0, 1, (p.n_cols, r))
    raw = np.einsum("ek,ek->e", U[rows], V[cols]) / np.sqrt(r)
    vals = scale_mid + spread * 0.5 * raw + noise_std * spread * rng.normal(size=len(rows))
    vals = np.clip(vals, p.scale_lo, p.scale_hi).astype(np.float32)

    return COO(row=rows, col=cols, val=vals, n_rows=p.n_rows,
               n_cols=p.n_cols), p
