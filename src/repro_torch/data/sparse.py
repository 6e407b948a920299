"""Fixed-shape sparse rating-matrix containers (port of ``repro.data.sparse``).

``PaddedCSR`` stores, for each row, up to ``max_nnz`` (column, value) pairs
plus a mask: the Gibbs per-row conditionals become masked gathers. ``COO``
keeps flat triplets for block extraction and test-set evaluation.

Host-side construction is numpy and gives arrays identical to the
reference's; only the finished planes move to a torch device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass
class COO:
    row: np.ndarray      # (nnz,) int32
    col: np.ndarray      # (nnz,) int32
    val: np.ndarray      # (nnz,) float32
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def transpose(self) -> "COO":
        return COO(row=self.col, col=self.row, val=self.val,
                   n_rows=self.n_cols, n_cols=self.n_rows)

    def submatrix(self, row_ids: np.ndarray, col_ids: np.ndarray) -> "COO":
        """Extract block given *sorted* global id arrays; ids are relabeled
        to local [0, len) coordinates."""
        row_pos = -np.ones(self.n_rows, np.int64)
        row_pos[row_ids] = np.arange(len(row_ids))
        col_pos = -np.ones(self.n_cols, np.int64)
        col_pos[col_ids] = np.arange(len(col_ids))
        r = row_pos[self.row]
        c = col_pos[self.col]
        keep = (r >= 0) & (c >= 0)
        return COO(row=r[keep].astype(np.int32), col=c[keep].astype(np.int32),
                   val=self.val[keep], n_rows=len(row_ids), n_cols=len(col_ids))


@dataclass
class PaddedCSR:
    """Row-major padded sparse matrix: torch tensors on a device, or numpy
    arrays when built with ``as_numpy=True``. Planes may carry leading
    batch axes (a stacked bucket is (B, N, M))."""
    idx: object          # (..., N, M) int32 column ids (0 where padded)
    val: object          # (..., N, M) f32
    mask: object         # (..., N, M) f32 {0,1}
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.idx.shape[-2])

    @property
    def max_nnz(self) -> int:
        return int(self.idx.shape[-1])


def padded_csr_host(coo: COO, max_nnz: Optional[int] = None,
                    pad_to_multiple: int = 8,
                    n_rows_pad: Optional[int] = None,
                    n_cols: Optional[int] = None):
    """Slot layout of the padded CSR without the dense planes: the row,
    slot, column and value of every entry that fits, and the padded shape
    (NR, M). Entry e of the row-sorted order lands in slot
    e - starts[row[e]]; slots >= M are truncated (rows beyond max_nnz).

    The column ids are checked here, on the host, against ``n_cols``
    (default ``coo.n_cols``): the kernels gather ``other[idx]`` without
    bounds checks, and a check of the finished planes on the card would
    make every chain wait for the device."""
    n_cols = coo.n_cols if n_cols is None else n_cols
    if coo.nnz and not (int(coo.col.min()) >= 0
                        and int(coo.col.max()) < n_cols):
        raise ValueError(f"CSR column ids outside [0, {n_cols})")
    order = np.argsort(coo.row, kind="stable")
    rows, cols, vals = coo.row[order], coo.col[order], coo.val[order]
    counts = np.bincount(rows, minlength=coo.n_rows)
    M = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_nnz is not None:
        M = max_nnz   # bucket target: pad up to it, truncate rows beyond it
    M = max(1, ((M + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple)
    NR = n_rows_pad if n_rows_pad is not None else coo.n_rows
    if NR < coo.n_rows:
        raise ValueError(f"n_rows_pad={NR} < n_rows={coo.n_rows}")
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows), dtype=np.int64) - starts[rows]
    keep = slot < M
    return rows[keep], slot[keep], cols[keep], vals[keep], (NR, M)


def coo_to_padded_csr(coo: COO, max_nnz: Optional[int] = None,
                      pad_to_multiple: int = 8,
                      n_rows_pad: Optional[int] = None,
                      n_cols_pad: Optional[int] = None,
                      as_numpy: bool = False, device=None) -> PaddedCSR:
    """``n_rows_pad`` / ``n_cols_pad`` / ``max_nnz`` bucket many matrices
    to ONE shape so a stacked chain serves all blocks of a bucket.
    ``as_numpy=True`` keeps the planes on the host; otherwise they land on
    ``device`` (default: the GPU)."""
    n_cols = n_cols_pad if n_cols_pad is not None else coo.n_cols
    r, s, c, v, (NR, M) = padded_csr_host(coo, max_nnz, pad_to_multiple,
                                          n_rows_pad, n_cols)
    idx = np.zeros((NR, M), np.int32)
    val = np.zeros((NR, M), np.float32)
    mask = np.zeros((NR, M), np.float32)
    idx[r, s] = c
    val[r, s] = v
    mask[r, s] = 1.0
    if as_numpy:
        return PaddedCSR(idx=idx, val=val, mask=mask, n_cols=n_cols)
    dev = resolve_device(device)
    return PaddedCSR(idx=torch.from_numpy(idx).to(dev),
                     val=torch.from_numpy(val).to(dev),
                     mask=torch.from_numpy(mask).to(dev), n_cols=n_cols)


def tile_occupancy(mask: torch.Tensor, tn: int, tm: int) -> torch.Tensor:
    """Per-row-tile count of live M-tiles: ``ntiles[t]`` = number of
    tm-wide slot tiles that contain any unmasked entry among rows
    [t·tn, (t+1)·tn). mask: (N, M) with N % tn == 0 and M % tm == 0."""
    N, M = mask.shape
    if N % tn or M % tm:
        raise ValueError(f"mask {tuple(mask.shape)} not a multiple of "
                         f"({tn}, {tm})")
    last = row_live(mask).reshape(N // tn, tn).amax(dim=1)
    return ((last + tm - 1) // tm).to(torch.int32)


def row_live(mask: torch.Tensor) -> torch.Tensor:
    """Per-row live length: 1 + the position of the last unmasked slot (0
    for an empty row), over the last axis. The port's kernels loop over
    slots < row_live and skip the all-padding tail — the same skip
    ``tile_occupancy`` gives the TPU kernel, at row granularity. Valid for
    any mask, not only left-packed CSR."""
    M = mask.shape[-1]
    pos = torch.arange(1, M + 1, device=mask.device, dtype=torch.int32)
    return torch.where(mask != 0, pos, 0).amax(dim=-1).to(torch.int32)


def occupancy_rank(counts: np.ndarray) -> np.ndarray:
    """rank[i] = position of row i when sorted by DESCENDING count
    (stable)."""
    order = np.argsort(-counts, kind="stable")
    rank = np.empty(len(counts), np.int64)
    rank[order] = np.arange(len(counts))
    return rank


def occupancy_permutation(coo: COO, axis: str = "row") -> np.ndarray:
    """Permutation sorting rows (or cols) by DESCENDING rating count, so
    row groups are occupancy-coherent and the kernels' tail skip is
    effective."""
    ids = coo.row if axis == "row" else coo.col
    n = coo.n_rows if axis == "row" else coo.n_cols
    return occupancy_rank(np.bincount(ids, minlength=n))


def train_test_split(coo: COO, test_frac: float = 0.1,
                     seed: int = 0) -> Tuple[COO, COO]:
    rng = np.random.default_rng(seed)
    m = rng.random(coo.nnz) < test_frac
    tr = COO(coo.row[~m], coo.col[~m], coo.val[~m], coo.n_rows, coo.n_cols)
    te = COO(coo.row[m], coo.col[m], coo.val[m], coo.n_rows, coo.n_cols)
    return tr, te


def balance_permutation(coo: COO, axis: str = "row") -> np.ndarray:
    """Permutation that round-robins rows (or cols) by descending rating
    count, so a contiguous blocking gets near-equal nnz per stripe."""
    ids = coo.row if axis == "row" else coo.col
    n = coo.n_rows if axis == "row" else coo.n_cols
    counts = np.bincount(ids, minlength=n)
    order = np.argsort(-counts, kind="stable")
    perm = np.empty(n, np.int64)
    perm[order] = _round_robin_positions(n)
    return perm


def _round_robin_positions(n: int, stride: int = 64) -> np.ndarray:
    """i-th entry = target position of the i-th heaviest row: strided so the
    heavy rows spread uniformly over the index space."""
    return np.concatenate([np.arange(s, n, stride, dtype=np.int64)
                           for s in range(stride)])[:n]


def apply_permutation(coo: COO, row_perm: Optional[np.ndarray] = None,
                      col_perm: Optional[np.ndarray] = None) -> COO:
    row = coo.row if row_perm is None else row_perm[coo.row].astype(np.int32)
    col = coo.col if col_perm is None else col_perm[coo.col].astype(np.int32)
    return COO(row=row, col=col, val=coo.val, n_rows=coo.n_rows,
               n_cols=coo.n_cols)
