"""I×J block partitioning of the rating matrix for Posterior Propagation
(port of ``repro.core.partition``; identical arrays).

The paper (§3.3) finds approximately-square blocks give the best
wall-clock/RMSE trade-off, with the block grid following the matrix aspect
ratio. ``suggest_grid`` implements that heuristic; ``partition`` builds the
per-block local COO with load-balancing row/col permutations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Tuple

import numpy as np

from repro_torch.data.sparse import (COO, apply_permutation,
                                     balance_permutation, occupancy_rank)


@dataclass
class Block:
    i: int
    j: int
    row_ids: np.ndarray       # global (permuted-space) row ids, sorted
    col_ids: np.ndarray
    coo: COO                  # local coordinates
    phase: str                # 'a' | 'b_row' | 'b_col' | 'c'


@dataclass
class Partition:
    I: int
    J: int
    row_perm: np.ndarray      # original -> permuted position
    col_perm: np.ndarray
    row_splits: np.ndarray    # (I+1,) boundaries in permuted space
    col_splits: np.ndarray
    blocks: List[List[Block]] # [i][j]

    def block(self, i: int, j: int) -> Block:
        return self.blocks[i][j]

    def all_blocks(self):
        for row in self.blocks:
            yield from row


def _phase(i: int, j: int) -> str:
    if i == 0 and j == 0:
        return "a"
    if j == 0:
        return "b_row"
    if i == 0:
        return "b_col"
    return "c"


def suggest_grid(n_rows: int, n_cols: int, n_blocks: int) -> Tuple[int, int]:
    """Paper §3.3: blocks should be ~square => I/J ≈ n_rows/n_cols with
    I·J ≈ n_blocks."""
    best = (1, n_blocks)
    best_err = float("inf")
    for I in range(1, n_blocks + 1):
        if n_blocks % I:
            continue
        J = n_blocks // I
        err = abs(math.log((n_rows / I) / (n_cols / J)))
        if err < best_err:
            best_err, best = err, (I, J)
    return best


def _occupancy_refine(pc: COO, perm: np.ndarray, splits: np.ndarray,
                      axis: str) -> np.ndarray:
    """Compose a within-stripe occupancy sort onto the global permutation:
    each stripe's rows are sorted by descending rating count, so the
    padded planes of every block in the stripe are occupancy-coherent.
    Stripe membership is untouched."""
    ids = pc.row if axis == "row" else pc.col
    n = pc.n_rows if axis == "row" else pc.n_cols
    counts = np.bincount(ids, minlength=n)
    refine = np.arange(n, dtype=np.int64)
    for lo, hi in zip(splits[:-1], splits[1:]):
        refine[lo:hi] = lo + occupancy_rank(counts[lo:hi])
    return refine[perm]


def partition(coo: COO, I: int, J: int, balance=True,
              seed: int = 0, occupancy_sort: bool = True) -> Partition:
    """balance: True = nnz-balance permutation (default), False = random
    permutation, "none" = identity."""
    if balance == "none":
        row_perm = np.arange(coo.n_rows, dtype=np.int64)
        col_perm = np.arange(coo.n_cols, dtype=np.int64)
    elif balance:
        row_perm = balance_permutation(coo, "row")
        col_perm = balance_permutation(coo, "col")
    else:
        rng = np.random.default_rng(seed)
        row_perm = rng.permutation(coo.n_rows)
        col_perm = rng.permutation(coo.n_cols)
    pc = apply_permutation(coo, row_perm, col_perm)

    row_splits = np.linspace(0, coo.n_rows, I + 1).astype(np.int64)
    col_splits = np.linspace(0, coo.n_cols, J + 1).astype(np.int64)

    if occupancy_sort:
        row_perm = _occupancy_refine(pc, row_perm, row_splits, "row")
        col_perm = _occupancy_refine(pc, col_perm, col_splits, "col")
        pc = apply_permutation(coo, row_perm, col_perm)

    # one stable sort by block id instead of one full-matrix scan per
    # block: entries keep their original order within a block, so every
    # block's COO equals the reference's ``submatrix`` result
    bi = np.searchsorted(row_splits, pc.row, side="right") - 1
    bj = np.searchsorted(col_splits, pc.col, side="right") - 1
    order = np.argsort(bi * J + bj, kind="stable")
    bounds = np.searchsorted((bi * J + bj)[order], np.arange(I * J + 1))

    blocks: List[List[Block]] = []
    for i in range(I):
        row = []
        r_ids = np.arange(row_splits[i], row_splits[i + 1])
        for j in range(J):
            c_ids = np.arange(col_splits[j], col_splits[j + 1])
            sel = order[bounds[i * J + j]:bounds[i * J + j + 1]]
            sub = COO(row=(pc.row[sel] - row_splits[i]).astype(np.int32),
                      col=(pc.col[sel] - col_splits[j]).astype(np.int32),
                      val=pc.val[sel], n_rows=len(r_ids), n_cols=len(c_ids))
            row.append(Block(i=i, j=j, row_ids=r_ids, col_ids=c_ids,
                             coo=sub, phase=_phase(i, j)))
        blocks.append(row)
    return Partition(I=I, J=J, row_perm=row_perm, col_perm=col_perm,
                     row_splits=row_splits, col_splits=col_splits,
                     blocks=blocks)


def coalesce_shapes(shapes: Dict[Hashable, Tuple[int, ...]],
                    footprint: Callable[[Tuple[int, ...]], float],
                    max_waste: float = 1.5) -> Dict[Hashable, Tuple[int, ...]]:
    """Merge shape buckets so ONE padded shape (the elementwise max of its
    members) serves many blocks, as long as no member's ``footprint`` is
    inflated by more than ``max_waste``. Returns the same keys mapped to
    their group's merged tuple. ``footprint`` must be monotone in each
    dimension."""
    if max_waste < 1.0:
        raise ValueError(f"max_waste must be >= 1, got {max_waste}")
    order = sorted(shapes, key=lambda k: (-footprint(shapes[k]), str(k)))
    groups: List[Tuple[Tuple[int, ...], List[Hashable]]] = []
    for k in order:
        s = shapes[k]
        placed = False
        for gi, (gshape, members) in enumerate(groups):
            merged = tuple(max(a, b) for a, b in zip(gshape, s))
            fm = footprint(merged)
            if all(fm <= max_waste * footprint(shapes[m])
                   for m in members + [k]):
                groups[gi] = (merged, members + [k])
                placed = True
                break
        if not placed:
            groups.append((s, [k]))
    out: Dict[Hashable, Tuple[int, ...]] = {}
    for gshape, members in groups:
        for m in members:
            out[m] = gshape
    return out


def nnz_balance_stats(part: Partition) -> dict:
    nnz = np.array([[b.coo.nnz for b in row] for row in part.blocks])
    return {
        "min": int(nnz.min()), "max": int(nnz.max()),
        "mean": float(nnz.mean()),
        "imbalance": float(nnz.max() / max(nnz.mean(), 1.0)),
    }
