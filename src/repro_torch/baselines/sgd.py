"""FPSGD-style blocked stochastic gradient descent MF (Teflioudi et al.,
ref [15]; port of ``repro.baselines.sgd``).

The defining feature of FPSGD/NOMAD vs plain SGD is *block scheduling*:
the rating matrix is partitioned into a grid and independent (row-block,
col-block) pairs are updated without factor conflicts. A round of the
scheduler covers B conflict-free diagonal blocks (a Latin-square
schedule), on which minibatch SGD runs over the round's shuffled
triplets; duplicate rows within a minibatch add up (``index_add_``).

As in the reference, each round runs ``max(1, m // batch)`` minibatches
of its m padded triplets: the tail beyond ``n_mini · batch`` is never
visited.

On the GPU a round's minibatch loop (thousands of dependent steps of a
few small launches each) is captured once in a CUDA graph and replayed
for every round and epoch, its triplets copied into the graph's static
buffers first; on the CPU the same loop runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.baselines.als import init_factors
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.data.sparse import COO


class SGDConfig(NamedTuple):
    K: int = 16
    lr: float = 0.05
    reg: float = 0.05
    n_epochs: int = 30
    n_blocks: int = 4            # grid size (B x B, B blocks per round)
    batch: int = 256


def _block_schedule(coo: COO, B: int, seed: int = 0):
    """Assign ratings to (bi, bj) blocks; return per-round padded triplets.

    Round r updates blocks {(i, (i + r) % B)}: conflict-free (Latin square).
    """
    rng = np.random.default_rng(seed)
    bi = coo.row % B
    bj = coo.col % B
    rounds = []
    for r in range(B):
        sel = np.where((bj - bi) % B == r)[0]
        rng.shuffle(sel)
        rounds.append(sel)
    m = max(len(s) for s in rounds)
    idx = np.zeros((B, m), np.int64)
    msk = np.zeros((B, m), np.float32)
    for r, sel in enumerate(rounds):
        idx[r, :len(sel)] = sel
        msk[r, :len(sel)] = 1.0
    return idx, msk


def _round(U, V, r_, c_, v_, w, n_mini: int, cfg: SGDConfig):
    """One round's minibatches over its triplets (rows r_, cols c_,
    centered ratings v_, weights w), updating U and V in place."""
    for i in range(n_mini):
        s = slice(i * cfg.batch, (i + 1) * cfg.batch)
        r, c, wr = r_[s], c_[s], w[s]
        u = U.index_select(0, r)
        vt = V.index_select(0, c)
        err = ((u * vt).sum(-1) - v_[s]) * wr
        gu = err[:, None] * vt + cfg.reg * u * wr[:, None]
        gv = err[:, None] * u + cfg.reg * vt * wr[:, None]
        U.index_add_(0, r, gu, alpha=-cfg.lr)
        V.index_add_(0, c, gv, alpha=-cfg.lr)


def _graphed_round(U, V, bufs, n_mini: int, cfg: SGDConfig):
    """``_round`` on the static buffers ``bufs`` captured in a CUDA graph;
    returns the graph. Warm-up runs on copies of U and V (capture itself
    runs nothing), so the factors are untouched."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _round(U.clone(), V.clone(), *bufs, n_mini, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _round(U, V, *bufs, n_mini, cfg)
    return graph


def run_sgd(noise, train: COO, test_rows, test_cols, cfg: SGDConfig,
            device=None):
    """Returns (U, V, predictions of the test entries). Runs on ``device``
    (default: the GPU)."""
    dev = resolve_device(device)
    N, D = train.n_rows, train.n_cols
    U, V = init_factors(noise, N, D, cfg.K, dev, scale=0.3)
    rows = torch.as_tensor(train.row, device=dev).long()
    cols = torch.as_tensor(train.col, device=dev).long()
    vals = torch.as_tensor(train.val, device=dev)
    r_idx, r_msk = _block_schedule(train, cfg.n_blocks)
    r_idx = torch.as_tensor(r_idx, device=dev)
    r_msk = torch.as_tensor(r_msk, device=dev)
    mean = vals.mean()
    # each round's triplets, gathered once (exact, as per minibatch)
    per_round = [(rows[r_idx[r]], cols[r_idx[r]], vals[r_idx[r]] - mean,
                  r_msk[r]) for r in range(cfg.n_blocks)]
    n_mini = max(1, r_idx.shape[1] // cfg.batch)

    if dev.type == "cuda":
        bufs = tuple(t.clone() for t in per_round[0])
        graph = _graphed_round(U, V, bufs, n_mini, cfg)

        def run_round(data):
            for buf, t in zip(bufs, data):
                buf.copy_(t)
            graph.replay()
    else:
        def run_round(data):
            _round(U, V, *data, n_mini, cfg)

    for _ in range(cfg.n_epochs):
        for data in per_round:
            run_round(data)
    pred = BMF.predict(U, V, GIBBS._to(test_rows, dev),
                       GIBBS._to(test_cols, dev)) + mean
    return U, V, pred
