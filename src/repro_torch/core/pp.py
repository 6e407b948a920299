"""Posterior Propagation (PP) for BMF — the paper's algorithmic contribution
(port of ``repro.core.pp``).

Three phases over an I×J block grid (paper §2.2, Fig. 1):
  (a)   block (0,0): vanilla BMF with NW hyperpriors.
  (b)   first block-column (i,0) and block-row (0,j): the shared factor's
        prior is the phase-(a) posterior; the new factor keeps the NW
        hyperprior.
  (c)   remaining blocks (i,j): both factors receive propagated phase-(b)
        posteriors as priors.

Communication happens ONLY at the two phase boundaries: what moves between
blocks is O((N/I + D/J)·K²) posterior summaries. Orchestration lives in
``core.engine``; ``run_pp`` picks an executor — the serial reference loop,
the stacked executor (one batched chain per phase shape bucket), the
sharded executor (that batch split over a topology's device groups), or
the overlapped async and streaming executors — and a placement
(``core.topology.Topology``): device groups running blocks side by side,
each block's chain data-sharded over its group (``core.distributed``).

Aggregation (Qin et al. 2019): per factor row, the final posterior
multiplies the per-block posteriors (natural-parameter sums) and divides
away the (J-1 or I-1) multiply-counted propagated priors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import host_tensor, resolve_device, to_device
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.core.partition import Block, Partition
from repro_torch.core.posterior import RowGaussians
from repro_torch.data.sparse import (COO, PaddedCSR, coo_to_padded_csr,
                                     padded_csr_host)


@dataclass
class PPResult:
    rmse: float
    U_agg: RowGaussians              # aggregated posterior (permuted space)
    V_agg: RowGaussians
    per_block_rmse: np.ndarray       # (I, J)
    wall_time_s: float
    phase_times_s: Dict[str, float]
    n_test: int
    block_times_s: Dict[Tuple[int, int], float] = field(default_factory=dict)
    executor: str = "serial"
    # dispatch→resolve spans per block (overlapped executors only)
    block_spans_s: Dict[Tuple[int, int], Tuple[float, float]] = \
        field(default_factory=dict)
    # fault-tolerance ledger (engine.FaultRecord entries)
    faults: list = field(default_factory=list)
    resumed_blocks: int = 0
    group_stats: Dict[str, int] = field(default_factory=dict)
    # serving-export seam: U_agg/V_agg live in PERMUTED row/col space, so
    # the result carries the original->permuted maps plus tau and K
    row_perm: Optional[np.ndarray] = None
    col_perm: Optional[np.ndarray] = None
    tau: Optional[float] = None
    K: Optional[int] = None

    @property
    def n_retries(self) -> int:
        return sum(1 for f in self.faults if f.action == "retried")

    def _dep_graph(self):
        """Canonical PP dependency structure for this run's grid."""
        I, J = self.per_block_rmse.shape
        deps = {(0, 0): ()}
        deps.update({(i, 0): ((0, 0),) for i in range(1, I)})
        deps.update({(0, j): ((0, 0),) for j in range(1, J)})
        deps.update({(i, j): ((i, 0), (0, j))
                     for i in range(1, I) for j in range(1, J)})
        return deps

    def modeled_parallel_s(self, workers: int) -> float:
        """Wall-clock under the paper's deployment: a dependency-aware list
        schedule of the measured per-block times over ``workers``."""
        import heapq
        deps = self._dep_graph()
        succ: Dict[Tuple[int, int], list] = {c: [] for c in deps}
        for c, ds in deps.items():
            for d in ds:
                succ[d].append(c)
        dur = {c: self.block_times_s.get(c, 0.0) for c in deps}
        free = [0.0] * max(int(workers), 1)
        heapq.heapify(free)
        ready = [(0.0, (0, 0))]
        finish: Dict[Tuple[int, int], float] = {}
        while ready:
            ready_t, c = heapq.heappop(ready)
            start = max(heapq.heappop(free), ready_t)
            finish[c] = start + dur[c]
            heapq.heappush(free, finish[c])
            for s in succ[c]:
                if all(d in finish for d in deps[s]):
                    heapq.heappush(ready, (max(finish[d] for d in deps[s]), s))
        return max(finish.values(), default=0.0)

    def critical_path_s(self) -> float:
        """Longest dependency chain through the measured per-block times."""
        deps = self._dep_graph()
        memo: Dict[Tuple[int, int], float] = {}

        def cp(c):
            if c not in memo:
                memo[c] = (self.block_times_s.get(c, 0.0)
                           + max((cp(d) for d in deps[c]), default=0.0))
            return memo[c]

        return max((cp(c) for c in deps), default=0.0)


def _slice_prior(prior: RowGaussians, ids) -> RowGaussians:
    return RowGaussians(eta=prior.eta[ids], Lambda=prior.Lambda[ids])


def _block_test(test: COO, block: Block) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Test entries falling inside a block, in local coordinates."""
    sub = test.submatrix(block.row_ids, block.col_ids)
    return sub.row, sub.col, sub.val


@dataclass
class BlockShapes:
    """Common bucketed shapes so one stacked chain serves every block of a
    bucket. Buckets are PER PHASE (``per_phase``): phase-a / b_row / b_col
    / c blocks have systematically different occupancy, and tighter
    padding is compute as well as memory."""
    n_rows: int
    n_cols: int
    m_rows: int       # max nnz per user row
    m_cols: int       # max nnz per item row
    n_test: int

    def astuple(self) -> Tuple[int, int, int, int, int]:
        return (self.n_rows, self.n_cols, self.m_rows, self.m_cols,
                self.n_test)

    def block_bytes(self, K: int) -> int:
        """Device bytes ONE block occupies at this bucket's padding: CSR
        planes in both orientations, the four test vectors, both priors
        and the factor initializations."""
        csr = 3 * 4 * (self.n_rows * self.m_rows + self.n_cols * self.m_cols)
        tst = 4 * 4 * self.n_test        # tr, tc, tv, tmask
        priors = 4 * (self.n_rows + self.n_cols) * (K + K * K)
        factors = 4 * (self.n_rows + self.n_cols) * K
        return csr + tst + priors + factors

    @staticmethod
    def coalesce(per_phase: Dict[str, "BlockShapes"], K: int,
                 max_waste: float = 1.5) -> Dict[str, "BlockShapes"]:
        """Merge per-phase buckets whose padded footprints are within
        ``max_waste`` of each other; tags that coalesce share one
        ``BlockShapes`` instance."""
        from repro_torch.core.partition import coalesce_shapes
        merged = coalesce_shapes(
            {tag: s.astuple() for tag, s in per_phase.items()},
            footprint=lambda t: BlockShapes(*t).block_bytes(K),
            max_waste=max_waste)
        uniq: Dict[Tuple[int, ...], BlockShapes] = {}
        return {tag: uniq.setdefault(t, BlockShapes(*t))
                for tag, t in merged.items()}

    @staticmethod
    def of(part: Partition, test: Optional[COO],
           phases: Optional[Tuple[str, ...]] = None) -> "BlockShapes":
        """Max shapes over the partition's blocks (optionally restricted to
        the given ``Block.phase`` tags)."""
        def row_m(c: COO, n):
            return int(np.bincount(c.row, minlength=n).max()) if c.nnz else 1
        n_rows = m_r = m_c = n_cols = n_test = 1
        for b in part.all_blocks():
            if phases is not None and b.phase not in phases:
                continue
            n_rows = max(n_rows, len(b.row_ids))
            n_cols = max(n_cols, len(b.col_ids))
            m_r = max(m_r, row_m(b.coo, len(b.row_ids)))
            m_c = max(m_c, row_m(b.coo.transpose(), len(b.col_ids)))
            if test is not None:
                sub = test.submatrix(b.row_ids, b.col_ids)
                n_test = max(n_test, sub.nnz)
        return BlockShapes(n_rows=n_rows, n_cols=n_cols, m_rows=m_r,
                           m_cols=m_c, n_test=n_test)

    @staticmethod
    def per_phase(part: Partition, test: Optional[COO]
                  ) -> Dict[str, "BlockShapes"]:
        """One occupancy bucket per phase tag present in the partition."""
        tags = {b.phase for b in part.all_blocks()}
        return {ph: BlockShapes.of(part, test, phases=(ph,)) for ph in tags}


def _pad_prior(prior: Optional[RowGaussians], n: int, K: int):
    if prior is None:
        return None
    pad = n - prior.eta.shape[0]
    if pad <= 0:
        return prior
    eta = torch.cat([prior.eta, prior.eta.new_zeros((pad, K))])
    eye = torch.eye(K, dtype=prior.Lambda.dtype, device=prior.Lambda.device)
    Lam = torch.cat([prior.Lambda, eye.expand(pad, K, K)])
    return RowGaussians(eta=eta, Lambda=Lam)


def _test_entries(block: Block, shapes: BlockShapes, test: Optional[COO]):
    """(tr, tc, tv, tmask) numpy vectors padded to the bucket's n_test."""
    if test is not None:
        tr, tc, tv_raw = _block_test(test, block)
    else:
        tr = np.zeros((0,), np.int32)
        tc = np.zeros((0,), np.int32)
        tv_raw = np.zeros((0,), np.float32)
    n = min(len(tr), shapes.n_test)

    def padded(arr, dtype):
        out = np.zeros((shapes.n_test,), dtype)
        out[:n] = arr[:n]
        return out

    tmask = np.zeros((shapes.n_test,), np.float32)
    tmask[:n] = 1.0
    return (padded(tr, np.int32), padded(tc, np.int32),
            padded(tv_raw.astype(np.float32), np.float32), tmask)


def pad_block_inputs_host(block: Block, shapes: BlockShapes,
                          test: Optional[COO], poison_nan: bool = False):
    """Host-side (numpy) padding of one block's CSR planes and test
    entries to a shape bucket. Returns ``(csr_rows, csr_cols, tr, tc, tv,
    tmask)`` with numpy leaves, equal to the reference's.

    ``poison_nan``: the fault-injection seam (``engine.FaultPlan``):
    NaN-fill the rating planes, so the chain goes non-finite and its
    health guard trips — the failure surface of a real diverged chain."""
    csr_rows = coo_to_padded_csr(block.coo, max_nnz=shapes.m_rows,
                                 n_rows_pad=shapes.n_rows,
                                 n_cols_pad=shapes.n_cols, as_numpy=True)
    csr_cols = coo_to_padded_csr(block.coo.transpose(),
                                 max_nnz=shapes.m_cols,
                                 n_rows_pad=shapes.n_cols,
                                 n_cols_pad=shapes.n_rows, as_numpy=True)
    if poison_nan:
        csr_rows.val[:] = np.nan
        csr_cols.val[:] = np.nan
    return (csr_rows, csr_cols) + _test_entries(block, shapes, test)


def new_block_inputs(shapes: BlockShapes, K: int, batch: int, device,
                     u_prior: bool, v_prior: bool) -> dict:
    """Zeroed device buffers for ``batch`` blocks of one bucket; the
    blocks' data is written into their slices by ``fill_block_inputs``."""
    s = shapes
    # the slot layout pads M to a multiple of 8, as coo_to_padded_csr does
    m_r, m_c = -(-s.m_rows // 8) * 8, -(-s.m_cols // 8) * 8

    def z(shape, dtype=torch.float32):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    buf = dict(idx_r=z((s.n_rows, m_r), torch.int32), val_r=z((s.n_rows, m_r)),
               mask_r=z((s.n_rows, m_r)),
               idx_c=z((s.n_cols, m_c), torch.int32), val_c=z((s.n_cols, m_c)),
               mask_c=z((s.n_cols, m_c)),
               tr=z((s.n_test,), torch.int32), tc=z((s.n_test,), torch.int32),
               tv=z((s.n_test,)), tmask=z((s.n_test,)))
    if u_prior:
        buf.update(up_eta=z((s.n_rows, K)), up_lam=z((s.n_rows, K, K)))
    if v_prior:
        buf.update(vp_eta=z((s.n_cols, K)), vp_lam=z((s.n_cols, K, K)))
    return buf


def csr_entries(coo: COO, m: int, n_pad: int, n_cols: int):
    """The padded CSR of ``coo`` as its live entries: (flat slot
    ``row·M + slot`` (int64), column id, value) on the host, O(nnz), with
    the reference's slot layout and M the bucket's ``m`` rounded up to 8
    (``padded_csr_host``)."""
    r, s, c, v, (_, M) = padded_csr_host(coo, max_nnz=m, n_rows_pad=n_pad,
                                         n_cols=n_cols)
    return r.astype(np.int64) * M + s, c, v


def scatter_entries(idx, val, mask, lin, col, v):
    """Write entries (``csr_entries``, already on the planes' device) into
    zeroed planes: the dense planes never exist on the host."""
    idx.view(-1).index_put_((lin,), col)
    val.view(-1).index_put_((lin,), v)
    mask.view(-1).index_fill_(0, lin, 1.0)


def _fill_csr(coo: COO, m: int, n_pad: int, n_cols: int, idx, val, mask):
    """Write the padded CSR of ``coo`` into zeroed device planes. The
    entries move by non-blocking copies, so filling never waits for the
    card."""
    dev = idx.device
    scatter_entries(idx, val, mask,
                    *(to_device(a, dev) for a in csr_entries(coo, m, n_pad,
                                                             n_cols)))


def fill_block_inputs(buf: dict, b: int, block: Block, shapes: BlockShapes,
                      test: Optional[COO],
                      U_prior: Optional[RowGaussians] = None,
                      V_prior: Optional[RowGaussians] = None) -> int:
    """Pad block ``block`` into slot ``b`` of the buffers of
    ``new_block_inputs`` — the single source of truth for bucket padding,
    shared by ``run_block`` (serial), the stacked executor and the async
    executor. Returns the block's test-entry count (host int). Never
    waits for the device."""
    s = shapes
    _fill_csr(block.coo, s.m_rows, s.n_rows, s.n_cols, buf["idx_r"][b],
              buf["val_r"][b], buf["mask_r"][b])
    _fill_csr(block.coo.transpose(), s.m_cols, s.n_cols, s.n_rows,
              buf["idx_c"][b], buf["val_c"][b], buf["mask_c"][b])
    entries = _test_entries(block, s, test)
    for name, arr in zip(("tr", "tc", "tv", "tmask"), entries):
        buf[name][b].copy_(host_tensor(arr, buf[name].device),
                           non_blocking=True)
    for key, prior in (("up", U_prior), ("vp", V_prior)):
        if prior is None:
            continue
        n = prior.eta.shape[0]
        eta, lam = buf[key + "_eta"][b], buf[key + "_lam"][b]
        eta[:n].copy_(prior.eta)
        lam[:n].copy_(prior.Lambda)
        # pad rows carry N(0, I): finite and never read back
        lam[n:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return int(entries[3].sum())


def poison_block_inputs(buf: dict, b: int):
    """The fault-injection seam on the device buffers: NaN-fill slot
    ``b``'s rating planes, as ``pad_block_inputs_host(poison_nan=True)``
    does on the host."""
    buf["val_r"][b].fill_(float("nan"))
    buf["val_c"][b].fill_(float("nan"))


def unpack_block_inputs(buf: dict, s: BlockShapes):
    """(csr_rows, csr_cols, tr, tc, tv, tmask, U_prior, V_prior) views of
    the buffers, with the leading batch axis."""
    def prior(key):
        if key + "_eta" not in buf:
            return None
        return RowGaussians(eta=buf[key + "_eta"], Lambda=buf[key + "_lam"])
    return (PaddedCSR(buf["idx_r"], buf["val_r"], buf["mask_r"], s.n_cols),
            PaddedCSR(buf["idx_c"], buf["val_c"], buf["mask_c"], s.n_rows),
            buf["tr"], buf["tc"], buf["tv"], buf["tmask"],
            prior("up"), prior("vp"))


def pad_block_inputs(block: Block, shapes: BlockShapes, K: int,
                     test: Optional[COO],
                     U_prior: Optional[RowGaussians],
                     V_prior: Optional[RowGaussians], device=None,
                     poison_nan: bool = False):
    """Pad one block's CSR planes, priors and test entries to its phase
    shape bucket, on ``device``, without waiting for the device. Returns
    ``(csr_rows, csr_cols, tr, tc, tv, tmask, U_prior, V_prior)`` without
    a batch axis. ``poison_nan``: as in ``pad_block_inputs_host``."""
    return pad_block_inputs_n(block, shapes, K, test, U_prior, V_prior,
                              device, poison_nan)[0]


def pad_block_inputs_n(block: Block, shapes: BlockShapes, K: int,
                       test: Optional[COO],
                       U_prior: Optional[RowGaussians],
                       V_prior: Optional[RowGaussians], device=None,
                       poison_nan: bool = False):
    """``(pad_block_inputs(...), n_test)``: the block's test-entry count
    as a host int, so no caller reads it back from the device."""
    dev = resolve_device(device)
    buf = new_block_inputs(shapes, K, 1, dev, U_prior is not None,
                           V_prior is not None)
    n = fill_block_inputs(buf, 0, block, shapes, test, U_prior, V_prior)
    if poison_nan:
        poison_block_inputs(buf, 0)
    return (GIBBS.tree_map(lambda x: x[0], unpack_block_inputs(buf, shapes)),
            n)


def run_block(noise, block: Block, cfg: BMF.BMFConfig,
              test: Optional[COO],
              U_prior: Optional[RowGaussians],
              V_prior: Optional[RowGaussians],
              shapes: Optional[BlockShapes] = None,
              device=None, poison_nan: bool = False,
              distributed_mesh=None) -> GIBBS.GibbsResult:
    """Gibbs on one block; ``noise`` is its seed or a batch-1 source.
    ``distributed_mesh``: a one-group ``Topology(1, S)`` whose S slots
    share the chain (``distributed.run_gibbs_distributed``, 'psum')."""
    dev = resolve_device(device)
    if shapes is None:
        csr_rows = coo_to_padded_csr(block.coo, device=dev)
        csr_cols = coo_to_padded_csr(block.coo.transpose(), device=dev)
        if poison_nan:
            csr_rows.val.fill_(float("nan"))
            csr_cols.val.fill_(float("nan"))
        if test is not None:
            tr, tc, _ = _block_test(test, block)
        else:
            tr = np.zeros((1,), np.int32)
            tc = np.zeros((1,), np.int32)
    else:
        csr_rows, csr_cols, tr, tc, _, _, U_prior, V_prior = \
            pad_block_inputs(block, shapes, cfg.K, test, U_prior, V_prior,
                             device=dev, poison_nan=poison_nan)
    if distributed_mesh is not None:
        from repro_torch.core import distributed as DIST
        return DIST.run_gibbs_distributed(noise, csr_rows, csr_cols, tr, tc,
                                          cfg, distributed_mesh,
                                          U_prior=U_prior, V_prior=V_prior)
    return GIBBS.run_gibbs(noise, csr_rows, csr_cols, tr, tc, cfg,
                           U_prior=U_prior, V_prior=V_prior, device=dev)


def run_pp(seed: int, part: Partition, cfg: BMF.BMFConfig, test: COO,
           verbose: bool = False, executor="serial",
           on_fault: str = "raise", max_retries: int = 2,
           fault_policy=None, device=None, noise=None,
           distributed_mesh=None, block_mesh=None, window=None,
           topology=None, fault_plan=None, checkpoint_dir=None,
           ckpt_every: int = 1, resume_from=None, comm=None) -> PPResult:
    """Full three-phase Posterior Propagation over the partition, through
    the phase-graph engine (``core.engine``).

    seed: the run's seed; block (i, j) draws from a generator seeded by
      (seed, i, j) (``noise.block_seed``), so its chain is the same under
      every executor.
    executor: "serial" (reference: one chain per block), "stacked" (one
      batched chain per phase shape bucket), "sharded" (that batch split
      over the topology's device groups), "async" (each block
      dispatched the moment its prior sources resolve; phases b and c
      overlap), "streaming" (chunks of ``window`` blocks through a bounded
      window of device buffers, the next chunk copied in while the
      current one computes), or an ``engine.Executor``.
    window: the streaming executor's window size W (default 4).
    on_fault / max_retries / fault_policy: the chain-health guard's policy
      (``engine.FaultPolicy``).
    fault_plan: deterministic fault injection (``engine.FaultPlan``):
      NaN'd chains, hung and failed dispatches by coord and attempt.
    checkpoint_dir: persist each resolved block's posteriors through
      ``checkpoint.ckpt.PPCheckpoint`` (every ``ckpt_every`` resolves).
    resume_from: a checkpoint directory of an earlier run with the same
      seed, grid, K and chain: its blocks are restored, not re-run, and
      the finished run is bitwise identical to an uninterrupted one.
    device: where the run lives (default: the GPU; raises without one).
    noise: optional ``callable([(coord, attempt), ...]) -> noise source``
      replacing the per-block generators (the tests replay the reference's
      key schedule through it).

    topology: the placement (``core.topology.Topology``, a ``(block,
      data)`` pair or a device sequence): ``block`` device groups run
      blocks concurrently (on one GPU: streams), ``data`` slots share each
      block's chain (``core.distributed``). Consumed by serial (block must
      be 1), sharded, async (group streams) and streaming (a window per
      group); e.g. ``run_pp(..., executor="sharded",
      topology=Topology(2, 2), comm="psum")``.
    comm: the intra-block exchange at ``data > 1``: 'gather' (default),
      'psum' or 'scatter' (``distributed.COMM_MODES``; streaming takes
      'gather' only).
    distributed_mesh: legacy spelling of ``topology=Topology(1, S)`` (an
      int S, S devices or the topology): intra-block sharding only, forces
      the serial executor. ``block_mesh``: legacy one-slot-per-group
      placement (a device sequence) for the sharded and async executors."""
    from repro_torch.core import engine as ENG
    if int(max_retries) < 0:
        raise ValueError(f"max_retries must be >= 0, got {max_retries}")
    if on_fault not in ("raise", "degrade"):
        raise ValueError(f"on_fault must be 'raise' or 'degrade', "
                         f"got {on_fault!r}")
    if int(ckpt_every) < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    if fault_policy is None:
        fault_policy = ENG.FaultPolicy(on_fault=on_fault,
                                       max_retries=int(max_retries))
    ex = ENG.make_executor(executor, window=window,
                           distributed_mesh=distributed_mesh,
                           block_mesh=block_mesh, topology=topology,
                           comm=comm)
    return ENG.run_phase_graph(seed, part, cfg, test, ex, verbose=verbose,
                               policy=fault_policy, device=device,
                               noise=noise, fault_plan=fault_plan,
                               checkpoint_dir=checkpoint_dir,
                               ckpt_every=int(ckpt_every),
                               resume_from=resume_from)


def _aggregate_axis(part: Partition, posts, axis: str) -> RowGaussians:
    """Combine per-block posteriors for one factor.

    For U row-group i: posterior from blocks (i, 0..J-1); blocks 1..J-1 in
    that row all received the same propagated prior (the phase-b posterior
    of U^(i) — or phase-a for i=0), counted J times in the product, so J-1
    copies are divided away (Qin et al. 2019, eq. 5). Everything stays on
    the device."""
    I, J = part.I, part.J
    if len(posts) != I or len(posts[0]) != J:
        raise ValueError(f"posteriors {len(posts)}x{len(posts[0])} do not "
                         f"match the {I}x{J} grid")
    out_eta, out_lam = [], []
    groups = ([[posts[i][j] for j in range(J)] for i in range(I)]
              if axis == "row" else
              [[posts[i][j] for i in range(I)] for j in range(J)])
    for grp in groups:
        n_div = len(grp) - 1
        prior = grp[0]                 # the propagated one for this group
        out_eta.append(torch.stack([p.eta for p in grp]).sum(0)
                       - n_div * prior.eta)
        out_lam.append(torch.stack([p.Lambda for p in grp]).sum(0)
                       - n_div * prior.Lambda)
    return RowGaussians(eta=torch.cat(out_eta), Lambda=torch.cat(out_lam))


def run_full_bmf(seed, train: COO, test: COO, cfg: BMF.BMFConfig,
                 device=None):
    """1×1 'partition' — the vanilla BMF baseline (paper Table 3 column
    BMF). ``seed``: an int or a batch-1 noise source."""
    dev = resolve_device(device)
    csr_rows = coo_to_padded_csr(train, device=dev)
    csr_cols = coo_to_padded_csr(train.transpose(), device=dev)
    t0 = time.time()
    res = GIBBS.run_gibbs(seed, csr_rows, csr_cols, test.row, test.col, cfg,
                          device=dev)
    rmse = float(GIBBS.rmse_from_acc(res.acc, test.val))
    return rmse, time.time() - t0, res
