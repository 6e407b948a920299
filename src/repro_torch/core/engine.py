"""Phase-graph execution engine for Posterior Propagation (port of the
serial and stacked half of ``repro.core.engine``).

The paper's §2.2 structure is a three-phase DAG over the I×J block grid:
phase (a) is block (0,0); phase (b) is the first block-row and block-column,
depending only on (a); phase (c) is the interior, depending only on (b).
Within a phase, blocks are embarrassingly parallel.

  SerialExecutor   reference semantics: one chain per block, synchronised
                   after each.
  StackedExecutor  stacks all blocks of a phase shape bucket along a leading
                   axis and runs ONE batched chain per bucket
                   (``gibbs.run_gibbs_stacked``); the kernels take the
                   block axis directly.

Executor contract: ``run_graph(ctx, graph, verbose) -> (outcomes,
phase_times_s, spans)`` writes each block's posterior summaries into
``ctx.U_posts`` / ``ctx.V_posts`` before any dependent reads them; the
default barrier implementation runs ``run_phase`` once per phase.
``run_phase_graph`` owns RMSE accumulation and the divide-away
aggregation.

Fault tolerance: every resolved block passes the chain-health guard
(``_commit_guard``): an unhealthy chain retries through one shared
single-block runner (fresh seed, jittered prior), then degrades to its
propagated prior or raises per ``FaultPolicy``.

Not ported yet (ROADMAP §A): the sharded, async and streaming executors,
``FaultPlan`` injection, checkpoint/resume, and device topologies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.trace_passes import check_graph
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import pp as PP
from repro_torch.core.partition import Partition
from repro_torch.core.posterior import RowGaussians
from repro_torch.data.sparse import COO, apply_permutation
from repro_torch.noise import GeneratorNoise, block_seed

Coord = Tuple[int, int]

# stable intra-phase bucket order (phase b runs its two buckets back to back)
_TAG_ORDER = ("a", "b_row", "b_col", "c")

# runtime failures a dispatch may raise that the engine treats as a block
# fault (retried through the shared runner) rather than a bug
_DISPATCH_ERRORS = (torch.cuda.OutOfMemoryError,)


class BlockFaultError(RuntimeError):
    """A block exhausted its retry budget under ``on_fault == 'raise'``."""


@dataclass(frozen=True)
class FaultPolicy:
    """What the engine does when a block goes bad.

    on_fault: after ``max_retries`` failed re-runs — "raise"
      (``BlockFaultError``) or "degrade" (posterior := the block's
      propagated prior, which cancels exactly in the divide-away
      aggregation; its test entries drop out of the RMSE).
    max_retries: bounded re-runs; retry ``a`` draws from a fresh seed
      (``noise.block_seed(seed, i, j, a)``) with the prior precision
      inflated by ``retry_jitter·a·I``.
    rmse_max: optional divergence threshold on a block's own test RMSE.

    ``watchdog``, ``timeout_*``, ``quarantine_after``, ``speculate_at``,
    ``min_groups`` and ``on_group_fault`` are validated as in the
    reference but only the async/streaming executors, not ported yet,
    read them."""
    on_fault: str = "raise"
    max_retries: int = 2
    rmse_max: Optional[float] = None
    retry_jitter: float = 1e-3
    watchdog: bool = True
    timeout_floor_s: float = 60.0
    timeout_slack: float = 10.0
    quarantine_after: int = 3
    speculate_at: float = 0.0
    min_groups: int = 1
    on_group_fault: str = "raise"

    def __post_init__(self):
        if self.on_fault not in ("raise", "degrade"):
            raise ValueError(f"on_fault must be 'raise' or 'degrade', "
                             f"got {self.on_fault!r}")
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.on_group_fault not in ("raise", "continue"):
            raise ValueError(f"on_group_fault must be 'raise' or "
                             f"'continue', got {self.on_group_fault!r}")
        if int(self.quarantine_after) < 1:
            raise ValueError(f"quarantine_after must be >= 1, "
                             f"got {self.quarantine_after}")
        if int(self.min_groups) < 1:
            raise ValueError(f"min_groups must be >= 1, "
                             f"got {self.min_groups}")
        if float(self.speculate_at) < 0:
            raise ValueError(f"speculate_at must be >= 0 (0 disables), "
                             f"got {self.speculate_at}")


@dataclass(frozen=True)
class FaultRecord:
    """One ledger entry in ``PPResult.faults``."""
    coord: Coord
    kind: str        # "nonfinite" | "rmse" | "dispatch"
    attempt: int
    action: str      # "retried" | "degraded" | "raised"


@dataclass(frozen=True)
class BlockTask:
    """One node of the PP phase graph. ``u_prior_from`` / ``v_prior_from``
    name the block whose U / V posterior is this block's prior (None = NW
    hyperprior)."""
    i: int
    j: int
    phase: str
    u_prior_from: Optional[Coord]
    v_prior_from: Optional[Coord]

    @property
    def coord(self) -> Coord:
        return (self.i, self.j)

    @property
    def deps(self) -> Tuple[Coord, ...]:
        return tuple(c for c in (self.u_prior_from, self.v_prior_from)
                     if c is not None)


def build_phase_graph(part: Partition) -> List[Tuple[str, List[BlockTask]]]:
    """The paper's three-phase DAG: [(phase_name, tasks)] in execution
    order. Every task's deps live in strictly earlier phases."""
    I, J = part.I, part.J
    phase_a = [BlockTask(0, 0, "a", None, None)]
    phase_b = ([BlockTask(i, 0, "b_row", None, (0, 0)) for i in range(1, I)]
               + [BlockTask(0, j, "b_col", (0, 0), None) for j in range(1, J)])
    phase_c = [BlockTask(i, j, "c", (i, 0), (0, j))
               for i in range(1, I) for j in range(1, J)]
    return [(name, tasks) for name, tasks in
            (("a", phase_a), ("b", phase_b), ("c", phase_c)) if tasks]


NoiseFactory = Callable[[Sequence[Tuple[Coord, int]]], object]


@dataclass
class PhaseContext:
    """Run state shared with executors: inputs (partition, config, permuted
    test set, shape buckets, device, noise) plus the posterior store that
    carries device-resident summaries across phase boundaries."""
    part: Partition
    cfg: BMF.BMFConfig
    test_p: COO
    seed: int
    shapes: Dict[str, "PP.BlockShapes"]
    device: torch.device
    noise: Optional[NoiseFactory] = None
    U_posts: Dict[Coord, RowGaussians] = field(default_factory=dict)
    V_posts: Dict[Coord, RowGaussians] = field(default_factory=dict)
    policy: FaultPolicy = field(default_factory=FaultPolicy)
    attempts: Dict[Coord, int] = field(default_factory=dict)
    faults: List[FaultRecord] = field(default_factory=list)

    def block_cfg(self, task: BlockTask) -> BMF.BMFConfig:
        """Reduced chains for phases b/c when cfg.phase_bc_samples is set."""
        cfg = self.cfg
        if cfg.phase_bc_samples and task.phase != "a":
            return cfg._replace(n_samples=cfg.phase_bc_samples,
                                burnin=max(2, cfg.phase_bc_samples // 4))
        return cfg

    def priors(self, task: BlockTask):
        up = self.U_posts[task.u_prior_from] if task.u_prior_from else None
        vp = self.V_posts[task.v_prior_from] if task.v_prior_from else None
        return up, vp

    def cur_attempt(self, c: Coord) -> int:
        return self.attempts.get(c, 0)

    def noise_for(self, blocks: Sequence[Tuple[Coord, int]]):
        """The noise source of a batch of (coord, attempt) blocks — one
        generator per block seeded by (run seed, coord, attempt), unless
        the run was given a factory. A block's draws depend only on its own
        entry, so chains are executor-independent."""
        if self.noise is not None:
            return self.noise(list(blocks))
        return GeneratorNoise([block_seed(self.seed, c[0], c[1], a)
                               for c, a in blocks], self.device)

    def record_fault(self, c: Coord, kind: str, action: str):
        self.faults.append(FaultRecord(coord=c, kind=kind,
                                       attempt=self.cur_attempt(c),
                                       action=action))


@dataclass
class BlockOutcome:
    U_post: RowGaussians       # trimmed to the block's true row count
    V_post: RowGaussians       # trimmed to the block's true col count
    # (bucket n_test,) posterior-mean predictions, or None when the
    # squared error arrives through sq_err
    pred_mean: Optional[np.ndarray]
    seconds: float
    sq_err: Optional[torch.Tensor] = None
    n_obs: int = 0
    health: Optional[torch.Tensor] = None


def _trim(p: RowGaussians, n: int) -> RowGaussians:
    return RowGaussians(eta=p.eta[:n], Lambda=p.Lambda[:n])


def _outcome(res: GIBBS.GibbsResult, blk, seconds: float) -> BlockOutcome:
    nr, nc = len(blk.row_ids), len(blk.col_ids)
    pred = (res.acc.pred_sum / torch.clamp(res.acc.pred_cnt, min=1.0)).cpu()
    return BlockOutcome(U_post=_trim(res.U_post, nr),
                        V_post=_trim(res.V_post, nc),
                        pred_mean=pred.numpy(), seconds=seconds,
                        health=res.health)


def _block_sq_err(pred_sum, pred_cnt, vals, mask):
    """Masked Σ(pred-val)² — the per-block RMSE scalar, on the device."""
    err = (pred_sum / torch.clamp(pred_cnt, min=1.0) - vals) * mask
    return torch.dot(err, err)


def _host_sq(ctx: PhaseContext, task: BlockTask,
             o: BlockOutcome) -> Tuple[int, float]:
    """One block's (n_test, Σ(pred-val)²) as host scalars."""
    if o.sq_err is not None:
        return o.n_obs, float(o.sq_err)
    blk = ctx.part.block(task.i, task.j)
    _, _, tv = PP._block_test(ctx.test_p, blk)
    n = len(tv)
    sq = float(np.sum((np.asarray(o.pred_mean[:n]) - tv) ** 2)) if n else 0.0
    return n, sq


def _fault_kind(ctx: PhaseContext, task: BlockTask,
                o: BlockOutcome) -> Optional[str]:
    """Health verdict on a resolved outcome: None = healthy, else the
    fault kind. Checked BEFORE the posterior feeds any successor."""
    if o.health is not None and not bool(o.health):
        return "nonfinite"
    if ctx.policy.rmse_max is not None:
        n, sq = _host_sq(ctx, task, o)
        # `not <=` also trips on a NaN sq
        if n and not (sq <= (ctx.policy.rmse_max ** 2) * n):
            return "rmse"
    return None


def _jitter_prior(p: Optional[RowGaussians],
                  eps: float) -> Optional[RowGaussians]:
    """Precision-inflate a retry's prior: Λ + eps·I."""
    if p is None or not eps:
        return p
    K = p.eta.shape[-1]
    return RowGaussians(eta=p.eta, Lambda=p.Lambda + eps * torch.eye(
        K, dtype=p.Lambda.dtype, device=p.Lambda.device))


def _run_block_attempt(ctx: PhaseContext, task: BlockTask,
                       attempt: int) -> BlockOutcome:
    """The shared retry runner: one single-block chain with the attempt's
    seed and jittered prior, whichever executor hit the fault."""
    c = task.coord
    blk = ctx.part.block(task.i, task.j)
    up, vp = ctx.priors(task)
    csr_r, csr_c, tr, tc, tv, tmask, up_p, vp_p = PP.pad_block_inputs(
        blk, ctx.shapes[task.phase], ctx.cfg.K, ctx.test_p, up, vp,
        device=ctx.device)
    eps = ctx.policy.retry_jitter * attempt
    res = GIBBS.run_gibbs(ctx.noise_for([(c, attempt)]), csr_r, csr_c, tr, tc,
                          ctx.block_cfg(task),
                          U_prior=_jitter_prior(up_p, eps),
                          V_prior=_jitter_prior(vp_p, eps),
                          device=ctx.device)
    nr, nc = len(blk.row_ids), len(blk.col_ids)
    sq = _block_sq_err(res.acc.pred_sum, res.acc.pred_cnt, tv, tmask)
    return BlockOutcome(U_post=_trim(res.U_post, nr),
                        V_post=_trim(res.V_post, nc), pred_mean=None,
                        seconds=0.0, sq_err=sq, n_obs=int(tmask.sum()),
                        health=res.health)


def _dummy_prior(n: int, K: int, device) -> RowGaussians:
    """N(0, I) rows: a degraded block's posterior where it had no prior."""
    return RowGaussians(
        eta=torch.zeros((n, K), device=device),
        Lambda=torch.eye(K, device=device).expand(n, K, K).contiguous())


def _degrade_outcome(ctx: PhaseContext, task: BlockTask) -> BlockOutcome:
    """on_fault='degrade': the block's posterior becomes its propagated
    prior (N(0, I) where it had none), which cancels exactly in the
    divide-away aggregation; its test entries leave the RMSE."""
    blk = ctx.part.block(task.i, task.j)
    up, vp = ctx.priors(task)
    K = ctx.cfg.K
    return BlockOutcome(
        U_post=up if up is not None else _dummy_prior(len(blk.row_ids), K,
                                                      ctx.device),
        V_post=vp if vp is not None else _dummy_prior(len(blk.col_ids), K,
                                                      ctx.device),
        pred_mean=None, seconds=0.0,
        sq_err=torch.zeros((), device=ctx.device), n_obs=0,
        health=torch.ones((), dtype=torch.bool, device=ctx.device))


def _commit_guard(ctx: PhaseContext, task: BlockTask,
                  out: Optional[BlockOutcome],
                  kind: Optional[str] = None) -> BlockOutcome:
    """The chain-health guard, applied to every block at resolve time.

    Healthy outcome → returned untouched (one device→host bool read).
    Faulty outcome (or ``kind`` pre-set by a dispatch failure) → bounded
    retries through ``_run_block_attempt``, then degrade or raise per
    ``ctx.policy``. The posterior store is rewritten before returning
    whenever the outcome changes."""
    c = task.coord
    if kind is None:
        if out is None:
            raise AssertionError(f"block {c}: no outcome and no fault kind")
        kind = _fault_kind(ctx, task, out)
        if kind is None:
            return out
    pol = ctx.policy
    t0 = time.time()
    while ctx.cur_attempt(c) < pol.max_retries:
        attempt = ctx.cur_attempt(c) + 1
        ctx.record_fault(c, kind, "retried")
        ctx.attempts[c] = attempt
        try:
            out = _run_block_attempt(ctx, task, attempt)
            kind = _fault_kind(ctx, task, out)
        except _DISPATCH_ERRORS:
            kind = "dispatch"
            continue
        if kind is None:
            out.seconds = time.time() - t0
            ctx.U_posts[c], ctx.V_posts[c] = out.U_post, out.V_post
            return out
    if pol.on_fault == "degrade":
        ctx.record_fault(c, kind, "degraded")
        out = _degrade_outcome(ctx, task)
        ctx.U_posts[c], ctx.V_posts[c] = out.U_post, out.V_post
        return out
    ctx.record_fault(c, kind, "raised")
    raise BlockFaultError(
        f"block {c}: {kind} fault after {ctx.cur_attempt(c)} of "
        f"{pol.max_retries} retries (on_fault='raise'; pass "
        f"on_fault='degrade' to fall back to the propagated prior)")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """Runs the PP phase graph; subclasses choose the schedule.

    ``record_trace=True`` records (event, coord) entries in real order:
    "dispatch" when a block's chain is handed to the device (its priors
    were read), "resolve" when its results were observed complete.
    ``timings`` holds the last run's seconds per layer where the executor
    can split them: "pad_s" (host padding and the copy to the device) and
    "chain_s" (the Gibbs chains), each ending in a device sync."""
    name = "base"

    def __init__(self, record_trace: bool = False):
        self.record_trace = record_trace
        self.trace: List[Tuple] = []
        self.timings: Dict[str, float] = {}

    def _reset_run_state(self):
        self.trace = []
        self.timings = {"pad_s": 0.0, "chain_s": 0.0}

    def _record(self, event: str, coord: Coord):
        if self.record_trace:
            self.trace.append((event, coord))

    def run_phase(self, ctx: PhaseContext, phase: str,
                  tasks: Sequence[BlockTask]) -> Dict[Coord, BlockOutcome]:
        raise NotImplementedError

    def run_graph(self, ctx: PhaseContext, graph, verbose: bool = False):
        """Default barrier schedule: phases strictly in order, posterior
        store updated at the phase boundary. Returns ``(outcomes,
        phase_times_s, spans)``; spans is empty."""
        self._reset_run_state()
        outcomes: Dict[Coord, BlockOutcome] = {}
        phase_times: Dict[str, float] = {}
        for phase, tasks in graph:
            missing = {d for t in tasks for d in t.deps} - set(ctx.U_posts)
            if missing:
                raise RuntimeError(f"phase {phase} scheduled before "
                                   f"{missing} resolved")
            t0 = time.time()
            outs = self.run_phase(ctx, phase, tasks)
            dropped = {t.coord for t in tasks} - set(outs)
            if dropped:
                raise RuntimeError(f"executor {self.name} dropped blocks "
                                   f"{dropped}")
            for t in tasks:
                # chain-health guard BEFORE the posterior reaches the store
                o = _commit_guard(ctx, t, outs[t.coord])
                outs[t.coord] = o
                ctx.U_posts[t.coord] = o.U_post
                ctx.V_posts[t.coord] = o.V_post
            dt = time.time() - t0
            phase_times[phase] = dt
            outcomes.update(outs)
            if verbose:
                print(f"[pp:{self.name}] phase {phase}: {len(tasks)} "
                      f"block(s) {_phase_desc(ctx, tasks)} {dt:.2f}s",
                      flush=True)
        return outcomes, phase_times, {}


def _phase_desc(ctx: PhaseContext, tasks: Sequence[BlockTask]) -> str:
    tags = [g for g in _TAG_ORDER if any(t.phase == g for t in tasks)]
    return " ".join(
        f"{g}[{sum(1 for t in tasks if t.phase == g)}blk "
        f"{ctx.shapes[g].n_rows}x{ctx.shapes[g].n_cols} "
        f"m={ctx.shapes[g].m_rows}/{ctx.shapes[g].m_cols}]" for g in tags)


class SerialExecutor(Executor):
    """One chain per block, synchronised after each (reference
    semantics)."""
    name = "serial"

    def run_phase(self, ctx, phase, tasks):
        out: Dict[Coord, BlockOutcome] = {}
        for t in tasks:
            blk = ctx.part.block(t.i, t.j)
            up, vp = ctx.priors(t)
            self._record("dispatch", t.coord)
            t0 = time.time()
            try:
                res = PP.run_block(ctx.noise_for([(t.coord, 0)]), blk,
                                   ctx.block_cfg(t), ctx.test_p, up, vp,
                                   shapes=ctx.shapes[t.phase],
                                   device=ctx.device)
                _sync(ctx.device)
                self._record("resolve", t.coord)
                out[t.coord] = _outcome(res, blk, time.time() - t0)
            except _DISPATCH_ERRORS:
                self._record("resolve", t.coord)
                out[t.coord] = _commit_guard(ctx, t, None, kind="dispatch")
        return out


class StackedExecutor(Executor):
    """One batched chain per phase shape bucket: all blocks of the bucket
    run along a leading block axis. The bucket's device buffers are
    allocated once and each block is padded straight into its slice."""
    name = "stacked"

    def run_phase(self, ctx, phase, tasks):
        out: Dict[Coord, BlockOutcome] = {}
        for tag in _TAG_ORDER:
            group = [t for t in tasks if t.phase == tag]
            if group:
                out.update(self._run_bucket(ctx, tag, group))
        return out

    def _run_bucket(self, ctx, tag, group):
        s = ctx.shapes[tag]
        t0 = time.time()
        for t in group:
            self._record("dispatch", t.coord)
        priors = [ctx.priors(t) for t in group]
        t_pad = time.time()
        buf = PP.new_block_inputs(s, ctx.cfg.K, len(group), ctx.device,
                                  priors[0][0] is not None,
                                  priors[0][1] is not None)
        for b, (t, (up, vp)) in enumerate(zip(group, priors)):
            PP.fill_block_inputs(buf, b, ctx.part.block(t.i, t.j), s,
                                 ctx.test_p, up, vp)
        csr_r, csr_c, tr, tc, _, _, up, vp = PP.unpack_block_inputs(buf, s)
        _sync(ctx.device)
        t_chain = time.time()
        self.timings["pad_s"] += t_chain - t_pad
        res = GIBBS.run_gibbs_stacked(
            ctx.noise_for([(t.coord, 0) for t in group]), csr_r, csr_c, tr,
            tc, ctx.block_cfg(group[0]), U_prior=up, V_prior=vp,
            device=ctx.device)
        _sync(ctx.device)
        self.timings["chain_s"] += time.time() - t_chain
        for t in group:
            self._record("resolve", t.coord)
        per = (time.time() - t0) / len(group)
        out: Dict[Coord, BlockOutcome] = {}
        for b, t in enumerate(group):
            res_b = GIBBS.tree_map(lambda x: x[b], res)
            out[t.coord] = _outcome(res_b, ctx.part.block(t.i, t.j), per)
        return out


EXECUTORS: Dict[str, type] = {
    "serial": SerialExecutor,
    "stacked": StackedExecutor,
}
"""Executor registry; ``run_pp(executor=<name>)`` resolves here."""

_LATER = ("sharded", "async", "streaming")


def make_executor(spec) -> Executor:
    """Resolve run_pp's ``executor=`` argument: a registry name or an
    instance."""
    if isinstance(spec, Executor):
        return spec
    if spec in _LATER:
        raise NotImplementedError(
            f"the {spec!r} executor is not ported yet (ROADMAP §A); "
            f"use one of {' | '.join(EXECUTORS)}")
    if spec not in EXECUTORS:
        raise ValueError(f"unknown executor {spec!r} "
                         f"(expected {' | '.join(EXECUTORS)})")
    return EXECUTORS[spec]()


def run_phase_graph(seed: int, part: Partition, cfg: BMF.BMFConfig,
                    test: COO, executor: Executor, verbose: bool = False,
                    policy: Optional[FaultPolicy] = None, device=None,
                    noise: Optional[NoiseFactory] = None) -> "PP.PPResult":
    """Execute the PP phase graph with ``executor`` and aggregate — the
    engine behind ``pp.run_pp``. Every resolved block passes the
    chain-health guard under ``policy`` before its posterior reaches any
    successor."""
    dev = resolve_device(device)
    I, J = part.I, part.J
    t_start = time.time()
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    shapes = PP.BlockShapes.per_phase(part, test_p)
    ctx = PhaseContext(part=part, cfg=cfg, test_p=test_p, seed=int(seed),
                       shapes=shapes, device=dev, noise=noise,
                       policy=policy if policy is not None else FaultPolicy())
    graph = build_phase_graph(part)
    # static pre-dispatch validation: acyclic, every dep in the graph
    bad = check_graph({t.coord: list(t.deps) for _, ts in graph for t in ts})
    if bad:
        raise ValueError("invalid phase graph: "
                         + "; ".join(v.message for v in bad))
    outcomes, phase_times, spans = executor.run_graph(ctx, graph,
                                                      verbose=verbose)

    sq_err, n_test = 0.0, 0
    per_block_rmse = np.zeros((I, J))
    block_times: Dict[Coord, float] = {}
    for _, tasks in graph:
        for t in tasks:
            o = outcomes[t.coord]
            block_times[t.coord] = o.seconds
            n, sq = _host_sq(ctx, t, o)
            if n:
                sq_err += sq
                n_test += n
                per_block_rmse[t.i, t.j] = float(np.sqrt(sq / n))

    U_posts = [[ctx.U_posts[(i, j)] for j in range(J)] for i in range(I)]
    V_posts = [[ctx.V_posts[(i, j)] for j in range(J)] for i in range(I)]
    U_agg = PP._aggregate_axis(part, U_posts, axis="row")
    V_agg = PP._aggregate_axis(part, V_posts, axis="col")

    rmse = float(np.sqrt(sq_err / max(n_test, 1)))
    return PP.PPResult(rmse=rmse, U_agg=U_agg, V_agg=V_agg,
                       per_block_rmse=per_block_rmse,
                       wall_time_s=time.time() - t_start,
                       phase_times_s=phase_times, n_test=n_test,
                       block_times_s=block_times, executor=executor.name,
                       block_spans_s=spans, faults=list(ctx.faults),
                       row_perm=part.row_perm, col_perm=part.col_perm,
                       tau=cfg.tau, K=cfg.K)
