"""Phase-graph execution engine for Posterior Propagation (port of
``repro.core.engine`` for one device group).

The paper's §2.2 structure is a three-phase DAG over the I×J block grid:
phase (a) is block (0,0); phase (b) is the first block-row and block-column,
depending only on (a); phase (c) is the interior, depending only on (b).
Within a phase, blocks are embarrassingly parallel.

  SerialExecutor    reference semantics: one chain per block, synchronised
                    after each.
  StackedExecutor   stacks all blocks of a phase shape bucket along a
                    leading axis and runs ONE batched chain per bucket
                    (``gibbs.run_gibbs_stacked``); the kernels take the
                    block axis directly.
  AsyncExecutor     dependency-driven overlap: readiness counters over
                    ``BlockTask.deps`` dispatch each block's chain the
                    moment its prior sources resolve, so phase-c blocks
                    start while the rest of phase b still runs. The host
                    never waits for the card inside a dispatch: inputs
                    move by non-blocking copies from pinned memory, and a
                    ``torch.cuda.Event`` recorded after the block's work
                    (and after a non-blocking copy of its RMSE numerator
                    and health flag to pinned memory) is its completion
                    signal, polled with ``query()``.
  StreamingExecutor the same ready queue, but blocks move through a
                    bounded window: chunks of W same-shape blocks
                    (repeat-padded to exactly W) whose ratings are
                    assembled on the host into a reusable pinned staging
                    buffer, copied on a copy stream and scattered into
                    ``depth + 1`` reused device slots while the previous
                    chunk computes — live window ≤ W·(depth+1) blocks,
                    flat in the grid size.

Both overlapped executors pop ready blocks critical-path-first
(``critical_path_priority``), FIFO among ties, and run under a watchdog:
a dispatch whose completion is not observed within its deadline
(``FaultPolicy.timeout_*`` and the calibrated rate of ``_GroupHealth``)
is re-dispatched with the same noise. The reference's multi-group fault
domain (quarantine, work stealing, speculation) needs more than one
device group and comes with the topologies of ROADMAP step 10.

Executor contract: ``run_graph(ctx, graph, verbose) -> (outcomes,
phase_times_s, spans)`` writes each block's posterior summaries into
``ctx.U_posts`` / ``ctx.V_posts`` before any dependent reads them; the
default barrier implementation runs ``run_phase`` once per phase.
``run_phase_graph`` owns RMSE accumulation and the divide-away
aggregation.

Fault tolerance: every resolved block passes the chain-health guard
(``_commit_guard``): an unhealthy chain retries through one shared
single-block runner (fresh seed, jittered prior), then degrades to its
propagated prior or raises per ``FaultPolicy``. ``FaultPlan`` injects
NaN'd chains, hung and failed dispatches deterministically, and
``checkpoint_dir`` / ``resume_from`` persist and restore resolved blocks
bitwise (``checkpoint.ckpt.PPCheckpoint``).
"""
from __future__ import annotations

import contextlib
import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.analysis.trace_passes import check_graph
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import pp as PP
from repro_torch.core.partition import Partition
from repro_torch.core.posterior import RowGaussians
from repro_torch.data.sparse import COO, PaddedCSR, apply_permutation
from repro_torch.noise import GeneratorNoise, block_seed

Coord = Tuple[int, int]

# stable intra-phase bucket order (phase b runs its two buckets back to back)
_TAG_ORDER = ("a", "b_row", "b_col", "c")


class BlockFaultError(RuntimeError):
    """A block exhausted its retry budget (unhealthy chain, repeated
    dispatch failure or repeated watchdog timeout) under
    ``on_fault == 'raise'``."""


class _InjectedDispatchFailure(RuntimeError):
    """Raised by the FaultPlan seam to simulate a dispatch-time failure
    (device OOM, dead runtime) — handled exactly like the real thing."""


# runtime failures a dispatch may raise that the engine treats as a block
# fault (retried through the shared runner) rather than a bug
_DISPATCH_ERRORS = (_InjectedDispatchFailure, torch.cuda.OutOfMemoryError)


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
    watchdog: deadline-police the async/streaming poll loops. A dispatch's
      deadline is ``timeout_floor_s + timeout_slack · rate · est`` (``est``
      the nnz cost proxy of ``_block_cost_estimates``, ``rate`` the
      calibrated seconds per cost unit of ``_GroupHealth``, 0 until the
      second resolve). A timed-out dispatch is re-dispatched with the
      same noise, so a slow-but-alive block resolves to the same numbers;
      budget exhaustion degrades or raises. watchdog=False blocks on the
      oldest dispatch instead, which never returns if it died.

    ``quarantine_after``, ``speculate_at``, ``min_groups`` and
    ``on_group_fault`` are validated as in the reference; they govern the
    multi-group fault domain, which comes with the topologies of ROADMAP
    step 10."""
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
class FaultPlan:
    """Deterministic fault injection by coordinate — the test seam the
    fault battery drives every executor with.

    Each map is ``{coord: n}``: the block's first ``n`` attempts are
    affected (attempt 0 is the normal dispatch, attempt ``a`` the a-th
    retry), so a plan is a pure function of (coord, attempt).

    nan_at: NaN-poison the block's rating planes at padding time — the
      chain itself goes non-finite and its health guard trips.
    hang_at: suppress completion detection for the block's dispatch
      (async/streaming ``_is_resolved`` never fires) until the watchdog
      recovers it. Barrier executors have no poll loop to hang.
    fail_dispatch_at: dispatching the block raises, at every executor's
      dispatch site.

    ``group_dead_at`` (``{group: n}``) and ``group_slow_at`` (``{group:
    (n, slow_s)}``) key on a device group and its dispatch ordinal
    (``PhaseContext.next_group_ordinal``): from the group's n-th dispatch
    on, completion is never observed, or withheld for ``slow_s``."""
    nan_at: Dict[Coord, int] = field(default_factory=dict)
    hang_at: Dict[Coord, int] = field(default_factory=dict)
    fail_dispatch_at: Dict[Coord, int] = field(default_factory=dict)
    group_dead_at: Dict[int, int] = field(default_factory=dict)
    group_slow_at: Dict[int, Tuple[int, float]] = field(default_factory=dict)

    def nan(self, c: Coord, attempt: int) -> bool:
        return attempt < self.nan_at.get(tuple(c), 0)

    def hang(self, c: Coord, attempt: int) -> bool:
        return attempt < self.hang_at.get(tuple(c), 0)

    def fail(self, c: Coord, attempt: int) -> bool:
        return attempt < self.fail_dispatch_at.get(tuple(c), 0)

    def group_dead(self, g: int, ordinal: int) -> bool:
        n = self.group_dead_at.get(int(g))
        return n is not None and ordinal >= int(n)

    def group_slow_s(self, g: int, ordinal: int) -> float:
        ent = self.group_slow_at.get(int(g))
        if ent is None:
            return 0.0
        n, slow = ent
        return float(slow) if ordinal >= int(n) else 0.0


@dataclass(frozen=True)
class FaultRecord:
    """One ledger entry in ``PPResult.faults``."""
    coord: Coord
    kind: str        # "nonfinite" | "rmse" | "dispatch" | "timeout"
    attempt: int
    action: str      # "retried" | "redispatched" | "degraded" | "raised"


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
    carries device-resident summaries across phase boundaries, and the
    fault-tolerance state: policy, optional injection plan, per-block
    attempt counters (0 = the normal dispatch), the fault ledger, the
    optional checkpoint writer, and the outcomes restored from a
    ``resume_from`` directory (their tasks are pruned from the graph)."""
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
    fault_plan: Optional[FaultPlan] = None
    attempts: Dict[Coord, int] = field(default_factory=dict)
    faults: List[FaultRecord] = field(default_factory=list)
    ckpt: Optional[object] = None        # checkpoint.ckpt.PPCheckpoint
    resumed: Dict[Coord, "BlockOutcome"] = field(default_factory=dict)
    # per-group dispatch counters — the ordinals the group-level
    # injections (FaultPlan.group_dead_at / group_slow_at) key on
    group_dispatches: Dict[int, int] = field(default_factory=dict)

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

    def should_poison(self, c: Coord) -> bool:
        return (self.fault_plan is not None
                and self.fault_plan.nan(c, self.cur_attempt(c)))

    def is_hung(self, c: Coord) -> bool:
        return (self.fault_plan is not None
                and self.fault_plan.hang(c, self.cur_attempt(c)))

    def check_dispatch(self, c: Coord):
        if (self.fault_plan is not None
                and self.fault_plan.fail(c, self.cur_attempt(c))):
            raise _InjectedDispatchFailure(
                f"injected dispatch failure for block {c} "
                f"(attempt {self.cur_attempt(c)})")

    def next_group_ordinal(self, g: int) -> int:
        """Bump-and-return group ``g``'s dispatch ordinal (0-based)."""
        n = self.group_dispatches.get(int(g), 0)
        self.group_dispatches[int(g)] = n + 1
        return n

    def group_suppressed_until(self, g: int, ordinal: int,
                               td: float) -> float:
        """Group-level injection verdict for one dispatch: 0.0 = healthy,
        ``inf`` = completion never observed, else the wall-clock time
        before which completion is withheld. Applied where completion is
        observed, like ``is_hung``."""
        if self.fault_plan is None:
            return 0.0
        if self.fault_plan.group_dead(g, ordinal):
            return float("inf")
        slow = self.fault_plan.group_slow_s(g, ordinal)
        return td + slow if slow else 0.0

    def record_fault(self, c: Coord, kind: str, action: str):
        self.faults.append(FaultRecord(coord=c, kind=kind,
                                       attempt=self.cur_attempt(c),
                                       action=action))

    def note_resolved(self, task: BlockTask, out: "BlockOutcome"):
        """Checkpoint hook: persist one resolved block's posteriors and
        RMSE contribution. No cost when checkpointing is off."""
        if self.ckpt is None:
            return
        n, sq = _host_sq(self, task, out)
        self.ckpt.note(task.coord, out.U_post, out.V_post, sq, n)


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


def _chunk_sq_err(pred_sum, pred_cnt, vals, mask):
    """``_block_sq_err`` of each block of a (W, n_test) window chunk: one
    product per block, so a block's numerator does not depend on which
    blocks share its chunk."""
    return torch.stack([_block_sq_err(*a) for a in zip(pred_sum, pred_cnt,
                                                       vals, mask)])


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


def _task_inputs(ctx: PhaseContext, task: BlockTask, attempt: int):
    """One block padded to its phase bucket on the run's device, with the
    injection plan's NaN poison for ``attempt``: ``(pad_block_inputs
    tuple, n_test)``. Never waits for the device."""
    up, vp = ctx.priors(task)
    return PP.pad_block_inputs_n(
        ctx.part.block(task.i, task.j), ctx.shapes[task.phase], ctx.cfg.K,
        ctx.test_p, up, vp, device=ctx.device,
        poison_nan=(ctx.fault_plan is not None
                    and ctx.fault_plan.nan(task.coord, attempt)))


def _run_block_attempt(ctx: PhaseContext, task: BlockTask,
                       attempt: int) -> BlockOutcome:
    """The shared retry runner: one single-block chain with the attempt's
    seed and jittered prior, whichever executor hit the fault."""
    c = task.coord
    ctx.check_dispatch(c)
    blk = ctx.part.block(task.i, task.j)
    (csr_r, csr_c, tr, tc, tv, tmask, up_p, vp_p), n_obs = _task_inputs(
        ctx, task, attempt)
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
                        seconds=0.0, sq_err=sq, n_obs=n_obs,
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
        sq_err=torch.zeros(()), n_obs=0,
        health=torch.ones((), dtype=torch.bool))


def _commit_guard(ctx: PhaseContext, task: BlockTask,
                  out: Optional[BlockOutcome],
                  kind: Optional[str] = None) -> BlockOutcome:
    """The chain-health guard, applied to every block at resolve time.

    Healthy outcome → returned untouched (one host read of its health
    flag). Faulty outcome (or ``kind`` pre-set by a dispatch failure or a
    watchdog timeout) → bounded retries through ``_run_block_attempt``,
    then degrade or raise per ``ctx.policy``. The posterior store is
    rewritten before returning whenever the outcome changes."""
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

    ``record_trace=True`` records entries in real order: ``(event,
    coord)`` for the barrier executors, ``(event, coord, group)`` for the
    overlapped ones (group 0: one device group). "dispatch" when a
    block's chain is handed to the device (its priors were read),
    "resolve" when its outcome passed the commit guard; the watchdog adds
    "expire" (the in-flight attempt hit its deadline) and "redispatch"
    (that attempt dispatched again). ``analysis.trace_passes`` checks the
    protocol.

    ``timings`` holds the last run's seconds per layer where the executor
    can split them: "pad_s" (host padding and the copy to the device) and
    "chain_s" (the Gibbs chains). Barrier executors end both in a device
    sync; the overlapped ones run them side by side, so "pad_s" is the
    host's padding time and "chain_s" the span from the first dispatch
    to the last resolve."""
    name = "base"

    def __init__(self, record_trace: bool = False):
        self.record_trace = record_trace
        self.trace: List[Tuple] = []
        self.timings: Dict[str, float] = {}

    def _reset_run_state(self):
        """Clear per-run state, so one instance serves many runs."""
        self.trace = []
        self.timings = {"pad_s": 0.0, "chain_s": 0.0}

    def _record(self, event: str, coord: Coord, group: Optional[int] = None):
        if self.record_trace:
            self.trace.append((event, coord) if group is None
                              else (event, coord, int(group)))

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
            missing = ({d for t in tasks for d in t.deps}
                       - set(ctx.U_posts))
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
                ctx.note_resolved(t, o)
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
                ctx.check_dispatch(t.coord)
                res = PP.run_block(ctx.noise_for([(t.coord, 0)]), blk,
                                   ctx.block_cfg(t), ctx.test_p, up, vp,
                                   shapes=ctx.shapes[t.phase],
                                   device=ctx.device,
                                   poison_nan=ctx.should_poison(t.coord))
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
    allocated once and each block is padded straight into its slice. A
    block whose dispatch fails leaves the bucket (the chains are
    independent) and heals through the shared retry runner."""
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
        out: Dict[Coord, BlockOutcome] = {}
        ok = []
        for t in group:
            try:
                ctx.check_dispatch(t.coord)
                ok.append(t)
            except _DISPATCH_ERRORS:
                self._record("resolve", t.coord)
                out[t.coord] = _commit_guard(ctx, t, None, kind="dispatch")
        if not ok:
            return out
        group = ok
        priors = [ctx.priors(t) for t in group]
        t_pad = time.time()
        buf = PP.new_block_inputs(s, ctx.cfg.K, len(group), ctx.device,
                                  priors[0][0] is not None,
                                  priors[0][1] is not None)
        for b, (t, (up, vp)) in enumerate(zip(group, priors)):
            PP.fill_block_inputs(buf, b, ctx.part.block(t.i, t.j), s,
                                 ctx.test_p, up, vp)
            if ctx.should_poison(t.coord):
                PP.poison_block_inputs(buf, b)
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
        for b, t in enumerate(group):
            res_b = GIBBS.tree_map(lambda x: x[b], res)
            out[t.coord] = _outcome(res_b, ctx.part.block(t.i, t.j), per)
        return out


# ---------------------------------------------------------------------------
# The ready-queue layer shared by the overlapped executors
# ---------------------------------------------------------------------------


def critical_path_priority(tasks: Dict[Coord, BlockTask],
                           est: Dict[Coord, float],
                           succ: Optional[Dict[Coord, List[Coord]]] = None
                           ) -> Dict[Coord, float]:
    """Bottom-level of every task: its estimated cost plus the longest
    estimated chain through its successors. Dispatching ready blocks in
    DESCENDING bottom-level order (critical-path-first) closes the longest
    chain earliest. ``succ`` may be passed pre-built (``_dep_state``)."""
    if succ is None:
        succ = {c: [] for c in tasks}
        for t in tasks.values():
            for d in t.deps:
                succ[d].append(t.coord)
    memo: Dict[Coord, float] = {}

    def bottom(c: Coord) -> float:
        if c not in memo:
            memo[c] = (est.get(c, 0.0)
                       + max((bottom(s) for s in succ[c]), default=0.0))
        return memo[c]

    return {c: bottom(c) for c in tasks}


def _block_cost_estimates(ctx: PhaseContext,
                          tasks: Dict[Coord, BlockTask]) -> Dict[Coord, float]:
    """A-priori per-block cost proxy: the block's nnz (+1 so empty blocks
    still order deterministically)."""
    return {c: float(ctx.part.block(t.i, t.j).coo.nnz + 1)
            for c, t in tasks.items()}


def _dep_state(ctx: PhaseContext, graph, priority: bool, make_queue=None):
    """Ready-queue scaffolding for the overlapped schedulers: task/phase
    maps, readiness counters, successor lists, and the priority ready
    queue seeded with the dep-free blocks. ``make_queue(prio, tasks)``
    substitutes a queue type (the streaming executor groups by window
    shape). Returns ``(tasks, phase_of, waiting, succ, ready)``."""
    tasks = {t.coord: t for _, ts in graph for t in ts}
    phase_of = {t.coord: ph for ph, ts in graph for t in ts}
    # a resumed graph is pruned: deps satisfied by restored blocks don't
    # count toward readiness, and restored blocks appear in no succ list
    waiting = {c: sum(1 for d in t.deps if d in tasks)
               for c, t in tasks.items()}
    succ: Dict[Coord, List[Coord]] = {c: [] for c in tasks}
    for t in tasks.values():
        for d in t.deps:
            if d in succ:
                succ[d].append(t.coord)
    prio = (critical_path_priority(tasks, _block_cost_estimates(ctx, tasks),
                                   succ=succ)
            if priority else None)
    ready = make_queue(prio, tasks) if make_queue else _ReadyQueue(prio)
    for c, w in waiting.items():
        if w == 0:
            ready.push(c)
    return tasks, phase_of, waiting, succ, ready


class _ReadyQueue:
    """Priority ready queue: pops in descending critical-path
    (bottom-level) order, FIFO among ties; plain FIFO without
    priorities."""

    def __init__(self, prio: Optional[Dict[Coord, float]] = None):
        self._prio = prio or {}
        self._seq = 0
        self._heap: List[Tuple[float, int, Coord]] = []

    def push(self, c: Coord):
        heapq.heappush(self._heap, (-self._prio.get(c, 0.0), self._seq, c))
        self._seq += 1

    def pop(self) -> Coord:
        return heapq.heappop(self._heap)[2]

    def __len__(self):
        return len(self._heap)

    def __bool__(self):
        return bool(self._heap)


class _GroupedReadyQueue:
    """Streaming ready queue: a global priority heap for lead selection
    plus one heap per chunk-group key, so forming a chunk is O(W log n).
    Entries popped through one view are lazily skipped in the other."""

    def __init__(self, prio, group_of):
        self._prio = prio
        self._group_of = group_of
        self._global = _ReadyQueue(prio)
        self._groups: Dict = {}
        self._taken: set = set()
        self._n = 0

    def push(self, c: Coord):
        self._global.push(c)
        self._groups.setdefault(self._group_of(c),
                                _ReadyQueue(self._prio)).push(c)
        self._n += 1

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def pop_chunk(self, max_n: int) -> List[Coord]:
        """Highest-priority ready block plus up to ``max_n - 1`` more from
        its group, in priority order."""
        while True:
            lead = self._global.pop()
            if lead not in self._taken:
                break
        self._taken.add(lead)
        self._n -= 1
        take = [lead]
        grp = self._groups[self._group_of(lead)]
        while grp and len(take) < max_n:
            c = grp.pop()
            if c in self._taken:
                continue
            self._taken.add(c)
            self._n -= 1
            take.append(c)
        return take


class _GroupHealth:
    """Per-device-group health ledger of the overlapped schedulers:
    per-group EWMA rates, consecutive-expiry counters and the quarantined
    set.

    ``rate(g)`` is an EWMA (alpha = 0.4) of group ``g``'s observed
    seconds per estimated cost unit; each group's FIRST resolve spans its
    warm-up (kernel builds, allocator growth) and is dropped. A group not
    yet calibrated inherits the fastest calibrated rate; before any group
    calibrates every rate is 0.0 and deadlines fall back to the floor.
    ``note_expiry`` counts CONSECUTIVE expiries per group (any resolve
    resets the count) and returns True when the count crosses
    ``quarantine_after``. With one device group only ``observe``,
    ``rate`` and ``note_resolve`` are exercised: they set the watchdog's
    deadlines."""

    ALPHA = 0.4

    def __init__(self, n_groups: int, quarantine_after: int):
        self.n = max(1, int(n_groups))
        self.quarantine_after = max(1, int(quarantine_after))
        self._rate = [0.0] * self.n     # EWMA s/cost; 0 = uncalibrated
        self._seen = [False] * self.n   # first resolve = warm-up span
        self.consec = [0] * self.n      # consecutive expiries
        self.quarantined: set = set()

    def healthy(self) -> List[int]:
        return [g for g in range(self.n) if g not in self.quarantined]

    @property
    def global_rate(self) -> float:
        cal = [r for r in self._rate if r > 0.0]
        return min(cal) if cal else 0.0

    def rate(self, g: int) -> float:
        return self._rate[g] if self._rate[g] > 0.0 else self.global_rate

    def observe(self, g: int, obs: float):
        if not self._seen[g]:
            self._seen[g] = True
            return
        if obs <= 0.0:
            return
        r = self._rate[g]
        self._rate[g] = (obs if r == 0.0
                         else (1 - self.ALPHA) * r + self.ALPHA * obs)

    def note_resolve(self, g: int):
        self.consec[g] = 0

    def note_expiry(self, g: int) -> bool:
        if g in self.quarantined:
            return False
        self.consec[g] += 1
        return self.consec[g] >= self.quarantine_after

    def quarantine(self, g: int):
        self.quarantined.add(g)


@dataclass(eq=False)
class _Flight:
    """One in-flight dispatch: a single block (async) or a window chunk
    (streaming). ``sig`` is its completion event (None on the CPU, where
    a dispatch has finished when it returns); ``host`` the (B, 2) pinned
    copy of its (Σ err², health) pairs, valid once ``sig`` fired; ``sup``
    the group-level injection verdict for this dispatch."""
    sig: object
    host: torch.Tensor
    out: object                            # BlockOutcome | {coord: outcome}
    td: float                              # dispatch wall time
    group: int = 0
    sup: float = 0.0
    tasks: Optional[List[BlockTask]] = None  # streaming chunk members
    slot: object = None                      # streaming window slot


def _completion(dev: torch.device, sq: torch.Tensor, health: torch.Tensor):
    """End one dispatch: its per-block (Σ err², health) pairs leave for the
    host by a non-blocking copy into pinned memory, and an event recorded
    after that copy (so after all of the dispatch's work) is its
    completion signal. Returns ``(event, host (B, 2))``; on the CPU the
    work is done when the dispatch returns and the event is None."""
    vals = torch.stack([sq.float(), health.float()], dim=-1)
    if dev.type != "cuda":
        return None, vals
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return ev, host


def _adopt_host(out: BlockOutcome, host: torch.Tensor, b: int):
    """Point a resolved outcome's RMSE numerator and health flag at their
    host copies, so the commit guard and the RMSE sum read the host and
    never wait for the card."""
    out.sq_err = host[b, 0]
    out.health = host[b, 1] != 0


class _Overlapped(Executor):
    """Shared state of the overlapped executors: the completion seam and
    the per-phase envelope bookkeeping."""

    def __init__(self, record_trace: bool = False, priority: bool = True):
        super().__init__(record_trace=record_trace)
        self.priority = priority

    def run_phase(self, ctx, phase, tasks):
        raise NotImplementedError(
            f"the {self.name} executor overlaps phases — it schedules "
            f"whole graphs (run_graph), not single phases")

    # -- completion-detection seam (tests fake completion order here) -----
    def _is_resolved(self, coord: Coord, signal) -> bool:
        return signal is None or signal.query()

    def _finish_timings(self, first_d, last_r):
        if first_d:
            self.timings["chain_s"] = (max(last_r.values())
                                       - min(first_d.values()))
        return {ph: last_r[ph] - first_d[ph] for ph in first_d}


def _verbose_phase(ex, ctx, tasks, phase_of, ph, first_d, last_r):
    ts = [t for t in tasks.values() if phase_of[t.coord] == ph]
    print(f"[pp:{ex.name}] phase {ph}: {len(ts)} block(s) "
          f"{_phase_desc(ctx, ts)} {last_r[ph] - first_d[ph]:.2f}s "
          f"(dispatch→resolve envelope; phases overlap)", flush=True)


class AsyncExecutor(_Overlapped):
    """Dependency-driven overlapped schedule on one device group.

    Readiness counters over ``BlockTask.deps`` replace the phase barrier:
    each block is dispatched (one single-block chain, the serial
    executor's bucketed shapes) the moment both of its prior sources have
    resolved. All chains run on the device's current stream, as the
    reference runs them on one device; the host never waits inside a
    dispatch (``_dispatch``), so it pads the next block while the card
    runs the last. Completion is a ``torch.cuda.Event`` polled with
    ``query()`` under an adaptive sleep, policed by the watchdog
    (``FaultPolicy.watchdog``). Posterior summaries stay on the device
    and feed successors directly.

    ``record_trace=True`` appends (event, coord, 0) entries to
    ``self.trace`` in real order; ``_is_resolved`` is the seam the tests
    override to fake completion orders. ``priority=True`` pops the ready
    queue critical-path-first, ``False`` in FIFO order."""
    name = "async"

    def run_graph(self, ctx, graph, verbose: bool = False):
        self._reset_run_state()
        tasks, phase_of, waiting, succ, ready = _dep_state(
            ctx, graph, self.priority)
        est = _block_cost_estimates(ctx, tasks)
        pol = ctx.policy
        health = _GroupHealth(1, pol.quarantine_after)
        g = 0
        flights: Dict[Coord, _Flight] = {}
        outcomes: Dict[Coord, BlockOutcome] = {}
        spans: Dict[Coord, Tuple[float, float]] = {}
        first_d: Dict[str, float] = {}
        last_r: Dict[str, float] = {}
        remaining = {ph: len(ts) for ph, ts in graph}
        t0 = time.time()

        def deadline(c, f):
            # generous floor + slack × the calibrated rate × the block's
            # cost. A false expiry is benign: the re-dispatch draws the
            # same attempt-0 noise, so it resolves to the same numbers.
            return (pol.timeout_floor_s
                    + pol.timeout_slack * health.rate(f.group) * est[c])

        def flight_ready(c, f):
            if ctx.is_hung(c):
                return False
            if f.sup and time.time() < f.sup:
                return False
            return self._is_resolved(c, f.sig)

        def retire(c, out, td, kind=None):
            self._record("resolve", c, g)
            out = _commit_guard(ctx, tasks[c], out, kind=kind)
            tr = time.time()
            if not out.seconds:
                out.seconds = tr - td
            if kind is None:
                # the first resolve (warm-up span) is dropped in observe()
                health.observe(g, out.seconds / est[c])
            spans[c] = (td - t0, tr - t0)
            outcomes[c] = out
            ctx.note_resolved(tasks[c], out)
            ph = phase_of[c]
            remaining[ph] -= 1
            last_r[ph] = tr - t0
            if verbose and remaining[ph] == 0:
                _verbose_phase(self, ctx, tasks, phase_of, ph, first_d,
                               last_r)
            for s in succ[c]:
                waiting[s] -= 1
                if waiting[s] == 0:
                    ready.push(s)

        def dispatch_on(c, event):
            self._record(event, c, g)
            td = time.time()
            first_d.setdefault(phase_of[c], td - t0)
            sup = ctx.group_suppressed_until(g, ctx.next_group_ordinal(g), td)
            try:
                sig, host, out = self._dispatch(ctx, tasks[c])
            except _DISPATCH_ERRORS:
                retire(c, None, td, kind="dispatch")
                return
            flights[c] = _Flight(sig=sig, host=host, out=out, td=td,
                                 group=g, sup=sup)

        def handle_expiries(now):
            """Watchdog sweep: expire overdue flights, re-dispatch them or
            retire them terminally. True when any state changed."""
            changed = False
            for c in list(flights):
                f = flights[c]
                if now - f.td <= deadline(c, f):
                    continue
                changed = True
                del flights[c]
                self._record("expire", c, g)
                if ctx.cur_attempt(c) < pol.max_retries:
                    ctx.record_fault(c, "timeout", "redispatched")
                    ctx.attempts[c] = ctx.cur_attempt(c) + 1
                    dispatch_on(c, "redispatch")
                else:
                    retire(c, None, f.td, kind="timeout")
            return changed

        def await_progress():
            """Poll with an adaptive sleep until a flight resolves or the
            watchdog changes state; without the watchdog, block on the
            oldest flight."""
            if not pol.watchdog:
                f0 = min(flights.values(), key=lambda f: f.td)
                if f0.sig is not None:
                    f0.sig.synchronize()
                return
            sleep = 5e-5
            while flights:
                if any(flight_ready(c, f) for c, f in flights.items()):
                    return
                if handle_expiries(time.time()):
                    return
                time.sleep(sleep)
                sleep = min(sleep * 2, 2e-3)

        while ready or flights:
            while ready:
                dispatch_on(ready.pop(), "dispatch")
            if not flights:
                continue
            await_progress()
            for c in [c for c, f in flights.items() if flight_ready(c, f)]:
                f = flights.pop(c)
                # successors must consume this flight's handles, not those
                # of an expired attempt
                ctx.U_posts[c], ctx.V_posts[c] = f.out.U_post, f.out.V_post
                _adopt_host(f.out, f.host, 0)
                health.note_resolve(f.group)
                retire(c, f.out, f.td)
        # per-phase envelopes: first dispatch → last resolve. Phases
        # overlap, so these may sum to MORE than the wall time.
        return outcomes, self._finish_timings(first_d, last_r), spans

    def _dispatch(self, ctx: PhaseContext, task: BlockTask):
        """Enqueue one block's chain without waiting for the device.
        Returns ``(completion event, host copy of (Σ err², health),
        BlockOutcome)``. The redispatch of an expired attempt draws the
        attempt-0 noise again (only the commit guard's retries draw
        from attempt ``a``)."""
        c = task.coord
        ctx.check_dispatch(c)
        t_pad = time.time()
        (csr_r, csr_c, tr, tc, tv, tmask, up, vp), n_obs = _task_inputs(
            ctx, task, ctx.cur_attempt(c))
        self.timings["pad_s"] += time.time() - t_pad
        res = GIBBS.run_gibbs(ctx.noise_for([(c, 0)]), csr_r, csr_c, tr, tc,
                              ctx.block_cfg(task), U_prior=up, V_prior=vp,
                              device=ctx.device)
        blk = ctx.part.block(task.i, task.j)
        U_post = _trim(res.U_post, len(blk.row_ids))
        V_post = _trim(res.V_post, len(blk.col_ids))
        sq = _block_sq_err(res.acc.pred_sum, res.acc.pred_cnt, tv, tmask)
        # device-resident store write AT DISPATCH: successors (dispatched
        # only after this block resolves) read these tensors directly
        ctx.U_posts[c], ctx.V_posts[c] = U_post, V_post
        sig, host = _completion(ctx.device, sq.reshape(1),
                                res.health.reshape(1))
        return sig, host, BlockOutcome(U_post=U_post, V_post=V_post,
                                       pred_mean=None, seconds=0.0,
                                       sq_err=sq, n_obs=n_obs,
                                       health=res.health)


def _pad8(m: int) -> int:
    """The planes' slot count: M rounded up to 8, as the padding does."""
    return -(-m // 8) * 8


# what one window slot copies from the host, per block of its chunk
_STAGED = {"lin_r": torch.int64, "col_r": torch.int32, "v_r": torch.float32,
           "lin_c": torch.int64, "col_c": torch.int32, "v_c": torch.float32,
           "tr": torch.int32, "tc": torch.int32, "tv": torch.float32,
           "tmask": torch.float32, "u_use": torch.float32,
           "v_use": torch.float32}
_PLANES = {"idx_r": torch.int32, "val_r": torch.float32,
           "mask_r": torch.float32, "idx_c": torch.int32,
           "val_c": torch.float32, "mask_c": torch.float32}
# what bounds each buffer's length, per block of a chunk
_SIZE_KIND = {**dict.fromkeys(("idx_r", "val_r", "mask_r"), "plane_r"),
              **dict.fromkeys(("idx_c", "val_c", "mask_c"), "plane_c"),
              **dict.fromkeys(("lin_r", "col_r", "v_r", "lin_c", "col_c",
                               "v_c"), "entries"),
              **dict.fromkeys(("tr", "tc", "tv", "tmask"), "test"),
              **dict.fromkeys(("u_use", "v_use"), "flag")}


@dataclass(eq=False)
class _Slot:
    """One window slot: device buffers for W blocks of the largest window
    shape (flat; a chunk views a prefix), a pinned staging buffer for what
    moves from the host, the event after the slot's last copy and scatter
    (``staged``) and the completion event of the chunk that last read it
    (``reader``)."""
    dev: Dict[str, torch.Tensor]
    host: Dict[str, torch.Tensor]
    staged: object = None
    reader: object = None


class _Window:
    """The streaming executor's bounded window on one device: ``depth +
    1`` slots, reused explicitly (XLA's buffer donation has no torch
    counterpart). A chunk's ratings (as live entries), test entries and
    prior flags are written on the host into the slot's pinned staging
    buffer, copied on a copy stream, and scattered there into the slot's
    zeroed planes while the compute stream runs the previous chunk. The
    copy stream writes a slot only after the event of the chunk that last
    read it; the compute stream runs a chunk only after its slot's
    ``staged`` event; the host rewrites a staging buffer only after that
    buffer's last copy. Buffers are allocated once per run, sized for W
    blocks of the largest coalesced shape, so the live window is flat in
    the grid size."""

    def __init__(self, ctx: PhaseContext, shapes, tasks, W: int,
                 depth: int):
        dev = ctx.device
        self.cuda = dev.type == "cuda"
        self.copy_stream = torch.cuda.Stream(dev) if self.cuda else None
        nnz: Dict[int, int] = {}
        for t in tasks.values():
            k = id(shapes[t.phase])
            nnz[k] = max(nnz.get(k, 1), ctx.part.block(t.i, t.j).coo.nnz)
        numel: Dict[str, int] = {}
        for s in {id(shapes[t.phase]): shapes[t.phase]
                  for t in tasks.values()}.values():
            size = dict(plane_r=W * s.n_rows * _pad8(s.m_rows),
                        plane_c=W * s.n_cols * _pad8(s.m_cols),
                        entries=W * nnz[id(s)], test=W * s.n_test, flag=W)
            for name, kind in _SIZE_KIND.items():
                numel[name] = max(numel.get(name, 0), size[kind])
        self.slots = []
        for _ in range(depth + 1):
            d = {k: torch.empty(numel[k], dtype=dt, device=dev)
                 for k, dt in {**_PLANES, **_STAGED}.items()}
            h = {k: torch.empty(numel[k], dtype=dt, pin_memory=self.cuda)
                 for k, dt in _STAGED.items()}
            self.slots.append(_Slot(dev=d, host=h))
        self.free = list(range(depth + 1))
        self.bytes = sum(t.numel() * t.element_size()
                         for sl in self.slots for t in sl.dev.values())

    def acquire(self) -> _Slot:
        """A free slot; its pinned staging buffer is ready to rewrite."""
        slot = self.slots[self.free.pop(0)]
        if slot.staged is not None:
            slot.staged.synchronize()
        return slot

    def release(self, slot: _Slot):
        self.free.append(self.slots.index(slot))

    @staticmethod
    def view(slot: _Slot, name: str, shape) -> torch.Tensor:
        return slot.dev[name][:math.prod(shape)].view(shape)

    def planes(self, slot: _Slot, s, W: int) -> Dict[str, torch.Tensor]:
        rows = (W, s.n_rows, _pad8(s.m_rows))
        cols = (W, s.n_cols, _pad8(s.m_cols))
        return {k: self.view(slot, k, rows if k.endswith("_r") else cols)
                for k in _PLANES}

    def upload(self, slot: _Slot, s, W: int, counts: Dict[str, int],
               n_true: int, poison: Sequence[int]):
        """Copy the staged prefixes to the device and build the chunk's
        planes there, on the copy stream: zero, scatter the entries,
        NaN-poison flagged blocks, repeat the last true block into the
        pad slots. Records ``slot.staged``."""
        ctx_ = (torch.cuda.stream(self.copy_stream) if self.cuda
                else contextlib.nullcontext())
        with ctx_:
            if slot.reader is not None:
                self.copy_stream.wait_event(slot.reader)
            for k, n in counts.items():
                slot.dev[k][:n].copy_(slot.host[k][:n], non_blocking=True)
            pl = self.planes(slot, s, W)
            for p in pl.values():
                p.zero_()
            for side in ("r", "c"):
                n = counts[f"lin_{side}"]
                PP.scatter_entries(
                    pl[f"idx_{side}"], pl[f"val_{side}"], pl[f"mask_{side}"],
                    slot.dev[f"lin_{side}"][:n], slot.dev[f"col_{side}"][:n],
                    slot.dev[f"v_{side}"][:n])
            for b in poison:
                pl["val_r"][b].fill_(float("nan"))
                pl["val_c"][b].fill_(float("nan"))
            for p in pl.values():
                p[n_true:] = p[n_true - 1]
            if self.cuda:
                slot.staged = torch.cuda.Event()
                slot.staged.record(self.copy_stream)

    def close(self, dev: torch.device):
        """The compute stream waits for the copy stream before the slots
        go back to the allocator."""
        if self.cuda:
            torch.cuda.current_stream(dev).wait_stream(self.copy_stream)


@dataclass(eq=False)
class _StagedChunk:
    """A window chunk whose copy to the device has been issued (the
    prefetch), waiting to dispatch."""
    tasks: List[BlockTask]        # true tasks, ≤ W (repeat-padded to W)
    shape: "PP.BlockShapes"
    cfg: BMF.BMFConfig
    slot: _Slot
    n_obs: List[int]


def _window_prior(ctx: PhaseContext, sel: Sequence[BlockTask], side: int,
                  n: int) -> RowGaussians:
    """(W, n, …) prior of one factor for a chunk: each block's propagated
    prior, padded with N(0, I) rows, and N(0, I) where it has none (its
    ``prior_use`` flag is 0 there, so those rows are never selected)."""
    K = ctx.cfg.K
    eta = torch.zeros((len(sel), n, K), device=ctx.device)
    lam = torch.zeros((len(sel), n, K, K), device=ctx.device)
    lam.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    for b, t in enumerate(sel):
        p = ctx.priors(t)[side]
        if p is not None:
            m = p.eta.shape[0]
            eta[b, :m].copy_(p.eta)
            lam[b, :m].copy_(p.Lambda)
    return RowGaussians(eta=eta, Lambda=lam)


class StreamingExecutor(_Overlapped):
    """Bounded-window streaming schedule for grids whose stacked buckets
    do not fit the device, on one device group.

    The SAME dependency-driven ready queue as the async executor, but
    blocks move through a bounded window (``_Window``):

      * ready blocks pop critical-path-first and are grouped into chunks
        of up to W blocks sharing one window shape and chain config; a
        short chunk is repeat-padded to exactly W, so the batched
        Cholesky and solves always see one batch size;
      * each chunk's ratings and test entries are assembled on the host
        into a pinned staging buffer and copied on a copy stream while
        the previous chunk computes (the double-buffered prefetch);
      * chunks run through ``gibbs.run_gibbs_stacked`` with per-block
        ``prior_use`` flags, so one window shape serves phase-a/b/c
        blocks despite their different prior structures;
      * at most ``depth`` chunks are in flight and one is staged:
        ``peak_window_blocks`` ≤ W·(depth+1);
      * per-phase shape buckets are coalesced first
        (``pp.BlockShapes.coalesce``): ``max_waste`` = 1.0 (default)
        merges only identical shapes, which keeps the serial executor's
        chains; more trades that for fewer window shapes.

    A block's chain draws from its own generator, and the aggregation
    sums in grid order, so the results do not depend on how completion
    timing regroups the chunks."""
    name = "streaming"

    def __init__(self, window: int = 4, max_waste: float = 1.0,
                 priority: bool = True, depth: int = 2,
                 record_trace: bool = False):
        super().__init__(record_trace=record_trace, priority=priority)
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.window = int(window)
        self.max_waste = max_waste
        self.depth = int(depth)               # in-flight chunks
        self.peak_window_blocks = 0           # realized live-window bound
        self.window_shapes: Optional[Dict[str, "PP.BlockShapes"]] = None
        self.window_bytes = 0                 # the slots' device bytes

    def _group_key(self, ctx, task, shapes):
        cfg = ctx.block_cfg(task)
        return (id(shapes[task.phase]), cfg.n_samples, cfg.burnin)

    def _reset_run_state(self):
        super()._reset_run_state()
        self.peak_window_blocks = 0
        self.window_shapes = None
        self.window_bytes = 0

    def _stage(self, ctx: PhaseContext, chunk: List[BlockTask], shapes,
               win: _Window) -> _StagedChunk:
        """Assemble one chunk into a free slot's pinned buffer on the host
        and issue its copy and scatter (``_Window.upload``)."""
        s = shapes[chunk[0].phase]
        W, nb, nt = self.window, len(chunk), s.n_test
        slot = win.acquire()
        t_pad = time.time()
        h = {k: v.numpy() for k, v in slot.host.items()}
        counts = dict.fromkeys(("lin_r", "lin_c"), 0)
        n_obs = []
        for b, t in enumerate(chunk):
            blk = ctx.part.block(t.i, t.j)
            for side, coo, n_pad, m, n_other in (
                    ("r", blk.coo, s.n_rows, s.m_rows, s.n_cols),
                    ("c", blk.coo.transpose(), s.n_cols, s.m_cols,
                     s.n_rows)):
                lin, col, val = PP.csr_entries(coo, m, n_pad, n_other)
                o, n = counts[f"lin_{side}"], len(lin)
                h[f"lin_{side}"][o:o + n] = lin + b * n_pad * _pad8(m)
                h[f"col_{side}"][o:o + n] = col
                h[f"v_{side}"][o:o + n] = val
                counts[f"lin_{side}"] = o + n
            for name, arr in zip(("tr", "tc", "tv", "tmask"),
                                 PP._test_entries(blk, s, ctx.test_p)):
                h[name][b * nt:(b + 1) * nt] = arr
            n_obs.append(int(h["tmask"][b * nt:(b + 1) * nt].sum()))
            up, vp = ctx.priors(t)
            h["u_use"][b] = float(up is not None)
            h["v_use"][b] = float(vp is not None)
        for b in range(nb, W):           # repeat-pad to exactly W
            for name in ("tr", "tc", "tv", "tmask"):
                h[name][b * nt:(b + 1) * nt] = \
                    h[name][(nb - 1) * nt:nb * nt]
            h["u_use"][b], h["v_use"][b] = h["u_use"][nb - 1], \
                h["v_use"][nb - 1]
        for side in ("r", "c"):
            counts[f"col_{side}"] = counts[f"v_{side}"] = \
                counts[f"lin_{side}"]
        counts.update(dict.fromkeys(("tr", "tc", "tv", "tmask"), W * nt))
        counts.update(u_use=W, v_use=W)
        self.timings["pad_s"] += time.time() - t_pad
        win.upload(slot, s, W, counts, nb,
                   [b for b, t in enumerate(chunk)
                    if ctx.should_poison(t.coord)])
        return _StagedChunk(tasks=chunk, shape=s, cfg=ctx.block_cfg(chunk[0]),
                            slot=slot, n_obs=n_obs)

    def _dispatch(self, ctx: PhaseContext, st: _StagedChunk, win: _Window):
        """Run one staged chunk on the compute stream once its slot is
        staged. Returns ``(completion event, host copy (W, 2),
        {coord: BlockOutcome})``; the padded duplicates are dropped."""
        s, W = st.shape, self.window
        if win.cuda:
            torch.cuda.current_stream(ctx.device).wait_event(st.slot.staged)
        pl = win.planes(st.slot, s, W)
        tr, tc, tv, tmask = (win.view(st.slot, k, (W, s.n_test))
                             for k in ("tr", "tc", "tv", "tmask"))
        use = tuple(win.view(st.slot, k, (W,)) for k in ("u_use", "v_use"))
        sel = st.tasks + [st.tasks[-1]] * (W - len(st.tasks))
        res = GIBBS.run_gibbs_stacked(
            ctx.noise_for([(t.coord, 0) for t in sel]),
            PaddedCSR(pl["idx_r"], pl["val_r"], pl["mask_r"], s.n_cols),
            PaddedCSR(pl["idx_c"], pl["val_c"], pl["mask_c"], s.n_rows),
            tr, tc, st.cfg, U_prior=_window_prior(ctx, sel, 0, s.n_rows),
            V_prior=_window_prior(ctx, sel, 1, s.n_cols), prior_use=use,
            device=ctx.device)
        sq = _chunk_sq_err(res.acc.pred_sum, res.acc.pred_cnt, tv, tmask)
        outs: Dict[Coord, BlockOutcome] = {}
        for b, t in enumerate(st.tasks):
            blk = ctx.part.block(t.i, t.j)
            U_post = _trim(RowGaussians(res.U_post.eta[b],
                                        res.U_post.Lambda[b]),
                           len(blk.row_ids))
            V_post = _trim(RowGaussians(res.V_post.eta[b],
                                        res.V_post.Lambda[b]),
                           len(blk.col_ids))
            ctx.U_posts[t.coord], ctx.V_posts[t.coord] = U_post, V_post
            outs[t.coord] = BlockOutcome(
                U_post=U_post, V_post=V_post, pred_mean=None, seconds=0.0,
                sq_err=sq[b], n_obs=st.n_obs[b], health=res.health[b])
        sig, host = _completion(ctx.device, sq, res.health)
        st.slot.reader = sig
        return sig, host, outs

    def run_graph(self, ctx, graph, verbose: bool = False):
        self._reset_run_state()
        shapes = PP.BlockShapes.coalesce(ctx.shapes, ctx.cfg.K,
                                         self.max_waste)
        tasks, phase_of, waiting, succ, ready = _dep_state(
            ctx, graph, self.priority,
            make_queue=lambda prio, ts: _GroupedReadyQueue(
                prio, lambda c: self._group_key(ctx, ts[c], shapes)))
        self.window_shapes = shapes
        pol = ctx.policy
        health = _GroupHealth(1, pol.quarantine_after)
        g = 0
        win = _Window(ctx, shapes, tasks, self.window, self.depth)
        self.window_bytes = win.bytes
        if verbose:
            n_buckets = len({id(s) for s in shapes.values()})
            print(f"[pp:{self.name}] window={self.window} depth={self.depth} "
                  f"{n_buckets} coalesced bucket(s) over {len(shapes)} phase "
                  f"tag(s), {win.bytes / 2**30:.2f} GiB of window slots",
                  flush=True)
        staged: Optional[_StagedChunk] = None
        flights: Dict[int, _Flight] = {}
        fid_next = [0]
        outcomes: Dict[Coord, BlockOutcome] = {}
        spans: Dict[Coord, Tuple[float, float]] = {}
        first_d: Dict[str, float] = {}
        last_r: Dict[str, float] = {}
        remaining = {ph: len(ts) for ph, ts in graph}
        est = _block_cost_estimates(ctx, tasks)
        t0 = time.time()

        def note_peak():
            live = self.window * (len(flights) + (staged is not None))
            self.peak_window_blocks = max(self.peak_window_blocks, live)

        def chunk_cost(ts_):
            return sum(est[t.coord] for t in ts_)

        def deadline(f):
            # one chain runs all members: the chunk's total cost
            return (pol.timeout_floor_s + pol.timeout_slack
                    * health.rate(f.group) * chunk_cost(f.tasks))

        def flight_ready(f):
            if any(ctx.is_hung(t.coord) for t in f.tasks):
                return False
            if f.sup and time.time() < f.sup:
                return False
            return self._is_resolved(f.tasks[0].coord, f.sig)

        def retire(t, out, td, tr_, per, kind=None):
            c = t.coord
            self._record("resolve", c, g)
            out = _commit_guard(ctx, tasks[c], out, kind=kind)
            if not out.seconds:
                out.seconds = per
            spans[c] = (td - t0, tr_ - t0)
            outcomes[c] = out
            ctx.note_resolved(tasks[c], out)
            ph = phase_of[c]
            remaining[ph] -= 1
            last_r[ph] = tr_ - t0
            if verbose and remaining[ph] == 0:
                _verbose_phase(self, ctx, tasks, phase_of, ph, first_d,
                               last_r)
            for s2 in succ[c]:
                waiting[s2] -= 1
                if waiting[s2] == 0:
                    ready.push(s2)

        def launch(ch: _StagedChunk, event: str):
            td = time.time()
            for t in ch.tasks:
                self._record(event, t.coord, g)
                first_d.setdefault(phase_of[t.coord], td - t0)
            sup = ctx.group_suppressed_until(g, ctx.next_group_ordinal(g), td)
            sig, host, outs = self._dispatch(ctx, ch, win)
            flights[fid_next[0]] = _Flight(sig=sig, host=host, out=outs,
                                           td=td, group=g, sup=sup,
                                           tasks=ch.tasks, slot=ch.slot)
            fid_next[0] += 1
            note_peak()

        def stage_next() -> Optional[_StagedChunk]:
            """Pop and stage the next chunk; a block whose dispatch fails
            never joins the window and heals through the retry runner."""
            while ready:
                good = []
                for c in ready.pop_chunk(self.window):
                    try:
                        ctx.check_dispatch(c)
                        good.append(tasks[c])
                    except _DISPATCH_ERRORS:
                        self._record("dispatch", c, g)
                        now = time.time()
                        first_d.setdefault(phase_of[c], now - t0)
                        retire(tasks[c], None, now, time.time(), 0.0,
                               kind="dispatch")
                if good:
                    return self._stage(ctx, good, shapes, win)
            return None

        def handle_expiries(now):
            """Watchdog sweep over the chunk flights; True on any state
            change."""
            changed = False
            for fid in list(flights):
                f = flights[fid]
                if now - f.td <= deadline(f):
                    continue
                changed = True
                del flights[fid]
                win.release(f.slot)
                for t in f.tasks:
                    self._record("expire", t.coord, g)
                if all(ctx.cur_attempt(t.coord) < pol.max_retries
                       for t in f.tasks):
                    # re-stage with the same noise: a slow-but-alive
                    # chunk re-resolves to the same numbers
                    for t in f.tasks:
                        ctx.record_fault(t.coord, "timeout", "redispatched")
                        ctx.attempts[t.coord] = ctx.cur_attempt(t.coord) + 1
                    launch(self._stage(ctx, f.tasks, shapes, win),
                           "redispatch")
                else:
                    for t in f.tasks:
                        retire(t, None, f.td, now, 0.0, kind="timeout")
            return changed

        def await_flights():
            """Adaptive poll until a chunk resolves or the watchdog
            changes state; without the watchdog, block on the oldest."""
            if not pol.watchdog:
                f0 = min(flights.values(), key=lambda f: f.td)
                if f0.sig is not None:
                    f0.sig.synchronize()
                return
            sleep = 5e-5
            while flights:
                if any(flight_ready(f) for f in flights.values()):
                    return
                if handle_expiries(time.time()):
                    return
                time.sleep(sleep)
                sleep = min(sleep * 2, 2e-3)

        try:
            while ready or staged is not None or flights:
                if staged is None and ready:
                    staged = stage_next()
                    note_peak()
                if staged is not None and len(flights) < self.depth:
                    ch, staged = staged, None
                    launch(ch, "dispatch")
                    # the double-buffered prefetch: the next chunk's copy
                    # overlaps this chunk's compute
                    if ready:
                        staged = stage_next()
                        note_peak()
                    continue
                if not flights:
                    continue
                await_flights()
                for fid in [i for i, f in flights.items() if flight_ready(f)]:
                    f = flights.pop(fid)
                    win.release(f.slot)
                    tr_ = time.time()
                    # one chain ran the whole chunk: split its wall evenly
                    per = (tr_ - f.td) / len(f.tasks)
                    health.observe(g, (tr_ - f.td) / chunk_cost(f.tasks))
                    health.note_resolve(g)
                    for b, t in enumerate(f.tasks):
                        out = f.out[t.coord]
                        ctx.U_posts[t.coord] = out.U_post
                        ctx.V_posts[t.coord] = out.V_post
                        _adopt_host(out, f.host, b)
                        retire(t, out, f.td, tr_, per)
        finally:
            win.close(ctx.device)
        return outcomes, self._finish_timings(first_d, last_r), spans


EXECUTORS: Dict[str, type] = {
    "serial": SerialExecutor,
    "stacked": StackedExecutor,
    "async": AsyncExecutor,
    "streaming": StreamingExecutor,
}
"""Executor registry; ``run_pp(executor=<name>)`` resolves here, and the
port's executor battery parametrizes over it."""


def make_executor(spec, window=None, distributed_mesh=None, block_mesh=None,
                  topology=None) -> Executor:
    """Resolve run_pp's ``executor=`` argument: a registry name or an
    instance. ``window`` is the streaming executor's window size (ignored
    by the others). The sharded executor and the multi-device placements
    (``distributed_mesh``, ``block_mesh``, ``topology``) come with ROADMAP
    step 10."""
    later = [name for name, arg in (("distributed_mesh", distributed_mesh),
                                    ("block_mesh", block_mesh),
                                    ("topology", topology))
             if arg is not None]
    if spec == "sharded":
        later.append("executor='sharded'")
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: not ported yet (ROADMAP §A step 10: "
            f"topologies, the sharded executor and the intra-block "
            f"distributed chain); use one of {' | '.join(EXECUTORS)}")
    if isinstance(spec, Executor):
        if window is not None:
            raise ValueError(
                "window with an Executor instance is ambiguous — construct "
                "the executor with it yourself or pass the executor by name")
        return spec
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if spec not in EXECUTORS:
        raise ValueError(f"unknown executor {spec!r} "
                         f"(expected {' | '.join(EXECUTORS)})")
    if spec == "streaming" and window is not None:
        return StreamingExecutor(window=int(window))
    return EXECUTORS[spec]()


def _run_meta(seed: int, part: Partition, cfg: BMF.BMFConfig) -> Dict:
    """The fields that determine a PP run's numbers — written to the
    checkpoint's meta.json and validated on resume. The executor is left
    out: block chains are executor-independent."""
    return {
        "format": 1,
        "I": part.I, "J": part.J, "K": cfg.K,
        "n_samples": cfg.n_samples, "burnin": cfg.burnin,
        "phase_bc_samples": cfg.phase_bc_samples,
        "seed": int(seed),
    }


def _restore_resume(ctx: PhaseContext, resume_from, meta: Dict):
    """Load a checkpoint directory's resolved blocks into the context:
    posteriors into the device store (successors read them as priors) and
    finished BlockOutcomes into ``ctx.resumed`` (their tasks are pruned
    from the executed graph). A directory of another run is a usage
    error, named after resume_from."""
    from repro_torch.checkpoint.ckpt import PPCheckpoint
    saved = PPCheckpoint.read_meta(resume_from)
    for k, v in meta.items():
        if saved.get(k) != v:
            raise ValueError(
                f"resume_from={str(resume_from)!r} was written by a "
                f"different run: {k} is {saved.get(k)!r} there but {v!r} "
                f"here — resume requires identical grid, K, chain config "
                f"and seed")
    for (i, j), d in PPCheckpoint.load_blocks(resume_from).items():
        if not (0 <= i < ctx.part.I and 0 <= j < ctx.part.J):
            raise ValueError(
                f"resume_from={str(resume_from)!r} holds block ({i}, {j}) "
                f"outside this run's {ctx.part.I}x{ctx.part.J} grid")
        U_post = RowGaussians(eta=to_device(d["U_eta"], ctx.device),
                              Lambda=to_device(d["U_Lambda"], ctx.device))
        V_post = RowGaussians(eta=to_device(d["V_eta"], ctx.device),
                              Lambda=to_device(d["V_Lambda"], ctx.device))
        ctx.U_posts[(i, j)] = U_post
        ctx.V_posts[(i, j)] = V_post
        ctx.resumed[(i, j)] = BlockOutcome(
            U_post=U_post, V_post=V_post, pred_mean=None, seconds=0.0,
            sq_err=torch.tensor(float(d["sq"]), dtype=torch.float64),
            n_obs=int(d["n_obs"]), health=torch.ones((), dtype=torch.bool))


def run_phase_graph(seed: int, part: Partition, cfg: BMF.BMFConfig,
                    test: COO, executor: Executor, verbose: bool = False,
                    policy: Optional[FaultPolicy] = None, device=None,
                    noise: Optional[NoiseFactory] = None,
                    fault_plan: Optional[FaultPlan] = None,
                    checkpoint_dir=None, ckpt_every: int = 1,
                    resume_from=None) -> "PP.PPResult":
    """Execute the PP phase graph with ``executor`` and aggregate — the
    engine behind ``pp.run_pp``. Every resolved block passes the
    chain-health guard under ``policy`` before its posterior reaches any
    successor; ``fault_plan`` is the deterministic injection seam.
    ``checkpoint_dir`` persists each resolved block's posteriors
    (flushed even when a block fault raises), and ``resume_from`` restores
    such a directory: restored blocks are pruned from the graph and the
    finished run is bitwise identical to an uninterrupted one (f32
    posteriors round-trip exactly; pending blocks re-run with their
    original seeds)."""
    dev = resolve_device(device)
    I, J = part.I, part.J
    t_start = time.time()
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    shapes = PP.BlockShapes.per_phase(part, test_p)
    ctx = PhaseContext(part=part, cfg=cfg, test_p=test_p, seed=int(seed),
                       shapes=shapes, device=dev, noise=noise,
                       policy=policy if policy is not None else FaultPolicy(),
                       fault_plan=fault_plan)
    meta = _run_meta(seed, part, cfg)
    if resume_from is not None:
        _restore_resume(ctx, resume_from, meta)
        if verbose and ctx.resumed:
            print(f"[pp] resumed {len(ctx.resumed)} block(s) from "
                  f"{resume_from}", flush=True)
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.ckpt import PPCheckpoint
        ctx.ckpt = PPCheckpoint(checkpoint_dir, every=ckpt_every)
        ctx.ckpt.write_meta(meta)

    full_graph = build_phase_graph(part)
    # a resumed block's task is pruned: the executor never re-runs it
    graph = [(ph, pending) for ph, tasks in full_graph
             if (pending := [t for t in tasks if t.coord not in ctx.resumed])]
    # static pre-dispatch validation: acyclic, every dep in the graph or
    # restored — an over-pruned resume fails here, not as a hang
    bad = check_graph({t.coord: list(t.deps) for _, ts in graph for t in ts},
                      resolved=set(ctx.resumed))
    if bad:
        raise ValueError("invalid phase graph: "
                         + "; ".join(v.message for v in bad))
    outcomes, phase_times, spans = {}, {}, {}
    if graph:
        try:
            outcomes, phase_times, spans = executor.run_graph(
                ctx, graph, verbose=verbose)
        finally:
            # a BlockFaultError (or any crash) still lands the buffered
            # blocks on disk — that is what makes the directory resumable
            if ctx.ckpt is not None:
                ctx.ckpt.flush()
    outcomes.update(ctx.resumed)

    sq_err, n_test = 0.0, 0
    per_block_rmse = np.zeros((I, J))
    block_times: Dict[Coord, float] = {}
    for _, tasks in full_graph:
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
                       resumed_blocks=len(ctx.resumed),
                       row_perm=part.row_perm, col_perm=part.col_perm,
                       tau=cfg.tau, K=cfg.K)
