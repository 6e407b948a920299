"""Phase-graph execution engine for Posterior Propagation (port of
``repro.core.engine``).

The paper's §2.2 structure is a three-phase DAG over the I×J block grid:
phase (a) is block (0,0); phase (b) is the first block-row and block-column,
depending only on (a); phase (c) is the interior, depending only on (b).
Within a phase, blocks are embarrassingly parallel.

  SerialExecutor    reference semantics: one chain per block, synchronised
                    after each; a ``Topology(1, S)`` (``distributed_mesh``)
                    shards each chain over S slots.
  StackedExecutor   stacks all blocks of a phase shape bucket along a
                    leading axis and runs ONE batched chain per bucket
                    (``gibbs.run_gibbs_stacked``); the kernels take the
                    block axis directly.
  ShardedExecutor   the stacked batch padded to a multiple of the
                    topology's groups and split over them, each group's
                    share on its own streams; at ``data > 1`` each block's
                    chain is data-sharded over its group
                    (``distributed.run_gibbs_stacked_2d``, ``comm`` mode).
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
is re-dispatched with the same noise. Given a ``core.topology.Topology``
with several groups (on one GPU: several streams), they assign ready
work to the least-loaded healthy group and run the group fault domain:
a group whose dispatches expire ``quarantine_after`` times in a row is
quarantined and its work rebalanced, idle groups steal staged work, and
stragglers get a speculative twin whose loser is never committed. A
block's noise depends on (seed, coord, attempt) only, never on its
group, so all of this leaves the numbers bitwise unchanged.

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
from repro_torch import analysis as LINT
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import pp as PP
from repro_torch.core.partition import Partition
from repro_torch.core.posterior import RowGaussians
from repro_torch.core.topology import Group, Topology
from repro_torch.data.sparse import COO, PaddedCSR, apply_permutation
from repro_torch.noise import GeneratorNoise, block_seed

Coord = Tuple[int, int]

# stable intra-phase bucket order (phase b runs its two buckets back to back)
_TAG_ORDER = ("a", "b_row", "b_col", "c")


class BlockFaultError(RuntimeError):
    """A block exhausted its retry budget (unhealthy chain, repeated
    dispatch failure or repeated watchdog timeout) under
    ``on_fault == 'raise'``."""


class TopologyDegradedError(RuntimeError):
    """Quarantines left fewer healthy device groups than
    ``FaultPolicy.min_groups`` (or none). Raised after any active
    checkpoint is flushed, so the run resumes on another topology (e.g.
    ``Topology.without_groups(dead_groups)``); ``dead_groups`` names the
    quarantined groups in canonical order."""

    def __init__(self, msg: str, dead_groups: Sequence[int] = ()):
        super().__init__(msg)
        self.dead_groups: Tuple[int, ...] = tuple(dead_groups)


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

    The group fault domain (active when the executor's topology has more
    than one group; with one there is nowhere to rebalance to):

    quarantine_after: a group whose dispatches expire this many
      consecutive times is quarantined — never dispatched to again this
      run; its staged share and in-flight blocks rebalance onto healthy
      groups with the same noise (no block retry budget is consumed).
    speculate_at: straggler hedge — a dispatch in flight longer than
      ``speculate_at × rate(group) × est`` is dispatched again on an idle
      healthy group with the same attempt-0 noise; the canonical group
      order picks the committed twin. 0 disables it (the default).
    min_groups: fewer healthy groups than this flushes the checkpoint,
      then continues on the survivors or raises ``TopologyDegradedError``
      per ``on_group_fault`` ("continue" | "raise"). Zero healthy groups
      always raises."""
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
    on, completion is never observed, or withheld for ``slow_s``. With
    ``group_release`` (an object with ``is_set()``, e.g. a
    ``threading.Event``) a slow group's completion is withheld until it
    is set, ``slow_s`` being the timeout: a test can hold a straggler
    until the behaviour it waits for (a steal) has happened, whatever the
    host's speed."""
    nan_at: Dict[Coord, int] = field(default_factory=dict)
    hang_at: Dict[Coord, int] = field(default_factory=dict)
    fail_dispatch_at: Dict[Coord, int] = field(default_factory=dict)
    group_dead_at: Dict[int, int] = field(default_factory=dict)
    group_slow_at: Dict[int, Tuple[int, float]] = field(default_factory=dict)
    group_release: Optional[object] = None

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
    kind: str        # "nonfinite" | "rmse" | "dispatch" | "timeout" | "group"
    attempt: int
    action: str      # "retried" | "redispatched" | "degraded" | "raised"
    #                  | "quarantined" | "rebalanced"


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

    def noise_for(self, blocks: Sequence[Tuple[Coord, int]], device=None):
        """The noise source of a batch of (coord, attempt) blocks — one
        generator per block seeded by (run seed, coord, attempt), unless
        the run was given a factory — on ``device`` (default: the run's).
        A block's draws depend only on its own entry, never on the group
        that runs it, so chains are executor- and placement-independent."""
        if self.noise is not None:
            return self.noise(list(blocks))
        return GeneratorNoise([block_seed(self.seed, c[0], c[1], a)
                               for c, a in blocks],
                              self.device if device is None else device)

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

    def group_withheld(self, sup: float) -> bool:
        """Whether a flight's completion is still withheld: before its
        ``group_suppressed_until`` time, unless the plan's
        ``group_release`` is set (a dead group is never released)."""
        if not sup or time.time() >= sup:
            return False
        release = self.fault_plan.group_release
        return math.isinf(sup) or release is None or not release.is_set()

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


def _read_here(*priors):
    """Mark posteriors read on the current stream of their device: they
    may have been made on another group's stream, and the caching
    allocator must not hand their memory out while this read is pending."""
    for p in priors:
        if p is None:
            continue
        for t in p:
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))


def _task_inputs(ctx: PhaseContext, task: BlockTask, attempt: int,
                 device=None):
    """One block padded to its phase bucket on ``device`` (default: the
    run's), with the injection plan's NaN poison for ``attempt``:
    ``(pad_block_inputs tuple, n_test)``. Never waits for the device."""
    up, vp = ctx.priors(task)
    _read_here(up, vp)
    dev = ctx.device if device is None else device
    return PP.pad_block_inputs_n(
        ctx.part.block(task.i, task.j), ctx.shapes[task.phase], ctx.cfg.K,
        ctx.test_p, None if up is None else up.to(dev),
        None if vp is None else vp.to(dev), device=dev,
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
        self.topology: Optional[Topology] = None
        self._reset_counters()

    def _reset_counters(self):
        # the group fault domain's counters (PPResult.group_stats)
        self.n_quarantined = self.n_steals = 0
        self.n_speculations = self.n_cancels = 0

    def _reset_run_state(self):
        """Clear per-run state, so one instance serves many runs."""
        self.trace = []
        self.timings = {"pad_s": 0.0, "chain_s": 0.0}
        self._reset_counters()

    def placement(self, ctx: PhaseContext) -> Topology:
        """The executor's topology, or one group of one slot on the run's
        device when it was given none. Its devices must be of the run's
        device type."""
        topo = (self.topology if self.topology is not None
                else Topology(1, 1, devices=(ctx.device,)))
        bad = {str(d) for d in topo.devices if d.type != ctx.device.type}
        if bad:
            raise ValueError(
                f"{topo.describe()} does not fit a run on {ctx.device} "
                f"(devices {sorted(bad)}): give the topology that "
                f"device's slots")
        return topo

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


def _data_topology(spec) -> Topology:
    """``distributed_mesh``, the legacy spelling of ``Topology(1, S)``: an
    int S, a device sequence (one slot each) or a one-group Topology."""
    if isinstance(spec, int):
        return Topology(1, spec)
    if isinstance(spec, Topology):
        return spec
    devs = tuple(spec)
    return Topology(1, len(devs), devices=devs)


class SerialExecutor(Executor):
    """One chain per block, synchronised after each (reference
    semantics). A ``topology`` (block must be 1: serial runs one block at
    a time) with ``data > 1`` — or its legacy spelling
    ``distributed_mesh`` — shards each block's chain over the group's
    slots (``distributed.run_gibbs_distributed``, 'psum')."""
    name = "serial"

    def __init__(self, distributed_mesh=None, record_trace: bool = False,
                 topology=None):
        super().__init__(record_trace=record_trace)
        if topology is not None and distributed_mesh is not None:
            raise ValueError("pass distributed_mesh OR topology, not both")
        if distributed_mesh is not None:
            topology = _data_topology(distributed_mesh)
        if topology is not None:
            topology = Topology.from_spec(topology)
            if topology.block != 1:
                raise ValueError(
                    f"serial executor runs one block at a time — a topology "
                    f"with block={topology.block} device groups needs the "
                    f"sharded/async/streaming executor")
        self.topology = topology
        self.distributed_mesh = (topology if topology is not None
                                 and topology.data > 1 else None)

    def run_phase(self, ctx, phase, tasks):
        self.placement(ctx)
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
                                   poison_nan=ctx.should_poison(t.coord),
                                   distributed_mesh=self.distributed_mesh)
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
        n = len(group)
        sel = group + [group[-1]] * self._batch_pad(ctx, n)
        buf = PP.new_block_inputs(s, ctx.cfg.K, len(sel), ctx.device,
                                  priors[0][0] is not None,
                                  priors[0][1] is not None)
        for b, (t, (up, vp)) in enumerate(zip(group, priors)):
            PP.fill_block_inputs(buf, b, ctx.part.block(t.i, t.j), s,
                                 ctx.test_p, up, vp)
            if ctx.should_poison(t.coord):
                PP.poison_block_inputs(buf, b)
        if len(sel) > n:              # batch padding repeats the last block
            for x in buf.values():
                x[n:] = x[n - 1]
        _sync(ctx.device)
        t_chain = time.time()
        self.timings["pad_s"] += t_chain - t_pad
        pad0 = self.timings["pad_s"]
        res = self._dispatch_stacked(ctx, s, sel, PP.unpack_block_inputs(
            buf, s), ctx.block_cfg(group[0]))
        _sync(ctx.device)
        self.timings["chain_s"] += (time.time() - t_chain
                                    - (self.timings["pad_s"] - pad0))
        for t in group:
            self._record("resolve", t.coord)
        per = (time.time() - t0) / len(group)
        for b, t in enumerate(group):
            out[t.coord] = _outcome(res[b], ctx.part.block(t.i, t.j), per)
        return out

    def _batch_pad(self, ctx, n: int) -> int:
        """Blocks to append to a bucket's batch of ``n`` (repeats of the
        last one, whose results are dropped)."""
        return 0

    def _dispatch_stacked(self, ctx, s, sel, inputs, cfg):
        """Bucket-dispatch seam: the batch's chains (``sel`` lists its
        tasks, padding included; ``inputs`` is ``pp.unpack_block_inputs``)
        as one result per batch entry. The stacked executor runs one
        batched chain; the sharded executor places the batch on its
        topology."""
        csr_r, csr_c, tr, tc, _, _, up, vp = inputs
        res = GIBBS.run_gibbs_stacked(
            ctx.noise_for([(t.coord, 0) for t in sel]), csr_r, csr_c, tr,
            tc, cfg, U_prior=up, V_prior=vp, device=ctx.device)
        return [GIBBS.tree_map(lambda x: x[b], res) for b in range(len(sel))]


def _stacked_csrt(ctx: PhaseContext, tasks: Sequence[BlockTask], s,
                  grp: Group, scatter: bool) -> List[PaddedCSR]:
    """Per-shard transposed planes of a batch for the composed chain's
    'psum'/'scatter' V-step: shard s's (B, D_pad, M_c) planes on its
    slot's device, built on the device from each block's live entries
    (``distributed.shard_transposed_entries``, O(nnz) on the host; the
    dense planes never exist there). ``tasks`` may repeat a block (batch
    padding); its entries are computed once."""
    from repro_torch.core import distributed as DIST
    S = grp.size
    N_pad = -(-s.n_rows // S) * S
    D_pad = -(-s.n_cols // S) * S if scatter else s.n_cols
    M = _pad8(s.m_cols)
    B = len(tasks)
    planes = [PaddedCSR(torch.zeros((B, D_pad, M), dtype=torch.int32,
                                    device=dev),
                        torch.zeros((B, D_pad, M), device=dev),
                        torch.zeros((B, D_pad, M), device=dev), N_pad // S)
              for dev in grp.devices]
    cache: Dict[Coord, list] = {}
    for b, t in enumerate(tasks):
        if t.coord not in cache:
            coo = ctx.part.block(t.i, t.j).coo
            cache[t.coord] = DIST.shard_transposed_entries(
                coo.row, coo.col, coo.val, S, N_pad, D_pad, s.m_cols)
        for pl, ent, dev in zip(planes, cache[t.coord], grp.devices):
            PP.scatter_entries(pl.idx[b], pl.val[b], pl.mask[b],
                               *(to_device(a, dev) for a in ent))
            if ctx.should_poison(t.coord):
                pl.val[b].fill_(float("nan"))
    return planes


class ShardedExecutor(StackedExecutor):
    """StackedExecutor with the bucket batch placed by a ``Topology``:
    the batch is padded to a multiple of ``topology.block`` and split over
    the groups, each group's share a stacked chain on its own streams
    (one GPU: the groups' kernels overlap on the SMs). At ``data > 1``
    each block's chain is data-sharded over its group's slots
    (``distributed.run_gibbs_stacked_2d``) in the ``comm`` mode: 'gather'
    (factor exchange, the stacked chain itself), 'psum' (item-statistics
    reduction) or 'scatter' (reduce-scatter). No collective ever crosses
    groups: posterior summaries meet only at the phase boundary."""
    name = "sharded"

    def __init__(self, topology=None, record_trace: bool = False,
                 comm: str = "gather"):
        from repro_torch.core import distributed as DIST
        super().__init__(record_trace=record_trace)
        if comm not in DIST.COMM_MODES:
            raise ValueError(f"comm={comm!r} not in {DIST.COMM_MODES}")
        self.topology = (None if topology is None
                         else Topology.from_spec(topology))
        self.comm = comm

    def _batch_pad(self, ctx, n: int) -> int:
        return (-n) % self.placement(ctx).block

    def _dispatch_stacked(self, ctx, s, sel, inputs, cfg):
        from repro_torch.core import distributed as DIST
        topo = self.placement(ctx)
        n_g = len(sel) // topo.block
        groups = [topo.slots(g) for g in range(topo.block)]
        csr_r, csr_c, tr, tc, _, _, up, vp = inputs
        main = (torch.cuda.current_stream(ctx.device)
                if ctx.device.type == "cuda" else None)
        results = []
        for g, grp in enumerate(groups):
            part = slice(g * n_g, (g + 1) * n_g)
            share = sel[part]
            on = lambda x: None if x is None else GIBBS.tree_map(  # noqa
                lambda y: y[part].to(grp.lead, non_blocking=True), x)
            if main is not None:
                grp.streams[0].wait_stream(main)
            with grp.on(0):
                csrt = None
                if self.comm != "gather" and grp.size > 1:
                    t_pad = time.time()
                    csrt = _stacked_csrt(ctx, share, s, grp,
                                         self.comm == "scatter")
                    self.timings["pad_s"] += time.time() - t_pad
                results.append(DIST.run_gibbs_stacked_2d(
                    ctx.noise_for([(t.coord, 0) for t in share],
                                  device=grp.lead),
                    on(csr_r), on(csr_c), on(tr), on(tc), cfg, topo,
                    on(up), on(vp), comm=self.comm, csrt=csrt, group=grp))
        if main is not None:
            for grp in groups:
                main.wait_stream(grp.streams[0])
        return [GIBBS.tree_map(lambda x: x[b].to(ctx.device), res)
                for res in results for b in range(n_g)]


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
    ``quarantine_after``; ``quarantine`` drains a group. With one device
    group only ``observe``, ``rate`` and ``note_resolve`` are exercised:
    they set the watchdog's deadlines."""

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


def _maybe_degrade_topology(ctx: PhaseContext, health: _GroupHealth):
    """Graceful topology degradation, checked after every quarantine:
    fewer healthy groups than ``FaultPolicy.min_groups`` (or none at all)
    flushes the checkpoint, then continues on the survivors or raises
    ``TopologyDegradedError`` per ``FaultPolicy.on_group_fault``."""
    pol = ctx.policy
    survivors = health.healthy()
    if len(survivors) >= pol.min_groups:
        return
    if ctx.ckpt is not None:
        ctx.ckpt.flush()
    if pol.on_group_fault == "continue" and survivors:
        return
    dead = sorted(health.quarantined)
    raise TopologyDegradedError(
        f"{len(survivors)} healthy device group(s) left (quarantined: "
        f"{dead}), below min_groups={pol.min_groups} "
        f"(on_group_fault={pol.on_group_fault!r}; checkpoint flushed)",
        dead_groups=dead)


def _settle(ctx: PhaseContext, groups: Sequence[Group]):
    """End of an overlapped run: the run device's current stream waits for
    every group's slot streams, and the posterior store is marked read
    there (the aggregation reads it on that stream)."""
    if ctx.device.type != "cuda":
        return
    for grp in groups:
        for st in grp._streams or ():
            if st is not None:
                torch.cuda.current_stream(st.device).wait_stream(st)
    _read_here(*ctx.U_posts.values(), *ctx.V_posts.values())


class AsyncExecutor(_Overlapped):
    """Dependency-driven overlapped schedule over the topology's device
    groups.

    Readiness counters over ``BlockTask.deps`` replace the phase barrier:
    each block is dispatched (one single-block chain, the serial
    executor's bucketed shapes) the moment both of its prior sources have
    resolved. The host never waits inside a dispatch (``_dispatch``), so
    it pads the next block while the card runs the last. Completion is a
    ``torch.cuda.Event`` polled with ``query()`` under an adaptive sleep,
    policed by the watchdog (``FaultPolicy.watchdog``). Posterior
    summaries stay on the device and feed successors directly.

    ``topology`` (default: one group on the run's device): ready blocks go
    to the least-loaded healthy group and run on that group's lead stream
    (several groups on one GPU are several streams; at ``data > 1`` each
    chain is data-sharded over the group's slots,
    ``distributed.run_gibbs_stacked_2d`` in ``comm`` mode). With more than
    one group each holds at most ``depth`` blocks in flight and the rest
    of its share stays STAGED, which is what the group fault domain
    rebalances: an idle group STEALS the highest-priority staged block of
    the most-loaded group, a group whose dispatches expire
    ``quarantine_after`` times in a row is QUARANTINED (staged share
    re-queued, in-flight blocks redispatched elsewhere with the same
    noise), and a dispatch past ``speculate_at ×`` its group's rate is
    twinned on an idle group; resolution commits the canonical-group
    winner and the loser's result is never committed (a launched kernel
    cannot be cancelled). With one group all of this is inert and
    dispatch is unbounded.

    ``record_trace=True`` appends (event, coord, group) entries to
    ``self.trace`` in real order; ``_is_resolved`` is the seam the tests
    override to fake completion orders. ``priority=True`` pops the ready
    queue critical-path-first, ``False`` in FIFO order."""
    name = "async"

    def __init__(self, record_trace: bool = False, priority: bool = True,
                 topology=None, comm: str = "gather", depth: int = 2):
        from repro_torch.core import distributed as DIST
        super().__init__(record_trace=record_trace, priority=priority)
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if comm not in DIST.COMM_MODES:
            raise ValueError(f"comm={comm!r} not in {DIST.COMM_MODES}")
        self.topology = (None if topology is None
                         else Topology.from_spec(topology))
        self.comm = comm
        self.depth = int(depth)    # per-group in-flight cap (multi-group)

    def run_graph(self, ctx, graph, verbose: bool = False):
        self._reset_run_state()
        topo = self.placement(ctx)
        groups = [topo.slots(g) for g in range(topo.block)]
        tasks, phase_of, waiting, succ, ready = _dep_state(
            ctx, graph, self.priority)
        est = _block_cost_estimates(ctx, tasks)
        pol = ctx.policy
        G = topo.block
        health = _GroupHealth(G, pol.quarantine_after)
        elastic = G > 1    # one group: nowhere to rebalance, steal or twin
        cap = self.depth if elastic else None
        # per-group staged share (assigned, undispatched: the steal pool)
        staged = [_ReadyQueue(ready._prio) for _ in range(G)]
        flights: Dict[Coord, List[_Flight]] = {}   # > 1: speculative twins
        outcomes: Dict[Coord, BlockOutcome] = {}
        spans: Dict[Coord, Tuple[float, float]] = {}
        first_d: Dict[str, float] = {}
        last_r: Dict[str, float] = {}
        remaining = {ph: len(ts) for ph, ts in graph}
        t0 = time.time()

        def n_inflight(g):
            return sum(1 for fl in flights.values() for f in fl
                       if f.group == g)

        def n_assigned(g):
            return len(staged[g]) + n_inflight(g)

        def pick_group():
            return min(health.healthy(), key=lambda g: (n_assigned(g), g))

        def deadline(c, f):
            # generous floor + slack × the group's calibrated rate × the
            # block's cost. A false expiry is benign: the re-dispatch
            # draws the same attempt-0 noise, so it resolves to the same
            # numbers.
            return (pol.timeout_floor_s
                    + pol.timeout_slack * health.rate(f.group) * est[c])

        def flight_ready(c, f):
            if ctx.is_hung(c):
                return False
            if ctx.group_withheld(f.sup):
                return False
            return self._is_resolved(c, f.sig)

        def retire(c, out, td, g, kind=None):
            self._record("resolve", c, g)
            out = _commit_guard(ctx, tasks[c], out, kind=kind)
            tr = time.time()
            if not out.seconds:
                out.seconds = tr - td
            if kind is None:
                # the group's first resolve (warm-up span) is dropped in
                # observe()
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

        def launch(c, g):
            """Dispatch block ``c`` on group ``g``'s lead stream: a
            ``_Flight``, or the dispatch error."""
            td = time.time()
            sup = ctx.group_suppressed_until(g, ctx.next_group_ordinal(g), td)
            with groups[g].on(0):
                sig, host, out = self._dispatch(ctx, tasks[c], groups[g])
            return _Flight(sig=sig, host=host, out=out, td=td, group=g,
                           sup=sup)

        def dispatch_on(c, g, event):
            self._record(event, c, g)
            first_d.setdefault(phase_of[c], time.time() - t0)
            try:
                f = launch(c, g)
            except _DISPATCH_ERRORS:
                retire(c, None, time.time(), g, kind="dispatch")
                return
            flights.setdefault(c, []).append(f)

        def cancel(c, f):
            self._record("cancel", c, f.group)
            self.n_cancels += 1

        def quarantine_group(g, trigger):
            """Drain group ``g``: no later dispatch targets it, its staged
            share returns to the ready queue and its in-flight blocks go
            to healthy groups with the same noise (kind "group": no block
            retry budget is consumed)."""
            health.quarantine(g)
            self._record("quarantine", trigger, g)
            self.n_quarantined += 1
            ctx.record_fault(trigger, "group", "quarantined")
            _maybe_degrade_topology(ctx, health)   # may raise (ckpt flushed)
            while staged[g]:
                ready.push(staged[g].pop())
            for c2 in list(flights):
                fl = flights[c2]
                mine = [f for f in fl if f.group == g]
                if not mine:
                    continue
                keep = [f for f in fl if f.group != g]
                if keep:              # its healthy twin flies on
                    for f in mine:
                        cancel(c2, f)
                    flights[c2] = keep
                    continue
                flights.pop(c2)
                self._record("expire", c2, g)
                ctx.record_fault(c2, "group", "rebalanced")
                dispatch_on(c2, pick_group(), "redispatch")

        def handle_expiries(now):
            """Watchdog sweep: expire overdue flights, count consecutive
            expiries toward quarantine, re-dispatch or retire terminally.
            True when any state changed."""
            changed = False
            for c in list(flights):
                fl = flights.get(c)
                if fl is None:
                    continue
                dead = [f for f in fl if now - f.td > deadline(c, f)]
                if not dead:
                    continue
                changed = True
                live = [f for f in fl if f not in dead]
                if live:              # the twin flies on: this side cancels
                    flights[c] = live
                    for f in dead:
                        cancel(c, f)
                        if elastic and health.note_expiry(f.group):
                            quarantine_group(f.group, c)
                    continue
                flights.pop(c)
                self._record("expire", c, dead[0].group)
                for f in dead[1:]:
                    cancel(c, f)
                for f in dead:
                    if elastic and health.note_expiry(f.group):
                        quarantine_group(f.group, c)
                if ctx.cur_attempt(c) < pol.max_retries:
                    ctx.record_fault(c, "timeout", "redispatched")
                    ctx.attempts[c] = ctx.cur_attempt(c) + 1
                    dispatch_on(c, pick_group(), "redispatch")
                else:
                    retire(c, None, dead[0].td, dead[0].group,
                           kind="timeout")
            return changed

        def maybe_speculate(now):
            """Straggler hedge: a sole flight past ``speculate_at ×`` its
            group's calibrated rate × cost is twinned on an idle healthy
            group with the same attempt-0 noise."""
            if not elastic or pol.speculate_at <= 0.0:
                return
            for c in list(flights):
                fl = flights[c]
                if len(fl) != 1:
                    continue
                f = fl[0]
                r = health.rate(f.group)
                if r <= 0.0 or now - f.td <= pol.speculate_at * r * est[c]:
                    continue
                idle = [g for g in health.healthy()
                        if g != f.group and not staged[g]
                        and n_inflight(g) < cap]
                if not idle:
                    continue
                g2 = min(idle, key=lambda g: (n_assigned(g), g))
                try:
                    twin = launch(c, g2)
                except _DISPATCH_ERRORS:
                    continue          # the primary still flies
                self._record("speculate", c, g2)
                self.n_speculations += 1
                fl.append(twin)

        def await_progress():
            """Poll with an adaptive sleep until a flight resolves or the
            watchdog changes state; without the watchdog, block on the
            oldest flight."""
            if not pol.watchdog:
                c0 = min(flights, key=lambda c: flights[c][0].td)
                sig = flights[c0][0].sig
                if sig is not None:
                    sig.synchronize()
                return
            sleep = 5e-5
            while flights:
                if any(flight_ready(c, f) for c, fl in flights.items()
                       for f in fl):
                    return
                now = time.time()
                if handle_expiries(now):
                    return
                maybe_speculate(now)
                time.sleep(sleep)
                sleep = min(sleep * 2, 2e-3)

        try:
            while ready or any(staged) or flights:
                while ready:          # to the least-loaded healthy group
                    staged[pick_group()].push(ready.pop())
                progress = False
                for g in health.healthy():
                    while staged[g] and (cap is None
                                         or n_inflight(g) < cap):
                        dispatch_on(staged[g].pop(), g, "dispatch")
                        progress = True
                if elastic and not progress:
                    # work stealing: an idle healthy group takes the
                    # highest-priority staged block of the most-loaded one
                    for g in health.healthy():
                        if staged[g] or n_inflight(g) >= cap:
                            continue
                        victims = [h for h in health.healthy()
                                   if h != g and staged[h]]
                        if not victims:
                            continue
                        v = max(victims, key=lambda h: (n_assigned(h), -h))
                        c = staged[v].pop()
                        self._record("steal", c, g)
                        self.n_steals += 1
                        dispatch_on(c, g, "dispatch")
                        progress = True
                if progress or not flights:
                    continue
                await_progress()
                for c in [c for c, fl in flights.items()
                          if any(flight_ready(c, f) for f in fl)]:
                    fl = flights.pop(c, None)
                    if fl is None:
                        continue
                    rd = [f for f in fl if flight_ready(c, f)]
                    if not rd:        # observed ready a moment ago only
                        flights[c] = fl
                        continue
                    # deterministic winner: canonical group order among the
                    # ready flights — twins draw the same noise, so either
                    # is bitwise the fault-free result
                    win = min(rd, key=lambda f: f.group)
                    for f in fl:
                        if f is not win:
                            cancel(c, f)
                    # successors must consume the winner's handles, not
                    # those of a twin or an expired attempt
                    ctx.U_posts[c], ctx.V_posts[c] = (win.out.U_post,
                                                      win.out.V_post)
                    _adopt_host(win.out, win.host, 0)
                    health.note_resolve(win.group)
                    retire(c, win.out, win.td, win.group)
        finally:
            _settle(ctx, groups)
        # per-phase envelopes: first dispatch → last resolve. Phases
        # overlap, so these may sum to MORE than the wall time.
        return outcomes, self._finish_timings(first_d, last_r), spans

    def _dispatch(self, ctx: PhaseContext, task: BlockTask,
                  group: Optional[Group] = None):
        """Enqueue one block's chain on the current stream of ``group``'s
        lead device (default: one slot on the run's device) without
        waiting for the device. Returns ``(completion event, host copy of
        (Σ err², health), BlockOutcome)``. The redispatch of an expired
        attempt draws the attempt-0 noise again (only the commit guard's
        retries draw from attempt ``a``)."""
        from repro_torch.core import distributed as DIST
        c = task.coord
        ctx.check_dispatch(c)
        grp = Group(0, (ctx.device,)) if group is None else group
        t_pad = time.time()
        (csr_r, csr_c, tr, tc, tv, tmask, up, vp), n_obs = _task_inputs(
            ctx, task, ctx.cur_attempt(c), device=grp.lead)
        csrt = None
        if self.comm != "gather" and grp.size > 1:
            csrt = _stacked_csrt(ctx, [task], ctx.shapes[task.phase], grp,
                                 self.comm == "scatter")
        self.timings["pad_s"] += time.time() - t_pad
        res = DIST.run_gibbs_group(ctx.noise_for([(c, 0)], device=grp.lead),
                                   csr_r, csr_c, tr, tc, ctx.block_cfg(task),
                                   None, grp, U_prior=up, V_prior=vp,
                                   comm=self.comm, csrt=csrt)
        blk = ctx.part.block(task.i, task.j)
        U_post = _trim(res.U_post, len(blk.row_ids))
        V_post = _trim(res.V_post, len(blk.col_ids))
        sq = _block_sq_err(res.acc.pred_sum, res.acc.pred_cnt, tv, tmask)
        # device-resident store write AT DISPATCH: successors (dispatched
        # only after this block resolves) read these tensors directly
        ctx.U_posts[c], ctx.V_posts[c] = U_post, V_post
        sig, host = _completion(grp.lead, sq.reshape(1),
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
                 depth: int, device=None):
        dev = ctx.device if device is None else device
        self.device = dev
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
        self.numel = numel
        self.slots: List[_Slot] = []
        self.free: List[int] = []
        # per slot, the storages of its planes (data pointers): the only
        # ones a chunk's planes may live in
        self.storages: List[Tuple[int, ...]] = []
        for _ in range(depth + 1):
            self._grow()

    def _grow(self):
        dev = self.device
        d = {k: torch.empty(self.numel[k], dtype=dt, device=dev)
             for k, dt in {**_PLANES, **_STAGED}.items()}
        h = {k: torch.empty(self.numel[k], dtype=dt, pin_memory=self.cuda)
             for k, dt in _STAGED.items()}
        self.free.append(len(self.slots))
        self.slots.append(_Slot(dev=d, host=h))
        self.storages.append(tuple(d[k].untyped_storage().data_ptr()
                                   for k in _PLANES))

    @property
    def bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for sl in self.slots for t in sl.dev.values())

    def acquire(self) -> _Slot:
        """A free slot; its pinned staging buffer is ready to rewrite. A
        window holds ``depth + 1`` slots; only work rebalanced onto a
        group whose window is full (the group fault domain) adds one."""
        if not self.free:
            self._grow()
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

    def close(self):
        """The device's current stream waits for the copy stream before
        the slots go back to the allocator."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(
                self.copy_stream)


@dataclass(eq=False)
class _StagedChunk:
    """A window chunk whose copy to the device has been issued (the
    prefetch), waiting to dispatch."""
    tasks: List[BlockTask]        # true tasks, ≤ W (repeat-padded to W)
    shape: "PP.BlockShapes"
    cfg: BMF.BMFConfig
    slot: _Slot
    n_obs: List[int]
    group: int = 0


def _window_prior(ctx: PhaseContext, sel: Sequence[BlockTask], side: int,
                  n: int, device) -> RowGaussians:
    """(W, n, …) prior of one factor for a chunk on ``device``: each
    block's propagated prior, padded with N(0, I) rows, and N(0, I) where
    it has none (its ``prior_use`` flag is 0 there, so those rows are
    never selected)."""
    K = ctx.cfg.K
    eta = torch.zeros((len(sel), n, K), device=device)
    lam = torch.zeros((len(sel), n, K, K), device=device)
    lam.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    for b, t in enumerate(sel):
        p = ctx.priors(t)[side]
        _read_here(p)
        if p is not None:
            m = p.eta.shape[0]
            eta[b, :m].copy_(p.eta)
            lam[b, :m].copy_(p.Lambda)
    return RowGaussians(eta=eta, Lambda=lam)


class StreamingExecutor(_Overlapped):
    """Bounded-window streaming schedule for grids whose stacked buckets
    do not fit the device, over the topology's device groups.

    The SAME dependency-driven ready queue as the async executor, but
    blocks move through a bounded window (``_Window``) per group:

      * ready blocks pop critical-path-first and are grouped into chunks
        of up to W blocks sharing one window shape and chain config; a
        short chunk is repeat-padded to exactly W, so the batched
        Cholesky and solves always see one batch size;
      * each chunk's ratings and test entries are assembled on the host
        into its group's pinned staging buffer and copied on that group's
        copy stream while the group's previous chunk computes (the
        double-buffered prefetch, per group);
      * chunks run through ``distributed.run_gibbs_stacked_2d`` on the
        group's lead stream with per-block ``prior_use`` flags, so one
        window shape serves phase-a/b/c blocks despite their different
        prior structures (at ``data > 1`` data-sharded in 'gather' mode,
        the only mode that composes with the flags, as in the reference);
      * each group has at most ``depth`` chunks in flight and one staged:
        ``peak_window_blocks`` ≤ G·W·(depth+1) for G groups;
      * per-phase shape buckets are coalesced first
        (``pp.BlockShapes.coalesce``): ``max_waste`` = 1.0 (default)
        merges only identical shapes, which keeps the serial executor's
        chains; more trades that for fewer window shapes.

    With several groups the group fault domain works on chunks as the
    async executor's does on blocks: every idle group stages one chunk
    before any stages a second; an idle group steals a staged chunk; a
    quarantined group's staged chunk returns to the ready queue and its
    in-flight chunks re-stage on the least-loaded healthy group; a
    straggling chunk gets a speculative twin on an idle group.

    A block's chain draws from its own generator, and the aggregation
    sums in grid order, so the results do not depend on how completion
    timing regroups the chunks, nor on which group runs them."""
    name = "streaming"
    window_cls = _Window        # an instance may plant another window type

    def __init__(self, window: int = 4, max_waste: float = 1.0,
                 priority: bool = True, depth: int = 2,
                 record_trace: bool = False, topology=None,
                 comm: str = "gather"):
        super().__init__(record_trace=record_trace, priority=priority)
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if comm != "gather":
            # window chunks run prior_use-flagged chains; only the 'gather'
            # exchange composes with them (and at data == 1 no other mode
            # means anything)
            raise ValueError(f"streaming executor supports comm='gather' "
                             f"only, got {comm!r}")
        self.window = int(window)
        self.max_waste = max_waste
        self.depth = int(depth)               # in-flight chunks per group
        self.topology = (None if topology is None
                         else Topology.from_spec(topology))
        self.comm = comm
        self.peak_window_blocks = 0           # realized live-window bound
        self.window_shapes: Optional[Dict[str, "PP.BlockShapes"]] = None
        self.window_bytes = 0                 # the slots' device bytes
        # under record_trace: (group, plane storages) per chunk dispatch;
        # after a run, each group's slot storages (``_Window.storages``)
        # — the analyzer's 'donation-effectiveness' pass
        self.window_planes: List[Tuple[int, Tuple[int, ...]]] = []
        self.window_slots: Dict[int, List[Tuple[int, ...]]] = {}

    def _group_key(self, ctx, task, shapes):
        cfg = ctx.block_cfg(task)
        return (id(shapes[task.phase]), cfg.n_samples, cfg.burnin)

    def _reset_run_state(self):
        super()._reset_run_state()
        self.peak_window_blocks = 0
        self.window_shapes = None
        self.window_bytes = 0
        self.window_planes = []
        self.window_slots = {}

    def _stage(self, ctx: PhaseContext, chunk: List[BlockTask], shapes,
               win: _Window, group: int = 0) -> _StagedChunk:
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
                            slot=slot, n_obs=n_obs, group=group)

    def _dispatch(self, ctx: PhaseContext, st: _StagedChunk, win: _Window,
                  grp: Group):
        """Run one staged chunk on the current stream of its group's lead
        device once its slot is staged. Returns ``(completion event, host
        copy (W, 2), {coord: BlockOutcome})``; the padded duplicates are
        dropped."""
        from repro_torch.core import distributed as DIST
        s, W = st.shape, self.window
        if win.cuda:
            torch.cuda.current_stream(win.device).wait_event(st.slot.staged)
        pl = win.planes(st.slot, s, W)
        if self.record_trace:
            self.window_planes.append((grp.index, tuple(
                p.untyped_storage().data_ptr() for p in pl.values())))
        tr, tc, tv, tmask = (win.view(st.slot, k, (W, s.n_test))
                             for k in ("tr", "tc", "tv", "tmask"))
        use = tuple(win.view(st.slot, k, (W,)) for k in ("u_use", "v_use"))
        sel = st.tasks + [st.tasks[-1]] * (W - len(st.tasks))
        res = DIST.run_gibbs_stacked_2d(
            ctx.noise_for([(t.coord, 0) for t in sel], device=grp.lead),
            PaddedCSR(pl["idx_r"], pl["val_r"], pl["mask_r"], s.n_cols),
            PaddedCSR(pl["idx_c"], pl["val_c"], pl["mask_c"], s.n_rows),
            tr, tc, st.cfg, None,
            _window_prior(ctx, sel, 0, s.n_rows, grp.lead),
            _window_prior(ctx, sel, 1, s.n_cols, grp.lead), prior_use=use,
            comm=self.comm, group=grp)
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
        sig, host = _completion(grp.lead, sq, res.health)
        st.slot.reader = sig
        return sig, host, outs

    def run_graph(self, ctx, graph, verbose: bool = False):
        self._reset_run_state()
        topo = self.placement(ctx)
        groups = [topo.slots(g) for g in range(topo.block)]
        G = topo.block
        shapes = PP.BlockShapes.coalesce(ctx.shapes, ctx.cfg.K,
                                         self.max_waste)
        tasks, phase_of, waiting, succ, ready = _dep_state(
            ctx, graph, self.priority,
            make_queue=lambda prio, ts: _GroupedReadyQueue(
                prio, lambda c: self._group_key(ctx, ts[c], shapes)))
        self.window_shapes = shapes
        pol = ctx.policy
        health = _GroupHealth(G, pol.quarantine_after)
        elastic = G > 1    # one group: nowhere to rebalance, steal or twin
        # one window per group: its own slots, pinned staging and copy
        # stream
        wins = [self.window_cls(ctx, shapes, tasks, self.window, self.depth,
                                device=grp.lead) for grp in groups]
        self.window_bytes = sum(w.bytes for w in wins)
        if verbose:
            n_buckets = len({id(s) for s in shapes.values()})
            print(f"[pp:{self.name}] window={self.window} depth={self.depth} "
                  f"{n_buckets} coalesced bucket(s) over {len(shapes)} phase "
                  f"tag(s), {G} group(s) x {topo.data} slot(s), "
                  f"{self.window_bytes / 2**30:.2f} GiB of window slots",
                  flush=True)
        staged: List[Optional[_StagedChunk]] = [None] * G
        flights: Dict[int, _Flight] = {}    # flight id -> chunk flight
        twin: Dict[int, int] = {}           # speculative twin links, both ways
        fid_next = [0]
        outcomes: Dict[Coord, BlockOutcome] = {}
        spans: Dict[Coord, Tuple[float, float]] = {}
        first_d: Dict[str, float] = {}
        last_r: Dict[str, float] = {}
        remaining = {ph: len(ts) for ph, ts in graph}
        est = _block_cost_estimates(ctx, tasks)
        t0 = time.time()

        def n_inflight(g):
            return sum(1 for f in flights.values() if f.group == g)

        def note_peak():
            live = self.window * (len(flights)
                                  + sum(st is not None for st in staged))
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
            if ctx.group_withheld(f.sup):
                return False
            return self._is_resolved(f.tasks[0].coord, f.sig)

        def retire(t, out, td, tr_, per, g, kind=None):
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

        def run_chunk(ch: _StagedChunk) -> _Flight:
            """Dispatch a staged chunk on its group's lead stream; the
            dispatch consumes one group ordinal (the group-level
            injection unit)."""
            g = ch.group
            td = time.time()
            sup = ctx.group_suppressed_until(g, ctx.next_group_ordinal(g), td)
            with groups[g].on(0):
                sig, host, outs = self._dispatch(ctx, ch, wins[g], groups[g])
            return _Flight(sig=sig, host=host, out=outs, td=td, group=g,
                           sup=sup, tasks=ch.tasks, slot=ch.slot)

        def launch(ch: _StagedChunk, event: str) -> int:
            for t in ch.tasks:
                self._record(event, t.coord, ch.group)
                first_d.setdefault(phase_of[t.coord], time.time() - t0)
            fid = fid_next[0]
            fid_next[0] += 1
            flights[fid] = run_chunk(ch)
            note_peak()
            return fid

        def drop(f: _Flight):
            wins[f.group].release(f.slot)

        def least_loaded():
            return min(health.healthy(), key=lambda g: (n_inflight(g), g))

        def stage_next(g) -> Optional[_StagedChunk]:
            """Pop and stage group ``g``'s next chunk; a block whose
            dispatch fails never joins the window and heals through the
            retry runner."""
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
                        retire(tasks[c], None, now, time.time(), 0.0, g,
                               kind="dispatch")
                if good:
                    return self._stage(ctx, good, shapes, wins[g], g)
            return None

        def cancel_all(f: _Flight, g: int):
            for t in f.tasks:
                self._record("cancel", t.coord, g)
            self.n_cancels += len(f.tasks)

        def quarantine_group(g, trigger):
            """Drain group ``g``: its staged chunk's blocks return to the
            ready queue, and its in-flight chunks re-stage on healthy
            groups with the same noise (kind "group": no block retry
            budget consumed)."""
            health.quarantine(g)
            self._record("quarantine", trigger, g)
            self.n_quarantined += 1
            ctx.record_fault(trigger, "group", "quarantined")
            _maybe_degrade_topology(ctx, health)   # may raise (ckpt flushed)
            if staged[g] is not None:
                wins[g].release(staged[g].slot)
                for t in staged[g].tasks:
                    ready.push(t.coord)
                staged[g] = None
            for fid in [i for i, f in flights.items() if f.group == g]:
                f = flights.pop(fid)
                drop(f)
                tw = twin.pop(fid, None)
                if tw is not None:    # its healthy twin flies on
                    twin.pop(tw, None)
                    cancel_all(f, g)
                    continue
                for t in f.tasks:
                    self._record("expire", t.coord, g)
                    ctx.record_fault(t.coord, "group", "rebalanced")
                h = least_loaded()
                launch(self._stage(ctx, f.tasks, shapes, wins[h], h),
                       "redispatch")

        def handle_expiries(now):
            """Watchdog sweep over the chunk flights; True on any state
            change (expiry, quarantine, redispatch, terminal retire)."""
            changed = False
            for fid in list(flights):
                f = flights.get(fid)
                if f is None or now - f.td <= deadline(f):
                    continue
                changed = True
                flights.pop(fid)
                drop(f)
                tw = twin.pop(fid, None)
                if tw is not None and tw in flights:
                    twin.pop(tw, None)     # the twin flies on
                    cancel_all(f, f.group)
                    if elastic and health.note_expiry(f.group):
                        quarantine_group(f.group, f.tasks[0].coord)
                    continue
                for t in f.tasks:
                    self._record("expire", t.coord, f.group)
                if elastic and health.note_expiry(f.group):
                    quarantine_group(f.group, f.tasks[0].coord)
                if all(ctx.cur_attempt(t.coord) < pol.max_retries
                       for t in f.tasks):
                    # re-stage with the same noise: a slow-but-alive chunk
                    # re-resolves to the same numbers
                    for t in f.tasks:
                        ctx.record_fault(t.coord, "timeout", "redispatched")
                        ctx.attempts[t.coord] = ctx.cur_attempt(t.coord) + 1
                    h = least_loaded()
                    launch(self._stage(ctx, f.tasks, shapes, wins[h], h),
                           "redispatch")
                else:
                    for t in f.tasks:
                        retire(t, None, f.td, now, 0.0, f.group,
                               kind="timeout")
            return changed

        def maybe_speculate(now):
            """Straggler hedge: an untwinned chunk past ``speculate_at ×``
            its group's rate × cost re-stages on an idle healthy group
            with the same noise."""
            if not elastic or pol.speculate_at <= 0.0:
                return
            for fid in list(flights):
                f = flights.get(fid)
                if f is None or fid in twin:
                    continue
                r = health.rate(f.group)
                if (r <= 0.0 or now - f.td
                        <= pol.speculate_at * r * chunk_cost(f.tasks)):
                    continue
                idle = [g for g in health.healthy()
                        if g != f.group and staged[g] is None
                        and n_inflight(g) < self.depth]
                if not idle:
                    continue
                g2 = min(idle, key=lambda g: (n_inflight(g), g))
                for t in f.tasks:
                    self._record("speculate", t.coord, g2)
                self.n_speculations += len(f.tasks)
                ch = self._stage(ctx, f.tasks, shapes, wins[g2], g2)
                try:
                    tw = run_chunk(ch)
                except _DISPATCH_ERRORS:
                    wins[g2].release(ch.slot)
                    cancel_all(f, g2)
                    continue          # the primary still flies
                fid2 = fid_next[0]
                fid_next[0] += 1
                flights[fid2] = tw
                twin[fid], twin[fid2] = fid2, fid
                note_peak()

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
                now = time.time()
                if handle_expiries(now):
                    return
                maybe_speculate(now)
                time.sleep(sleep)
                sleep = min(sleep * 2, 2e-3)

        try:
            while ready or any(st is not None for st in staged) or flights:
                progress = False
                for g in health.healthy():
                    # fair staging: every idle group stages one chunk
                    # before any group prefetches a second
                    if staged[g] is None and ready:
                        staged[g] = stage_next(g)
                        note_peak()
                for g in health.healthy():
                    if staged[g] is not None and n_inflight(g) < self.depth:
                        ch, staged[g] = staged[g], None
                        launch(ch, "dispatch")
                        # the double-buffered prefetch: the group's next
                        # chunk's copy overlaps this chunk's compute
                        if ready:
                            staged[g] = stage_next(g)
                            note_peak()
                        progress = True
                if elastic and not progress:
                    # work stealing: an idle healthy group re-stages the
                    # staged chunk of the most-loaded group onto itself
                    for g in health.healthy():
                        if (staged[g] is not None or ready
                                or n_inflight(g) >= self.depth):
                            continue
                        victims = [h for h in health.healthy()
                                   if h != g and staged[h] is not None]
                        if not victims:
                            continue
                        v = max(victims, key=lambda h: (n_inflight(h), -h))
                        ch, staged[v] = staged[v], None
                        wins[v].release(ch.slot)
                        for t in ch.tasks:
                            self._record("steal", t.coord, g)
                        self.n_steals += len(ch.tasks)
                        launch(self._stage(ctx, ch.tasks, shapes, wins[g], g),
                               "dispatch")
                        progress = True
                if progress or not flights:
                    continue
                await_flights()
                for fid in [i for i, f in flights.items() if flight_ready(f)]:
                    f = flights.get(fid)
                    if f is None:     # its twin already committed the work
                        continue
                    tw = twin.pop(fid, None)
                    if tw is not None and tw in flights:
                        twin.pop(tw, None)
                        # deterministic winner: canonical group order among
                        # the ready sides (twins draw the same noise)
                        cand = [x for x in (fid, tw)
                                if flight_ready(flights[x])] or [fid]
                        win_id = min(cand, key=lambda x: flights[x].group)
                        loser = flights.pop(tw if win_id == fid else fid)
                        drop(loser)
                        cancel_all(loser, loser.group)
                        f = flights.pop(win_id)
                    else:
                        flights.pop(fid)
                    drop(f)
                    tr_ = time.time()
                    # one chain ran the whole chunk: split its wall evenly
                    per = (tr_ - f.td) / len(f.tasks)
                    health.observe(f.group, (tr_ - f.td) / chunk_cost(f.tasks))
                    health.note_resolve(f.group)
                    for b, t in enumerate(f.tasks):
                        out = f.out[t.coord]
                        # successors consume the winner's handles
                        ctx.U_posts[t.coord] = out.U_post
                        ctx.V_posts[t.coord] = out.V_post
                        _adopt_host(out, f.host, b)
                        retire(t, out, f.td, tr_, per, f.group)
        finally:
            _settle(ctx, groups)
            for w in wins:
                w.close()
            self.window_slots = {g: list(w.storages)
                                 for g, w in enumerate(wins)}
        return outcomes, self._finish_timings(first_d, last_r), spans


EXECUTORS: Dict[str, type] = {
    "serial": SerialExecutor,
    "stacked": StackedExecutor,
    "sharded": ShardedExecutor,
    "async": AsyncExecutor,
    "streaming": StreamingExecutor,
}
"""Executor registry; ``run_pp(executor=<name>)`` resolves here, and the
port's executor battery parametrizes over it."""


def make_executor(spec, window=None, distributed_mesh=None, block_mesh=None,
                  topology=None, comm=None) -> Executor:
    """Resolve run_pp's ``executor=`` argument: a registry name or an
    instance. ``topology`` (a ``Topology``, a ``(block, data)`` pair or a
    device sequence) places the serial (block must be 1), sharded, async
    and streaming executors; ``comm`` is the intra-block exchange at
    ``data > 1`` (default 'gather'). ``distributed_mesh`` is the legacy
    spelling of ``topology=Topology(1, S)`` and forces the serial
    executor; ``block_mesh`` the legacy one-slot-per-group placement of
    the sharded and async executors. ``window`` is the streaming
    executor's window size (ignored by the others)."""
    if isinstance(spec, Executor):
        for arg, name in ((distributed_mesh, "distributed_mesh"),
                          (window, "window"), (topology, "topology"),
                          (block_mesh, "block_mesh"), (comm, "comm")):
            if arg is not None:
                raise ValueError(
                    f"{name} with an Executor instance is ambiguous — "
                    f"construct the executor with it yourself or pass the "
                    f"executor by name")
        return spec
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if distributed_mesh is not None:
        if topology is not None:
            raise ValueError("pass distributed_mesh OR topology, not both")
        spec = "serial"
    if spec not in EXECUTORS:
        raise ValueError(f"unknown executor {spec!r} "
                         f"(expected {' | '.join(EXECUTORS)})")
    topo = None if topology is None else Topology.from_spec(topology)
    if spec == "stacked" and (topo is not None or block_mesh is not None):
        raise ValueError(
            "the stacked executor is one batched chain (no device "
            "placement) — use executor='sharded' with a topology")
    if block_mesh is not None:
        if topo is not None:
            raise ValueError("pass block_mesh OR topology, not both")
        topo = Topology.from_spec(block_mesh)
    kw = {} if comm is None else {"comm": comm}
    factories = {
        "serial": lambda: SerialExecutor(distributed_mesh, topology=topo),
        "stacked": lambda: StackedExecutor(),
        "sharded": lambda: ShardedExecutor(topo, **kw),
        "async": lambda: AsyncExecutor(topology=topo, **kw),
        "streaming": lambda: StreamingExecutor(
            topology=topo, **kw,
            **({} if window is None else {"window": int(window)})),
    }
    if comm is not None and spec in ("serial", "stacked"):
        raise ValueError(f"comm applies to the sharded, async and "
                         f"streaming executors, not {spec!r}")
    return factories[spec]()


def _run_meta(seed: int, part: Partition, cfg: BMF.BMFConfig) -> Dict:
    """The fields that determine a PP run's numbers — written to the
    checkpoint's meta.json and validated on resume. The executor and the
    topology are left out: block chains are executor- and
    placement-independent, so a run checkpointed on 4x1 groups resumes
    bitwise on 2x2."""
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
    bad = LINT.analyze(LINT.GraphArtifact(
        "phase-graph", {t.coord: list(t.deps) for _, ts in graph for t in ts},
        resolved=set(ctx.resumed)))
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

    # posteriors of groups on other devices meet on the run's device
    U_posts = [[ctx.U_posts[(i, j)].to(dev) for j in range(J)]
               for i in range(I)]
    V_posts = [[ctx.V_posts[(i, j)].to(dev) for j in range(J)]
               for i in range(I)]
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
                       group_stats=dict(
                           n_quarantined=executor.n_quarantined,
                           n_steals=executor.n_steals,
                           n_speculations=executor.n_speculations,
                           n_cancels=executor.n_cancels),
                       row_perm=part.row_perm, col_perm=part.col_perm,
                       tau=cfg.tau, K=cfg.K)
