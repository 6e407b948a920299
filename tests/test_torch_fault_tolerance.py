"""The port's fault layer — per block and per device group —,
checkpoint/resume and the CLIs that drive them.

Drives every registered executor through the deterministic injection
seam (``engine.FaultPlan``): NaN-poisoned chains, hung dispatches, failed
dispatches — and asserts the recovery contracts of the reference's
battery (``tests/test_fault_tolerance.py``):

  * heal:    a retried block re-runs through the shared single-block
             runner, so the healed run matches the serial executor's
             healed run (within 5e-5 RMSE, the batched chains' rounding);
  * degrade: an unrecoverable block falls back to its propagated prior,
             which cancels exactly in the divide-away aggregation;
  * resume:  a run killed mid-graph restarts from its block checkpoints
             and finishes bitwise identical to an uninterrupted one.

The group fault domain (quarantine, work stealing, speculation, graceful
degradation; the reference's ``tests/test_fault_tolerance.py:421-636``)
runs the async and streaming executors on 2–4-group CPU topologies whose
slots repeat "cpu", held bitwise to the port's own one-group run: the
reference's versions skip on one JAX device, and the one-group run is
already held to the reference (``test_torch_executors.py``).

The checkpoint format is the reference's: each package reads what the
other wrote.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as TCK
from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.core.posterior import RowGaussians
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic as TSYN
from repro_torch.data.sparse import apply_permutation, train_test_split
from torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXECUTOR_NAMES = sorted(TENG.EXECUTORS)
OVERLAPPED = ["async", "streaming"]
# cross-executor parity of a healed run: the stacked/streaming chains
# batch the fp reductions differently from serial's
PARITY_ATOL = 5e-5
SEED = 5


def _make(name, **kw):
    if name == "streaming":
        return TENG.StreamingExecutor(window=2, **kw)
    return TENG.EXECUTORS[name](**kw)


def _run(conf, executor="serial", seed=SEED, **kw):
    part, cfg, test, _ = conf
    return TPP.run_pp(seed, part, kw.pop("cfg", cfg), test,
                      executor=executor, device="cpu", **kw)


@pytest.fixture(scope="module")
def conf_run():
    coo, p = TSYN.generate("mini", seed=13)
    train, test = train_test_split(coo, 0.15, seed=14)
    cfg = TB.BMFConfig(K=p.K, n_samples=5, burnin=1)
    part = TPA.partition(train, 3, 3)          # covers all four phase tags
    conf = (part, cfg, test, None)
    return part, cfg, test, _run(conf)


@pytest.fixture(scope="module")
def serial_healed(conf_run):
    """The serial executor's healed run under the canonical NaN plan."""
    return _run(conf_run, fault_plan=TENG.FaultPlan(nan_at={(1, 1): 1}))


def _assert_trace_dep_safe(trace, part):
    graph = {t.coord: t for _, ts in TENG.build_phase_graph(part) for t in ts}
    dispatched, resolved = set(), set()
    for ev, c, *_ in trace:
        if ev == "dispatch":
            assert set(graph[c].deps) <= resolved
            assert c not in dispatched
            dispatched.add(c)
        else:
            assert ev == "resolve" and c in dispatched
            resolved.add(c)
    assert resolved == set(graph)
    assert len(trace) == 2 * len(graph)


def _finite(res):
    return all(bool(torch.isfinite(x).all())
               for x in (res.U_agg.eta, res.U_agg.Lambda, res.V_agg.eta,
                         res.V_agg.Lambda))


# ---------------------------------------------------------------------------
# NaN-poisoned chains: retry heals, degrade stays finite, raise raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_nan_injection_retry_heals_with_serial_parity(conf_run,
                                                      serial_healed, name):
    ex = _make(name, record_trace=True)
    res = _run(conf_run, ex, fault_plan=TENG.FaultPlan(nan_at={(1, 1): 1}))
    assert res.n_retries == 1
    assert [(f.kind, f.action) for f in res.faults] == \
        [("nonfinite", "retried")]
    assert np.isfinite(res.rmse)
    assert abs(res.rmse - serial_healed.rmse) < PARITY_ATOL
    assert abs(res.per_block_rmse[1, 1]
               - serial_healed.per_block_rmse[1, 1]) < PARITY_ATOL
    _assert_trace_dep_safe(ex.trace, conf_run[0])


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_nan_degrade_yields_finite_result(conf_run, name):
    ref = conf_run[3]
    res = _run(conf_run, _make(name),
               fault_plan=TENG.FaultPlan(nan_at={(1, 1): 99}),
               on_fault="degrade", max_retries=1)
    assert np.isfinite(res.rmse) and _finite(res)
    assert [f.action for f in res.faults] == ["retried", "degraded"]
    assert all(f.coord == (1, 1) for f in res.faults)
    # the degraded block's test entries leave the RMSE
    assert res.n_test < ref.n_test
    assert res.per_block_rmse[1, 1] == 0.0


def test_nan_on_fault_raise_raises(conf_run):
    with pytest.raises(TENG.BlockFaultError, match=r"\(1, 1\).*nonfinite"):
        _run(conf_run, fault_plan=TENG.FaultPlan(nan_at={(1, 1): 99}),
             on_fault="raise", max_retries=1)


def test_nan_phase_a_degrades_to_hyperprior(conf_run):
    """Phase (0,0) has no propagated prior — degrade substitutes N(0, I)
    rows and every downstream block still runs."""
    res = _run(conf_run, fault_plan=TENG.FaultPlan(nan_at={(0, 0): 99}),
               on_fault="degrade", max_retries=0)
    assert np.isfinite(res.rmse) and _finite(res)


def test_poisoned_planes_make_the_chain_non_finite(conf_run):
    """The injected chain really goes non-finite (health False) through
    the shared runner, and the host-side padding poisons the same planes
    the device-side seam does."""
    part, cfg, test, _ = conf_run
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    shapes = TPP.BlockShapes.per_phase(part, test_p)
    ctx = TENG.PhaseContext(part=part, cfg=cfg, test_p=test_p, seed=SEED,
                            shapes=shapes, device=torch.device("cpu"),
                            fault_plan=TENG.FaultPlan(nan_at={(1, 1): 99}))
    K = cfg.K
    for c, rows in (((1, 0), True), ((0, 1), False)):
        blk = part.block(*c)
        n = len(blk.row_ids) if rows else len(blk.col_ids)
        store = ctx.U_posts if rows else ctx.V_posts
        store[c] = RowGaussians(torch.zeros((n, K)),
                                torch.eye(K).expand(n, K, K).contiguous())
    task = [t for _, ts in TENG.build_phase_graph(part) for t in ts
            if t.coord == (1, 1)][0]
    raw = TENG._run_block_attempt(ctx, task, attempt=0)
    assert not bool(raw.health)
    assert TENG._fault_kind(ctx, task, raw) == "nonfinite"
    host = TPP.pad_block_inputs_host(part.block(1, 1), shapes["c"], test_p,
                                     poison_nan=True)
    dev = TPP.pad_block_inputs(part.block(1, 1), shapes["c"], K, test_p,
                               None, None, device="cpu", poison_nan=True)
    for h, d in ((host[0], dev[0]), (host[1], dev[1])):
        assert np.isnan(h.val).all() and bool(torch.isnan(d.val).all())
        np.testing.assert_array_equal(h.idx, d.idx.numpy())
        np.testing.assert_array_equal(h.mask, d.mask.numpy())


# ---------------------------------------------------------------------------
# dispatch failures: healed at every executor's dispatch site
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_dispatch_failure_heals(conf_run, name):
    plan = TENG.FaultPlan(fail_dispatch_at={(0, 1): 1, (2, 2): 2})
    ref = _run(conf_run, fault_plan=plan)
    ex = _make(name, record_trace=True)
    res = _run(conf_run, ex, fault_plan=plan)
    assert res.n_retries == 3            # 1 for (0,1) + 2 for (2,2)
    assert {f.kind for f in res.faults} == {"dispatch"}
    assert abs(res.rmse - ref.rmse) < PARITY_ATOL
    _assert_trace_dep_safe(ex.trace, conf_run[0])


def test_dispatch_failure_exhausted_raises(conf_run):
    with pytest.raises(TENG.BlockFaultError, match=r"\(1, 0\).*dispatch"):
        _run(conf_run, fault_plan=TENG.FaultPlan(fail_dispatch_at={(1, 0):
                                                                   99}),
             max_retries=1)


# ---------------------------------------------------------------------------
# hangs: the watchdog recovers within its deadline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OVERLAPPED)
def test_hang_recovered_by_watchdog(conf_run, name):
    """A dispatch whose completion is never observed is re-dispatched
    after its deadline with the same (attempt-0) noise, so the recovered
    run is bitwise the clean run; the trace shows dispatch < expire <
    redispatch < resolve."""
    from repro_torch.analysis import trace_passes as TTP
    clean = _run(conf_run, _make(name))
    ex = _make(name, record_trace=True)
    res = _run(conf_run, ex, fault_plan=TENG.FaultPlan(hang_at={(1, 1): 1}),
               fault_policy=TENG.FaultPolicy(timeout_floor_s=0.3,
                                             timeout_slack=0.0))
    # streaming's timeout domain is the chunk, so chunk-mates of the hung
    # block may carry redispatch records too — but nothing else happens
    assert {(f.kind, f.action) for f in res.faults} == \
        {("timeout", "redispatched")}
    assert (1, 1) in {f.coord for f in res.faults}
    assert res.rmse == clean.rmse
    torch.testing.assert_close(res.U_agg.eta, clean.U_agg.eta, rtol=0,
                               atol=0)
    events = [e[0] for e in ex.trace if e[1] == (1, 1)]
    assert events == ["dispatch", "expire", "redispatch", "resolve"]
    deps = {t.coord: list(t.deps)
            for _, ts in TENG.build_phase_graph(conf_run[0]) for t in ts}
    assert TTP._happens_before(TTP.TraceArtifact("hang", ex.trace,
                                                 deps)) == []


@pytest.mark.parametrize("name", OVERLAPPED)
def test_hang_budget_exhaustion_degrades(conf_run, name):
    pol = TENG.FaultPolicy(timeout_floor_s=0.2, timeout_slack=0.0,
                           on_fault="degrade", max_retries=1)
    res = _run(conf_run, _make(name),
               fault_plan=TENG.FaultPlan(hang_at={(1, 1): 99}),
               fault_policy=pol)
    assert np.isfinite(res.rmse) and _finite(res)
    assert res.faults[-1].action == "degraded"
    assert any(f.kind == "timeout" for f in res.faults)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


def _interrupt(conf, name, ckpt_dir, **ckpt_kw):
    """Run with checkpointing and an unrecoverable mid-graph dispatch
    failure — the stand-in for a kill: the raise unwinds through the
    engine's flush, leaving a valid resumable directory."""
    with pytest.raises(TENG.BlockFaultError):
        _run(conf, _make(name), checkpoint_dir=ckpt_dir,
             fault_plan=TENG.FaultPlan(fail_dispatch_at={(1, 2): 99}),
             max_retries=0, on_fault="raise", **ckpt_kw)


def _assert_bitwise(res, ref):
    assert res.rmse == ref.rmse and res.n_test == ref.n_test
    for got, want in ((res.U_agg, ref.U_agg), (res.V_agg, ref.V_agg)):
        torch.testing.assert_close(got.eta, want.eta, rtol=0, atol=0)
        torch.testing.assert_close(got.Lambda, want.Lambda, rtol=0, atol=0)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_kill_and_resume_bitwise_identical(conf_run, tmp_path, name):
    ref = _run(conf_run, _make(name))
    d = tmp_path / "ckpt"
    _interrupt(conf_run, name, d)
    n_saved = len(list(d.glob("block_*.npz")))
    assert 0 < n_saved < 9                  # genuinely mid-graph
    res = _run(conf_run, _make(name), resume_from=d)
    assert res.resumed_blocks == n_saved
    _assert_bitwise(res, ref)


def test_resume_skips_restored_blocks(conf_run, tmp_path):
    d = tmp_path / "ckpt"
    _interrupt(conf_run, "async", d)
    restored = {tuple(int(x) for x in p.stem.split("_")[1:])
                for p in d.glob("block_*.npz")}
    ex = _make("async", record_trace=True)
    _run(conf_run, ex, resume_from=d)
    ran = {c for ev, c, *_ in ex.trace if ev == "dispatch"}
    assert not (ran & restored)             # restored blocks never re-run
    assert ran | restored == {t.coord for _, ts in
                              TENG.build_phase_graph(conf_run[0]) for t in ts}


def test_resume_continues_checkpointing(conf_run, tmp_path):
    """resume_from == checkpoint_dir: the continued run tops the directory
    up to a complete set, usable for yet another (full) resume."""
    ref = conf_run[3]
    d = tmp_path / "ckpt"
    _interrupt(conf_run, "serial", d)
    _run(conf_run, resume_from=d, checkpoint_dir=d)
    assert len(list(d.glob("block_*.npz"))) == 9
    res = _run(conf_run, "streaming", resume_from=d)
    assert res.resumed_blocks == 9
    assert res.rmse == ref.rmse


def test_ckpt_every_batches_writes(conf_run, tmp_path):
    every, one = tmp_path / "every", tmp_path / "one"
    _interrupt(conf_run, "serial", one)
    _interrupt(conf_run, "serial", every, ckpt_every=4)
    # batching persists no MORE than per-resolve flushing at the kill, and
    # the engine's final flush still lands the buffered remainder
    assert 0 < len(list(every.glob("block_*.npz"))) \
        <= len(list(one.glob("block_*.npz")))
    res = _run(conf_run, resume_from=every)
    assert res.rmse == conf_run[3].rmse


def test_resume_mismatch_rejected(conf_run, tmp_path):
    part, cfg, test, _ = conf_run
    d = tmp_path / "ckpt"
    _interrupt(conf_run, "serial", d)
    assert TCK.PPCheckpoint.read_meta(d)["seed"] == SEED
    with pytest.raises(ValueError, match="resume_from"):
        _run(conf_run, seed=99, resume_from=d)           # another seed
    with pytest.raises(ValueError, match="resume_from"):
        _run(conf_run, resume_from=d,
             cfg=cfg._replace(n_samples=7))              # another chain
    with pytest.raises(ValueError, match="resume_from"):
        TPP.run_pp(SEED, TPA.partition(_train(), 2, 2), cfg, test,
                   device="cpu", resume_from=d)          # another grid


def _train():
    coo, _ = TSYN.generate("mini", seed=13)
    return train_test_split(coo, 0.15, seed=14)[0]


# ---------------------------------------------------------------------------
# the aggregation under non-finite posteriors; divergence; validation
# ---------------------------------------------------------------------------


def test_aggregate_axis_propagates_nonfinite(conf_run):
    """``pp._aggregate_axis`` is a plain linear reduction: one NaN'd block
    posterior poisons the whole factor — why the guard sits before it."""
    part, cfg, _, _ = conf_run
    K = cfg.K

    def post(i, j):
        n = len(part.block(i, j).row_ids)
        return RowGaussians(torch.zeros((n, K)),
                            torch.eye(K).expand(n, K, K).contiguous())

    posts = [[post(i, j) for j in range(part.J)] for i in range(part.I)]
    assert bool(torch.isfinite(
        TPP._aggregate_axis(part, posts, axis="row").eta).all())
    posts[1][1].eta[0, 0] = float("nan")
    assert not bool(torch.isfinite(
        TPP._aggregate_axis(part, posts, axis="row").eta).all())


def test_rmse_divergence_threshold_trips(conf_run):
    """rmse_max treats a finite-but-diverged block as faulty."""
    pol = TENG.FaultPolicy(rmse_max=1e-6, on_fault="degrade", max_retries=0)
    res = _run(conf_run, "async", fault_policy=pol)
    assert res.faults and all(f.kind == "rmse" for f in res.faults)
    assert np.isfinite(res.rmse)


def test_validation_errors(conf_run, tmp_path):
    with pytest.raises(ValueError, match="window"):
        TENG.make_executor("streaming", window=0)
    with pytest.raises(ValueError, match="window"):
        TENG.StreamingExecutor(window=-3)
    with pytest.raises(ValueError, match="depth"):
        TENG.StreamingExecutor(depth=0)
    with pytest.raises(ValueError, match="max_retries"):
        _run(conf_run, max_retries=-1)
    with pytest.raises(ValueError, match="on_fault"):
        _run(conf_run, on_fault="panic")
    with pytest.raises(ValueError, match="ckpt_every"):
        _run(conf_run, ckpt_every=0)
    with pytest.raises(ValueError, match="max_retries"):
        TENG.FaultPolicy(max_retries=-2)
    with pytest.raises(ValueError, match="on_fault"):
        TENG.FaultPolicy(on_fault="ignore")
    with pytest.raises(ValueError, match="ckpt_every"):
        TCK.PPCheckpoint(tmp_path / "x", every=0)


def test_fault_plan_is_deterministic():
    plan = TENG.FaultPlan(nan_at={(1, 1): 2}, hang_at={(0, 2): 1},
                          group_dead_at={1: 3}, group_slow_at={0: (2, 0.5)})
    assert plan.nan((1, 1), 0) and plan.nan((1, 1), 1)
    assert not plan.nan((1, 1), 2)
    assert not plan.nan((2, 2), 0)
    assert plan.hang((0, 2), 0) and not plan.hang((0, 2), 1)
    assert not plan.fail((1, 1), 0)
    assert not plan.group_dead(1, 2) and plan.group_dead(1, 3)
    assert plan.group_slow_s(0, 1) == 0.0 and plan.group_slow_s(0, 2) == 0.5
    ctx = TENG.PhaseContext(part=None, cfg=None, test_p=None, seed=0,
                            shapes={}, device=torch.device("cpu"),
                            fault_plan=plan)
    assert [ctx.next_group_ordinal(1) for _ in range(4)] == [0, 1, 2, 3]
    assert ctx.group_suppressed_until(1, 3, 10.0) == float("inf")
    assert ctx.group_suppressed_until(0, 2, 10.0) == 10.5
    assert ctx.group_suppressed_until(0, 1, 10.0) == 0.0


# ---------------------------------------------------------------------------
# the group fault domain: quarantine, work stealing, speculation, graceful
# degradation (several groups on the CPU)
# ---------------------------------------------------------------------------


def _grouped(name, G=2, data=1, **kw):
    """A G-group executor whose slots are all the CPU."""
    topo = Topology(block=G, data=data, devices=("cpu",) * (G * data))
    if name == "streaming":
        kw.setdefault("window", 2)
        return TENG.StreamingExecutor(topology=topo, **kw)
    return TENG.AsyncExecutor(topology=topo, **kw)


@pytest.fixture(scope="module")
def one_group(conf_run):
    """Each overlapped executor's one-group run: the numbers every grouped
    run must reproduce bitwise."""
    return {name: _run(conf_run, _make(name)) for name in OVERLAPPED}


def _assert_group_trace_clean(ex, part):
    """The happens-before pass over the real trace: no dispatch to a
    quarantined group, twins collapse via cancel, steals hit staged work
    only, every block resolves exactly once."""
    from repro_torch.analysis import trace_passes as TTP
    deps = {t.coord: list(t.deps)
            for _, ts in TENG.build_phase_graph(part) for t in ts}
    vs = TTP._happens_before(TTP.TraceArtifact("groups", ex.trace, deps))
    assert not vs, [v.message for v in vs]


def _assert_same_numbers(res, ref):
    assert res.rmse == ref.rmse
    torch.testing.assert_close(res.U_agg.eta, ref.U_agg.eta, rtol=0, atol=0)
    torch.testing.assert_close(res.V_agg.Lambda, ref.V_agg.Lambda, rtol=0,
                               atol=0)


def test_group_fault_policy_validation():
    with pytest.raises(ValueError, match="on_group_fault"):
        TENG.FaultPolicy(on_group_fault="shrug")
    with pytest.raises(ValueError, match="quarantine_after"):
        TENG.FaultPolicy(quarantine_after=0)
    with pytest.raises(ValueError, match="min_groups"):
        TENG.FaultPolicy(min_groups=0)
    with pytest.raises(ValueError, match="speculate_at"):
        TENG.FaultPolicy(speculate_at=-1.0)
    with pytest.raises(ValueError, match="depth"):
        TENG.AsyncExecutor(depth=0)
    plan = TENG.FaultPlan(group_dead_at={1: 2},
                          group_slow_at={0: (1, 2.5)})
    assert not plan.group_dead(1, 1) and plan.group_dead(1, 2)
    assert not plan.group_dead(0, 0)
    assert plan.group_slow_s(0, 0) == 0.0
    assert plan.group_slow_s(0, 1) == 2.5
    assert plan.group_slow_s(1, 5) == 0.0
    err = TENG.TopologyDegradedError("x", dead_groups=[3, 1])
    assert err.dead_groups == (3, 1)


def test_topology_without_groups():
    """Survivor sub-topology construction (the resume path after
    ``TopologyDegradedError``)."""
    t = Topology(block=4, data=2, devices=("cpu",) * 8)
    s = t.without_groups((1, 3))
    assert (s.block, s.data) == (2, 2)
    assert s.devices == t.group(0) + t.group(2)
    assert t.without_groups(()) == t
    with pytest.raises(ValueError, match="unknown group"):
        t.without_groups((4,))
    with pytest.raises(ValueError, match="every device group"):
        t.without_groups((0, 1, 2, 3))


@pytest.mark.parametrize("name", OVERLAPPED)
def test_group_dead_quarantine_heals_bitwise(conf_run, one_group, name):
    """A group that dies mid-run expires ``quarantine_after`` consecutive
    times and is quarantined; its staged share and in-flight blocks
    rebalance onto the survivors with the same noise, so the healed run is
    bitwise the one-group run."""
    pol = TENG.FaultPolicy(timeout_floor_s=0.3, timeout_slack=0.0,
                           quarantine_after=2, max_retries=5)
    ex = _grouped(name, G=3, record_trace=True)
    res = _run(conf_run, ex, fault_plan=TENG.FaultPlan(group_dead_at={1: 0}),
               fault_policy=pol)
    assert res.group_stats["n_quarantined"] == 1
    assert ("group", "quarantined") in {(f.kind, f.action)
                                        for f in res.faults}
    assert ("quarantine", 1) in {(ev, g) for ev, _, g in ex.trace}
    _assert_same_numbers(res, one_group[name])
    _assert_group_trace_clean(ex, conf_run[0])


@pytest.mark.parametrize("name", OVERLAPPED)
def test_group_dead_min_groups_breach_raises(conf_run, one_group, name,
                                             tmp_path):
    """Quarantine below ``min_groups`` flushes a checkpoint and raises
    ``TopologyDegradedError`` naming the dead groups — and the flushed
    directory resumes on the survivor topology the error names."""
    pol = TENG.FaultPolicy(timeout_floor_s=0.3, timeout_slack=0.0,
                           quarantine_after=1, min_groups=2, max_retries=5)
    d = tmp_path / "ckpt"
    with pytest.raises(TENG.TopologyDegradedError, match="group") as e:
        _run(conf_run, _grouped(name),
             fault_plan=TENG.FaultPlan(group_dead_at={1: 0}),
             fault_policy=pol, checkpoint_dir=d)
    assert e.value.dead_groups == (1,)
    assert (d / "meta.json").exists()
    survivor = Topology(2, 1, devices=("cpu", "cpu")).without_groups(
        e.value.dead_groups)
    assert survivor.block == 1
    ex2 = (TENG.StreamingExecutor(window=2, topology=survivor)
           if name == "streaming" else TENG.AsyncExecutor(topology=survivor))
    res = _run(conf_run, ex2, resume_from=d)
    _assert_same_numbers(res, one_group[name])


@pytest.mark.parametrize("name", OVERLAPPED)
def test_group_dead_continue_on_survivors(conf_run, one_group, name):
    """``on_group_fault='continue'`` keeps the run alive below
    ``min_groups``: the survivors finish the graph bitwise."""
    pol = TENG.FaultPolicy(timeout_floor_s=0.3, timeout_slack=0.0,
                           quarantine_after=1, min_groups=2,
                           on_group_fault="continue", max_retries=5)
    res = _run(conf_run, _grouped(name),
               fault_plan=TENG.FaultPlan(group_dead_at={1: 0}),
               fault_policy=pol)
    assert res.group_stats["n_quarantined"] == 1
    _assert_same_numbers(res, one_group[name])


# how long the straggler of test_group_slow_speculative_winner_deterministic
# waits for its twin before it resolves anyway (then the test fails on
# n_speculations)
SPECULATE_WAIT_S = 30.0


@pytest.mark.parametrize("name", OVERLAPPED)
def test_group_slow_speculative_winner_deterministic(conf_run, one_group,
                                                     name):
    """A straggling group's dispatches are twinned on the idle group with
    the same attempt-0 noise; the canonical-group winner is committed and
    the loser never is, so two runs commit the same numbers, bitwise the
    one-group run, with one resolve per block. The straggler (group 1) is
    held until the first speculation is recorded (``FaultPlan.
    group_release``), with SPECULATE_WAIT_S as the timeout: a fixed delay
    raced the host's speed, and under load no twin was launched."""
    import collections
    import threading
    pol = TENG.FaultPolicy(timeout_floor_s=60.0, timeout_slack=0.0,
                           speculate_at=2.0)
    for _ in range(2):
        ex = _grouped(name, record_trace=True)
        twinned = threading.Event()
        record = ex._record

        def record_speculation(event, *args, record=record,
                               twinned=twinned):
            if event == "speculate":
                twinned.set()
            return record(event, *args)

        ex._record = record_speculation
        plan = TENG.FaultPlan(group_slow_at={1: (0, SPECULATE_WAIT_S)},
                              group_release=twinned)
        res = _run(conf_run, ex, fault_plan=plan, fault_policy=pol)
        assert res.group_stats["n_speculations"] >= 1, res.group_stats
        assert res.group_stats["n_cancels"] == \
            res.group_stats["n_speculations"]
        resolves = collections.Counter(c for ev, c, *_ in ex.trace
                                       if ev == "resolve")
        assert set(resolves.values()) == {1}
        _assert_same_numbers(res, one_group[name])
        _assert_group_trace_clean(ex, conf_run[0])


# how long the straggler of test_group_steal_resolves_exactly_once waits
# for a steal before it resolves anyway (then the test fails on n_steals)
STEAL_WAIT_S = 30.0


@pytest.mark.parametrize("name", OVERLAPPED)
def test_group_steal_resolves_exactly_once(conf_run, one_group, name):
    """With ``depth=1`` (and window=1 for streaming: single-block chunks,
    so the straggler's prefetch slot holds stealable work) the groups hold
    staged shares; an idle group steals from the most-loaded one. Every
    block still resolves exactly once and the numbers stay bitwise. The
    straggler (group 1) is held until the first steal is recorded
    (``FaultPlan.group_release``), with STEAL_WAIT_S as the timeout: a
    fixed delay raced the host's speed."""
    import collections
    import threading
    kw = {"window": 1} if name == "streaming" else {}
    clean = (_run(conf_run, TENG.StreamingExecutor(window=1)) if kw
             else one_group[name])
    pol = TENG.FaultPolicy(timeout_floor_s=60.0, timeout_slack=0.0)
    ex = _grouped(name, record_trace=True, depth=1, **kw)
    stolen = threading.Event()
    record = ex._record

    def record_steal(event, *args):
        if event == "steal":
            stolen.set()
        return record(event, *args)

    ex._record = record_steal
    res = _run(conf_run, ex,
               fault_plan=TENG.FaultPlan(
                   group_slow_at={1: (0, STEAL_WAIT_S)},
                   group_release=stolen),
               fault_policy=pol)
    assert res.group_stats["n_steals"] >= 1, res.group_stats
    resolves = collections.Counter(c for ev, c, *_ in ex.trace
                                   if ev == "resolve")
    graph = {t.coord for _, ts in TENG.build_phase_graph(conf_run[0])
             for t in ts}
    assert set(resolves) == graph
    assert set(resolves.values()) == {1}     # exactly once, stolen or not
    _assert_same_numbers(res, clean)
    _assert_group_trace_clean(ex, conf_run[0])


def test_resume_across_topology_switch(conf_run, one_group, tmp_path):
    """Checkpoint meta records the run's identity, not its placement: a
    run checkpointed under 4×1 groups resumes under 2×1 bitwise, and a
    complete 4×1 directory restores wholesale under 2×2 data-sharded
    groups."""
    d = tmp_path / "ckpt41"
    with pytest.raises(TENG.BlockFaultError):
        _run(conf_run, _grouped("async", G=4), checkpoint_dir=d,
             fault_plan=TENG.FaultPlan(fail_dispatch_at={(1, 2): 99}),
             max_retries=0, on_fault="raise")
    meta = TCK.PPCheckpoint.read_meta(d)
    assert not {"executor", "topology"} & set(meta)
    n_saved = len(list(d.glob("block_*.npz")))
    assert 0 < n_saved < 9                   # genuinely mid-graph
    res = _run(conf_run, _grouped("async", G=2), resume_from=d)
    assert res.resumed_blocks == n_saved
    _assert_same_numbers(res, one_group["async"])
    full = tmp_path / "full41"
    ref41 = _run(conf_run, _grouped("async", G=4), checkpoint_dir=full)
    res22 = _run(conf_run, _grouped("async", G=2, data=2, comm="psum"),
                 resume_from=full)
    assert res22.resumed_blocks == 9
    _assert_same_numbers(res22, ref41)       # nothing recomputed


# ---------------------------------------------------------------------------
# checkpoint format: the reference's
# ---------------------------------------------------------------------------


def test_ppcheckpoint_reads_the_references_directory(tmp_path):
    """A block store written by the reference's PPCheckpoint loads to the
    same arrays in the port, and one written by the port in the
    reference."""
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as JCK
    from repro.core.posterior import RowGaussians as JRG
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    U, V = (arr(5, 3), arr(5, 3, 3)), (arr(4, 3), arr(4, 3, 3))
    j = JCK.PPCheckpoint(tmp_path / "j")
    j.write_meta({"format": 1})
    j.note((1, 2), JRG(jnp.asarray(U[0]), jnp.asarray(U[1])),
           JRG(jnp.asarray(V[0]), jnp.asarray(V[1])), 1.25, 7)
    t = TCK.PPCheckpoint(tmp_path / "t")
    t.write_meta({"format": 1})
    t.note((1, 2), RowGaussians(torch.from_numpy(U[0]),
                                torch.from_numpy(U[1])),
           RowGaussians(torch.from_numpy(V[0]), torch.from_numpy(V[1])),
           1.25, 7)
    for got in (TCK.PPCheckpoint.load_blocks(tmp_path / "j"),
                JCK.PPCheckpoint.load_blocks(tmp_path / "t")):
        assert set(got) == {(1, 2)}
        d = got[(1, 2)]
        for k, want in zip(("U_eta", "U_Lambda", "V_eta", "V_Lambda"),
                           U + V):
            np.testing.assert_array_equal(d[k], want)
            assert d[k].dtype == np.float32
        assert float(d["sq"]) == 1.25 and int(d["n_obs"]) == 7
    assert TCK.PPCheckpoint.read_meta(tmp_path / "j") == {"format": 1}


def test_pytree_save_restore_roundtrip_and_reference_format(tmp_path):
    """Nested dicts and lists of tensors round-trip (bf16 through the f32
    npz storage, shape-checked); the reference's ``restore`` reads the
    port's file to the same values."""
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as JCK
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((3, 4), generator=g),
            "layers": [{"b": torch.randn((2,), generator=g)},
                       {"b": torch.randn((2,), generator=g).bfloat16()}]}
    TCK.save(tmp_path / "p", tree, step=7, extra={"note": "x"})
    m = TCK.manifest(tmp_path / "p")
    assert m["step"] == 7 and m["note"] == "x"
    assert m["keys"] == ["layers/0/b", "layers/1/b", "w"]
    assert m["dtypes"]["layers/1/b"] == "bfloat16"
    like = {"w": torch.zeros((3, 4)),
            "layers": [{"b": torch.zeros(2)},
                       {"b": torch.zeros(2, dtype=torch.bfloat16)}]}
    back = TCK.restore(tmp_path / "p", like)
    torch.testing.assert_close(back["w"], tree["w"], rtol=0, atol=0)
    assert back["layers"][1]["b"].dtype == torch.bfloat16
    torch.testing.assert_close(back["layers"][1]["b"], tree["layers"][1]["b"],
                               rtol=0, atol=0)
    jback = JCK.restore(tmp_path / "p", {
        "w": jnp.zeros((3, 4)), "layers": [{"b": jnp.zeros(2)},
                                           {"b": jnp.zeros(2)}]})
    np.testing.assert_array_equal(np.asarray(jback["w"]),
                                  tree["w"].numpy())
    with pytest.raises(ValueError, match="shape"):
        TCK.restore(tmp_path / "p", {"w": torch.zeros((4, 3)),
                                     "layers": like["layers"]})


# ---------------------------------------------------------------------------
# CLIs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", OVERLAPPED)
def test_bmf_train_cli_overlapped(executor, capsys):
    from repro_torch.launch import bmf_train
    res = bmf_train.main(["--dataset", "mini", "--blocks", "4", "--samples",
                          "4", "--fused-sweep", "--executor", executor,
                          "--device", "cpu"])
    assert np.isfinite(res.rmse) and res.executor == executor
    out = capsys.readouterr().out
    assert "RMSE=" in out and "critical path" in out


def test_bmf_train_cli_checkpoint_and_resume(tmp_path, capsys):
    """--ckpt-dir checkpoints every resolved block; --resume restores them
    all and reproduces the run bitwise; --ckpt saves the aggregates."""
    from repro_torch.launch import bmf_train
    d = tmp_path / "blocks"
    argv = ["--dataset", "mini", "--blocks", "4", "--samples", "4",
            "--executor", "streaming", "--window", "2", "--device", "cpu",
            "--ckpt-dir", str(d), "--ckpt-every", "2", "--on-fault",
            "degrade", "--max-retries", "1"]
    first = bmf_train.main(argv + ["--ckpt", str(tmp_path / "agg")])
    assert len(list(d.glob("block_*.npz"))) == 4
    again = bmf_train.main(argv + ["--resume"])
    assert again.resumed_blocks == 4 and again.rmse == first.rmse
    assert "resumed 4 block(s)" in capsys.readouterr().out
    m = TCK.manifest(tmp_path / "agg")
    assert m["rmse"] == first.rmse and np.prod(m["grid"]) == 4
    with pytest.raises(SystemExit):
        bmf_train.main(["--dataset", "mini", "--resume", "--device", "cpu"])


def test_train_cli_ckpt_saves_restorable_params(tmp_path):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as MODEL
    path = tmp_path / "params"
    train.main(["--arch", "qwen3_4b", "--smoke", "--steps", "2", "--batch",
                "1", "--seq", "16", "--device", "cpu", "--ckpt", str(path)])
    m = json.loads(path.with_suffix(".json").read_text())
    assert m["step"] == 2 and m["keys"]
    cfg = get_config("qwen3_4b").smoke_variant()
    like = dict(MODEL.init_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu", train=True).named_parameters())
    back = TCK.restore(path, like)
    assert set(back) == set(like) == set(m["keys"])
    # trained, so not the fresh weights of another seed, and finite
    assert all(bool(torch.isfinite(v).all()) for v in back.values())
    assert any(not torch.equal(back[k], like[k].detach()) for k in like)
