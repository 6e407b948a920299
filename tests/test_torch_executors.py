"""The port's overlapped executors (async, streaming) and their scheduler
against the reference, and the port's executor battery.

Against the reference (JAX, CPU): tape-replayed ``run_pp`` through the
port's async and streaming (W = 2) executors on mini 3×3, which covers
all four phase tags, against the reference's ``run_pp(executor="async")``
and ``run_pp(executor="streaming", window=2)``; the reference's key
schedule is replayed into a noise tape per block, as in
``test_torch_chain.py``. Limits as there: RMSE and per-block RMSE 1e-4
absolute, aggregates 1e-3 relative in the Frobenius norm. The
scheduler's priorities and pop orders must be equal, and the trace
passes must give the reference's verdicts (the reference's passes import
no JAX).

The battery (port only, every registered executor): RMSE within 1e-5 of
the serial executor (the same chains, batched differently), a bitwise
rerun, a dependency-safe trace, and under a faked completion order the
same dependency safety and bitwise the undelayed numbers.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.analysis import trace_passes as TTP
from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import gibbs as TG
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.core.topology import Topology
from repro_torch.data import sparse as TSP
from repro_torch.data import synthetic as TSYN
from repro_torch.noise import TapeNoise
from torch_helpers import (cuda_device, jax_chain_tape,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 8
NS, BURN = 24, 4          # 20 kept draws >= K + 4
OVERLAPPED = ("async", "streaming")
EXECUTOR_NAMES = sorted(TENG.EXECUTORS)


def _fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _make(name, **kw):
    """A fresh executor; streaming with a window smaller than the phase
    b/c buckets, so chunking is exercised; sharded on two groups of two
    CPU slots in 'psum' mode, so its batch split, padding and
    item-statistics reduction are exercised."""
    if name == "streaming":
        return TENG.StreamingExecutor(window=2, **kw)
    if name == "sharded":
        return TENG.ShardedExecutor(
            topology=Topology(2, 2, devices=("cpu",) * 4), comm="psum", **kw)
    return TENG.EXECUTORS[name](**kw)


def _mini(test_frac=0.15):
    coo, _ = TSYN.generate("mini", seed=0)
    return TSP.train_test_split(coo, test_frac, seed=1)


def _deps(part):
    return {t.coord: list(t.deps)
            for _, ts in TENG.build_phase_graph(part) for t in ts}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tape_case():
    """mini 3×3 in both packages and one reference tape per block, sized
    to its phase bucket (the streaming executor keeps per-phase shapes at
    its default max_waste = 1.0)."""
    import jax
    from repro.core import partition as JPA
    from repro.data import sparse as JSP
    from repro.data import synthetic as JSYN
    coo, _ = JSYN.generate("mini", seed=0)
    jtr, jte = JSP.train_test_split(coo, 0.15, seed=1)
    tr, te = _mini()
    jpart, part = JPA.partition(jtr, 3, 3), TPA.partition(tr, 3, 3)
    keys = jax.random.split(jax.random.key(5), 9).reshape(3, 3)
    shapes = TPP.BlockShapes.per_phase(
        part, TSP.apply_permutation(te, part.row_perm, part.col_perm))
    tapes = {(b.i, b.j): jax_chain_tape(keys[b.i, b.j],
                                        shapes[b.phase].n_rows,
                                        shapes[b.phase].n_cols, K, NS)
             for b in part.all_blocks()}
    return jpart, jte, part, te, tapes


@pytest.mark.parametrize("kw", [dict(use_kernel=True),
                                dict(sweep_fused=True)])
@pytest.mark.parametrize("executor", OVERLAPPED)
def test_run_pp_tape_replay_overlapped(tape_case, executor, kw):
    """The port's async / streaming run against the reference's run of
    the same executor, block by block."""
    import jax
    from repro.core import bmf as JB
    from repro.core import pp as JPP
    jpart, jte, part, te, tapes = tape_case
    jkw = dict(window=2) if executor == "streaming" else {}
    res_j = JPP.run_pp(jax.random.key(5), jpart,
                       JB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw),
                       jte, executor=executor, **jkw)
    res_t = TPP.run_pp(5, part, TB.BMFConfig(K=K, n_samples=NS, burnin=BURN,
                                             **kw),
                       te, executor=executor, device="cpu", **jkw,
                       noise=lambda blocks: TapeNoise(
                           [tapes[c] for c, _ in blocks], "cpu"))
    assert res_t.executor == res_j.executor == executor
    gap = dict(rmse=abs(res_t.rmse - res_j.rmse),
               block=float(np.abs(res_t.per_block_rmse
                                  - res_j.per_block_rmse).max()),
               agg=max(_fro(getattr(getattr(res_t, f), g),
                            getattr(getattr(res_j, f), g))
                       for f in ("U_agg", "V_agg") for g in ("eta", "Lambda")))
    print(f"[{executor} gap] {kw} {gap}")
    assert gap["rmse"] < 1e-4 and gap["block"] < 1e-4, gap
    assert gap["agg"] < 1e-3, gap
    assert res_t.n_test == res_j.n_test
    assert set(res_t.phase_times_s) == set(res_j.phase_times_s)
    assert set(res_t.block_spans_s) == set(res_j.block_spans_s)
    assert res_t.faults == [] == res_j.faults


def _graph_pair(tape_case):
    """The reference's and the port's task maps of mini 3×3, and stand-in
    contexts carrying only the partitions (all the cost model reads)."""
    from repro.core import engine as JENG
    jpart, _, part, _, _ = tape_case
    jt = {t.coord: t for _, ts in JENG.build_phase_graph(jpart) for t in ts}
    tt = {t.coord: t for _, ts in TENG.build_phase_graph(part) for t in ts}
    return (jt, types.SimpleNamespace(part=jpart),
            tt, types.SimpleNamespace(part=part))


def test_critical_path_priority_matches_reference(tape_case):
    from repro.core import engine as JENG
    jt, jctx, tt, tctx = _graph_pair(tape_case)
    est_j = JENG._block_cost_estimates(jctx, jt)
    est_t = TENG._block_cost_estimates(tctx, tt)
    assert est_t == est_j
    prio = TENG.critical_path_priority(tt, est_t)
    assert prio == JENG.critical_path_priority(jt, est_j)
    # phase a heads the longest chain; every dep outranks its dependents
    assert max(prio, key=prio.get) == (0, 0)
    assert all(prio[d] > prio[c] for c, t in tt.items() for d in t.deps)


@pytest.mark.parametrize("case", ["critical-path", "ties", "fifo"])
def test_ready_queue_pop_order_matches_reference(tape_case, case):
    """Seeded with the same priorities, the port's ready queue pops the
    graph's blocks in the reference's order, FIFO among ties."""
    from repro.core import engine as JENG
    jt, jctx, tt, tctx = _graph_pair(tape_case)
    prio = {"critical-path": JENG.critical_path_priority(
                jt, JENG._block_cost_estimates(jctx, jt)),
            "ties": {c: float(c[0] == 0) for c in jt},
            "fifo": None}[case]
    order = sorted(tt, key=lambda c: (c[1], -c[0]))   # not the heap order
    queues = (JENG._ReadyQueue(prio), TENG._ReadyQueue(prio))
    for q in queues:
        for c in order:
            q.push(c)
    pops = [[q.pop() for _ in range(len(q))] for q in queues]
    assert pops[1] == pops[0]
    assert len(pops[1]) == len(order) and not queues[1]


def test_grouped_ready_queue_chunks_match_reference(tape_case):
    from repro.core import engine as JENG
    jt, jctx, tt, tctx = _graph_pair(tape_case)
    prio = JENG.critical_path_priority(jt, JENG._block_cost_estimates(jctx,
                                                                       jt))
    chunks = []
    for Q, tasks in ((JENG._GroupedReadyQueue, jt),
                     (TENG._GroupedReadyQueue, tt)):
        q = Q(prio, lambda c, tasks=tasks: tasks[c].phase)
        for c in sorted(tasks):
            q.push(c)
        out = []
        while q:
            out.append(q.pop_chunk(2))
        chunks.append(out)
    assert chunks[1] == chunks[0]
    assert all(len({tt[c].phase for c in ch}) == 1 for ch in chunks[1])


def test_group_health_rate_estimator():
    """Per-group EWMA rates (alpha 0.4), each group's first resolve
    dropped, cold groups inheriting the fastest calibrated rate, and the
    consecutive-expiry counter — as in the reference."""
    h = TENG._GroupHealth(3, quarantine_after=2)
    assert h.rate(0) == 0.0
    h.observe(0, 5.0)                        # first resolve: warm-up
    assert h.rate(0) == 0.0
    h.observe(0, 1.0)
    assert h.rate(0) == 1.0
    h.observe(0, 2.0)
    assert abs(h.rate(0) - (0.6 * 1.0 + 0.4 * 2.0)) < 1e-12
    h.observe(1, 9.9)
    assert h.rate(1) == h.rate(0)
    h.observe(1, 3.0)
    assert h.rate(1) == 3.0
    assert h.rate(2) == h.global_rate == h.rate(0)
    assert not h.note_expiry(0)
    h.note_resolve(0)
    assert not h.note_expiry(0)
    assert h.note_expiry(0)
    h.quarantine(0)
    assert h.healthy() == [1, 2]
    assert not h.note_expiry(0)


# ---------------------------------------------------------------------------
# trace passes: the reference's verdicts
# ---------------------------------------------------------------------------


def _verdicts(trace, deps, window_bound=None, reported_peak=None):
    """(port messages, reference messages) of both passes."""
    from repro.analysis import registry as JREG
    from repro.analysis import trace_passes as JTP
    j = JREG.TraceArtifact(label="t", trace=trace, deps=deps,
                           window_bound=window_bound,
                           reported_peak=reported_peak)
    t = TTP.TraceArtifact(label="t", trace=trace, deps=deps,
                          window_bound=window_bound,
                          reported_peak=reported_peak)
    return ([v.message for v in TTP._happens_before(t)
             + TTP._window_occupancy(t)],
            [v.message for v in JTP._happens_before(j)
             + JTP._window_occupancy(j)])


def _clean(trace):
    return [tuple(e) for e in trace]


def _mutate(trace, kind):
    tr = list(trace)
    if kind == "dispatch-before-dep":
        # the first phase-c dispatch moved to the front
        i = next(i for i, e in enumerate(tr) if e[0] == "dispatch"
                 and e[1][0] > 0 and e[1][1] > 0)
        return [tr[i]] + tr[:i] + tr[i + 1:]
    if kind == "double-resolve":
        i = next(i for i, e in enumerate(tr) if e[0] == "resolve")
        return tr[:i + 1] + [tr[i]] + tr[i + 1:]
    if kind == "redispatch-without-expire":
        i = next(i for i, e in enumerate(tr) if e[0] == "resolve")
        return tr[:i] + [("redispatch",) + tuple(tr[i][1:])] + tr[i:]
    if kind == "expire-not-in-flight":
        return [("expire", (0, 0), 0)] + tr
    if kind == "never-resolved":
        last = max(i for i, e in enumerate(tr) if e[0] == "resolve")
        return tr[:last] + tr[last + 1:]
    raise AssertionError(kind)


@pytest.fixture(scope="module")
def traces():
    """One traced run per executor on mini 3×3 (port)."""
    tr, te = _mini()
    part = TPA.partition(tr, 3, 3)
    cfg = TB.BMFConfig(K=K, n_samples=3, burnin=1, sweep_fused=True)
    out = {}
    for name in EXECUTOR_NAMES:
        ex = _make(name, record_trace=True)
        TPP.run_pp(2, part, cfg, te, executor=ex, device="cpu")
        out[name] = (_clean(ex.trace), ex)
    return out, _deps(part)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_trace_passes_clean_on_port_traces(traces, name):
    (runs, deps) = traces
    trace, ex = runs[name]
    bound = (ex.window * (ex.depth + 1) if name == "streaming" else None)
    peak = ex.peak_window_blocks if name == "streaming" else None
    got, want = _verdicts(trace, deps, bound, peak)
    assert got == want == []


@pytest.mark.parametrize("kind", ["dispatch-before-dep", "double-resolve",
                                  "redispatch-without-expire",
                                  "expire-not-in-flight", "never-resolved"])
@pytest.mark.parametrize("name", ["stacked", "async"])
def test_trace_passes_match_reference_on_mutations(traces, name, kind):
    (runs, deps) = traces
    got, want = _verdicts(_mutate(runs[name][0], kind), deps)
    assert got == want and got, (got, want)


def test_window_occupancy_overflow_matches_reference(traces):
    (runs, deps) = traces
    trace, ex = runs["streaming"]
    got, want = _verdicts(trace, deps, window_bound=1,
                          reported_peak=ex.peak_window_blocks)
    assert got == want and len(got) == 2


# ---------------------------------------------------------------------------
# the port's executor battery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conf_run():
    coo, p = TSYN.generate("mini", seed=13)
    train, test = TSP.train_test_split(coo, 0.15, seed=14)
    cfg = TB.BMFConfig(K=p.K, n_samples=5, burnin=1)
    part = TPA.partition(train, 3, 3)          # covers all four phase tags
    ref = TPP.run_pp(5, part, cfg, test, executor="serial", device="cpu")
    return part, cfg, test, ref


@pytest.fixture(scope="module")
def results(conf_run):
    """One traced run per executor, shared across the battery."""
    part, cfg, test, _ = conf_run
    cache = {}

    def get(name):
        if name not in cache:
            ex = _make(name, record_trace=True)
            cache[name] = (ex, TPP.run_pp(5, part, cfg, test, executor=ex,
                                          device="cpu"))
        return cache[name]

    return get


def test_registry_names_resolve():
    assert set(EXECUTOR_NAMES) == {"serial", "stacked", "sharded", "async",
                                   "streaming"}
    for name in EXECUTOR_NAMES:
        assert TENG.make_executor(name).name == name
    assert TENG.make_executor("streaming", window=3).window == 3
    assert TENG.make_executor("async", window=3).name == "async"
    with pytest.raises(ValueError, match="unknown executor"):
        TENG.make_executor("warp")
    # the placements resolve: a topology, the legacy distributed_mesh
    # (Topology(1, S), forcing serial) and block_mesh (one slot a group)
    assert TENG.make_executor("async", topology=(2, 1)).topology.block == 2
    ser = TENG.make_executor("stacked", distributed_mesh=("cpu", "cpu"))
    assert ser.name == "serial" and ser.distributed_mesh.data == 2
    assert TENG.make_executor("sharded", block_mesh=("cpu",) * 3
                              ).topology.block == 3
    with pytest.raises(ValueError, match="stacked"):
        TENG.make_executor("stacked", block_mesh=("cpu",))


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_rmse_parity_with_serial(conf_run, results, name):
    part, cfg, test, ref = conf_run
    _, res = results(name)
    assert res.executor == name
    assert abs(res.rmse - ref.rmse) < 1e-5, (name, res.rmse, ref.rmse)
    np.testing.assert_allclose(res.per_block_rmse, ref.per_block_rmse,
                               atol=1e-4)
    assert res.n_test == ref.n_test > 0
    assert set(res.phase_times_s) == set(ref.phase_times_s)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_bitwise_rerun(conf_run, results, name):
    part, cfg, test, _ = conf_run
    _, res1 = results(name)
    res2 = TPP.run_pp(5, part, cfg, test, executor=_make(name),
                      device="cpu")
    assert res1.rmse == res2.rmse
    torch.testing.assert_close(res1.U_agg.eta, res2.U_agg.eta, rtol=0,
                               atol=0)
    torch.testing.assert_close(res1.V_agg.Lambda, res2.V_agg.Lambda, rtol=0,
                               atol=0)


def _assert_trace_dep_safe(trace, part):
    graph = {t.coord: t for _, ts in TENG.build_phase_graph(part) for t in ts}
    dispatched, resolved = set(), set()
    for ev, c, *_ in trace:
        if ev == "dispatch":
            assert set(graph[c].deps) <= resolved, \
                f"{c} dispatched before deps {graph[c].deps} resolved"
            assert c not in dispatched, f"{c} dispatched twice"
            dispatched.add(c)
        else:
            assert ev == "resolve" and c in dispatched
            resolved.add(c)
    assert resolved == set(graph)          # every block ran exactly once
    assert len(trace) == 2 * len(graph)
    assert TTP._happens_before(TTP.TraceArtifact(
        label="t", trace=trace, deps=_deps(part))) == []


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_no_dispatch_before_deps_resolve(conf_run, results, name):
    part = conf_run[0]
    ex, _ = results(name)
    _assert_trace_dep_safe(ex.trace, part)
    group = [len(e) for e in ex.trace]
    assert set(group) == ({3} if name in OVERLAPPED else {2})


def _fake_delay(ex, seed):
    """Scramble the completion order the scheduler OBSERVES: each poll
    flips a seeded coin per in-flight unit."""
    rng = np.random.default_rng(seed)
    orig = ex._is_resolved

    def shuffled(coord, signal):
        return bool(rng.random() < 0.4) and orig(coord, signal)

    ex._is_resolved = shuffled
    return ex


@pytest.mark.parametrize("name", OVERLAPPED)
@pytest.mark.parametrize("seed", range(2))
def test_fake_delay_completion_order(conf_run, results, name, seed):
    """Randomized observed-completion order: dispatch stays dependency-
    safe and the run stays bitwise the undelayed one."""
    part, cfg, test, _ = conf_run
    _, res_ref = results(name)
    ex = _fake_delay(_make(name, record_trace=True), seed)
    res = TPP.run_pp(5, part, cfg, test, executor=ex, device="cpu")
    _assert_trace_dep_safe(ex.trace, part)
    assert res.rmse == res_ref.rmse
    torch.testing.assert_close(res.U_agg.eta, res_ref.U_agg.eta, rtol=0,
                               atol=0)
    torch.testing.assert_close(res.V_agg.eta, res_ref.V_agg.eta, rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", OVERLAPPED)
def test_overlapped_spans_and_timings(conf_run, results, name):
    """Per-block dispatch→resolve spans inside the run; pad and chain
    seconds reported; phase envelopes may overlap."""
    ex, res = results(name)
    assert set(res.block_spans_s) == {t.coord for _, ts in
                                      TENG.build_phase_graph(conf_run[0])
                                      for t in ts}
    assert all(0 <= a <= b <= res.wall_time_s
               for a, b in res.block_spans_s.values())
    assert ex.timings["pad_s"] > 0 and ex.timings["chain_s"] > 0
    assert res.critical_path_s() > 0


@pytest.mark.parametrize("priority", [True, False])
def test_async_watchdog_off_and_fifo(conf_run, results, priority):
    """The block-on-oldest path (watchdog=False) and FIFO dispatch give
    the same numbers as the default run."""
    part, cfg, test, _ = conf_run
    _, res_ref = results("async")
    ex = TENG.AsyncExecutor(priority=priority)
    res = TPP.run_pp(5, part, cfg, test, executor=ex, device="cpu",
                     fault_policy=TENG.FaultPolicy(watchdog=False))
    assert res.rmse == res_ref.rmse


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def test_streaming_window_is_bounded_and_reusable():
    """A 4×4 grid (16 blocks) through W = 2, depth 1: the live window
    stays within W·(depth+1) = 4 < I·J, the trace passes agree, and one
    instance serves two runs bitwise."""
    tr, te = _mini()
    part = TPA.partition(tr, 4, 4)
    cfg = TB.BMFConfig(K=K, n_samples=3, burnin=1, sweep_fused=True)
    ex = TENG.StreamingExecutor(window=2, depth=1, record_trace=True)
    res = TPP.run_pp(3, part, cfg, te, executor=ex, device="cpu")
    bound = ex.window * (ex.depth + 1)
    assert 0 < ex.peak_window_blocks <= bound < part.I * part.J
    assert ex.window_bytes > 0 and set(ex.window_shapes) == {
        "a", "b_row", "b_col", "c"}
    assert TTP._window_occupancy(TTP.TraceArtifact(
        label="s", trace=ex.trace, deps=_deps(part), window_bound=bound,
        reported_peak=ex.peak_window_blocks)) == []
    first = list(ex.trace)
    res2 = TPP.run_pp(3, part, cfg, te, executor=ex, device="cpu")
    assert ex.trace == first
    assert res2.rmse == res.rmse
    torch.testing.assert_close(res2.U_agg.Lambda, res.U_agg.Lambda, rtol=0,
                               atol=0)


def test_streaming_coalesced_shapes_still_sample():
    """max_waste > 1 merges phase buckets into fewer window shapes: the
    chains differ from serial's (other padding), but still fit."""
    tr, te = _mini()
    part = TPA.partition(tr, 3, 3)
    cfg = TB.BMFConfig(K=K, n_samples=20, burnin=5, sweep_fused=True)
    ex = TENG.StreamingExecutor(window=3, max_waste=4.0)
    res = TPP.run_pp(1, part, cfg, te, executor=ex, device="cpu")
    assert len({id(s) for s in ex.window_shapes.values()}) < 4
    mean = float(np.sqrt(np.mean((te.val - tr.val.mean()) ** 2)))
    assert np.isfinite(res.rmse) and res.rmse < mean
    assert bool(torch.isfinite(res.U_agg.Lambda).all())


def test_streaming_and_window_validation():
    with pytest.raises(ValueError, match="window"):
        TENG.StreamingExecutor(window=0)
    with pytest.raises(ValueError, match="depth"):
        TENG.StreamingExecutor(depth=0)
    with pytest.raises(ValueError, match="window"):
        TENG.make_executor("streaming", window=0)
    with pytest.raises(ValueError, match="ambiguous"):
        TENG.make_executor(TENG.StreamingExecutor(), window=2)
    with pytest.raises(NotImplementedError, match="whole graphs"):
        TENG.AsyncExecutor().run_phase(None, "a", [])


# ---------------------------------------------------------------------------
# column ids are checked on the host, where the planes are built
# ---------------------------------------------------------------------------


def test_out_of_range_column_ids_raise_on_the_host():
    tr, te = _mini()
    rows = TSP.coo_to_padded_csr(tr, as_numpy=True)
    cols = TSP.coo_to_padded_csr(tr.transpose(), as_numpy=True)
    cfg = TB.BMFConfig(K=K, n_samples=2, burnin=1)
    bad = TSP.PaddedCSR(rows.idx.copy(), rows.val, rows.mask, rows.n_cols)
    bad.idx[0, 0] = cols.n_rows                 # one past the last item
    with pytest.raises(ValueError, match="column ids"):
        TG.run_gibbs(0, bad, cols, te.row, te.col, cfg, device="cpu")
    with pytest.raises(ValueError, match="column ids"):
        TG.run_gibbs(0, TSP.PaddedCSR(torch.from_numpy(bad.idx),
                                      torch.from_numpy(bad.val),
                                      torch.from_numpy(bad.mask),
                                      bad.n_cols),
                     cols, te.row, te.col, cfg, device="cpu")
    with pytest.raises(ValueError, match="column ids"):
        TSP.coo_to_padded_csr(tr, n_cols_pad=int(tr.col.max()),
                              as_numpy=True)
    part = TPA.partition(tr, 2, 2)
    blk = part.block(1, 1)
    s = TPP.BlockShapes.of(part, None)
    narrow = TPP.BlockShapes(s.n_rows, int(blk.coo.col.max()), s.m_rows,
                             s.m_cols, s.n_test)
    with pytest.raises(ValueError, match="column ids"):
        TPP.pad_block_inputs(blk, narrow, K, None, None, None, device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(use_kernel=True),
                                dict(sweep_fused=True)])
def test_cuda_overlapped_match_stacked(cuda_device, kw):
    """async and streaming on the card against stacked on the card, within
    the port's 1e-4 card limit on a PP RMSE."""
    tr, te = _mini()
    part = TPA.partition(tr, 3, 3)
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw)
    ref = TPP.run_pp(5, part, cfg, te, executor="stacked",
                     device=cuda_device)
    for name in OVERLAPPED:
        res = TPP.run_pp(5, part, cfg, te, executor=name,
                         window=2 if name == "streaming" else None,
                         device=cuda_device)
        assert abs(res.rmse - ref.rmse) < 1e-4, (name, res.rmse, ref.rmse)
        np.testing.assert_allclose(res.per_block_rmse, ref.per_block_rmse,
                                   atol=1e-4)
        assert not res.faults


@pytest.mark.cuda
def test_cuda_async_dispatch_and_aggregate_never_sync(cuda_device):
    """One async block dispatch (phase c, both priors) and one
    ``_aggregate_axis`` under ``set_sync_debug_mode("error")``."""
    from repro_torch.data.sparse import apply_permutation
    tr, te = _mini()
    part = TPA.partition(tr, 2, 2)
    cfg = TB.BMFConfig(K=K, n_samples=4, burnin=1, sweep_fused=True)
    test_p = apply_permutation(te, part.row_perm, part.col_perm)
    ctx = TENG.PhaseContext(part=part, cfg=cfg, test_p=test_p, seed=0,
                            shapes=TPP.BlockShapes.per_phase(part, test_p),
                            device=cuda_device)
    tasks = {t.coord: t for _, ts in TENG.build_phase_graph(part) for t in ts}
    ex = TENG.AsyncExecutor()
    ex._reset_run_state()
    for c in ((0, 0), (1, 0), (0, 1)):
        ex._dispatch(ctx, tasks[c])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sig, host, out = ex._dispatch(ctx, tasks[(1, 1)])
        agg = TPP._aggregate_axis(part, [[out.U_post] * 2] * 2, axis="row")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sig.synchronize()
    assert bool(host[0, 1]) and bool(torch.isfinite(agg.eta).all())
