"""bmf_lint — run the static invariant analyzer over the executor registry
(port of ``repro.launch.bmf_lint``).

For every executor in ``engine.EXECUTORS`` x a topology matrix (1x1 plus
the composed --topo pair), this lints:

  * the chains the executor dispatches, run once at LINT_DIMS on seeded
    random planes through the ``gibbs.trace_chain`` /
    ``distributed.trace_chain_2d`` hooks: materialization budget, dtype
    promotion, host reads (op passes); collective confinement to the
    topology's groups and the per-comm-mode budgets (comm pass);
  * a real mini PP run's dispatch/resolve trace (``record_trace=True``):
    happens-before protocol and streaming window occupancy, and for the
    streaming executor its window's plane reuse (donation
    effectiveness);
  * the phase graph itself (cycles/unreachable/dangling deps) and the
    partition+coalesce shape plan (recompilation budget).

It also lints the SERVING path (once per run): ``score_topk`` for both
modes through ``trace_scoring`` at SERVE_DIMS against ``scoring_budget``,
plus the ``MicroBatchRouter`` bucket plan; and the one-kernel SWEEP path:
the factor step (``bmf_sweep.ops.trace_sweep``) and the ``sweep_fused``
chain, fp32 and bf16, against the block budget — the dtype pass proves
bf16 never reaches a Cholesky/solve/sqrt operand, nor B2's prior and
noise.

Topologies are single-controller slots: CPU groups with ``--device cpu``,
streams on one card with ``--device cuda`` (the default), where B1 and B2
run for real and appear in the op traces as ops of their own.

Emits a machine-readable JSON report (one violation object per breach,
with fix-hint text) and exits non-zero on any violation.

  python -m repro_torch.launch.bmf_lint --all-executors [--topo 2 2]
                                        [--json-out PATH] [--device cpu]

Before the report it runs each pass on a negative case and its clean twin
on the device (``negative_cases``): a case that does not fire, or a twin
that does, fails the lint as a violation does.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch

from repro_torch import analysis as LINT
from repro_torch import resolve_device
from repro_torch.analysis.op_passes import materialization_budget
from repro_torch.core import bmf as BMF
from repro_torch.core import distributed as DIST
from repro_torch.core import engine as ENG
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import pp as PP
from repro_torch.core.partition import partition
from repro_torch.core.topology import Topology
from repro_torch.data import synthetic as SYN
from repro_torch.data.sparse import apply_permutation, train_test_split

OUT = Path(__file__).resolve().parents[3] / "build" / "bmf_lint_report.json"

# block dims of the linted chains: small enough to run in milliseconds,
# large enough that a materialized gather tensor (n*m*K) clears the
# block-dim budget by >2x
LINT_DIMS = dict(n_rows=64, n_cols=48, m_rows=16, m_cols=24, n_test=64)

# serving-path lint dims: a dense (n_users, n_items) f32 score matrix
# (1 MiB here) clears scoring_budget (512 KiB) while every legitimate
# buffer — store precisions, resident sample slots, per-batch gathered
# slots — fits
SERVE_DIMS = dict(n_users=1024, n_items=256, K=8, batch=32, n_seen=16,
                  n_fold=4, n_slots=8, k=10)


def topology_groups(topo: Topology):
    """The topology's groups as ``(index, device names)`` pairs."""
    return [(g, tuple(str(d) for d in topo.group(g)))
            for g in range(topo.block)]


def _chain_artifacts(label, tchain, *, comm, groups, budget):
    """Both artifact views of one chain run: its ops and its
    collectives."""
    return [
        LINT.OpArtifact(label=f"{label}/ops", ops=tchain.ops,
                        bytes_budget=budget),
        LINT.CommArtifact(label=f"{label}/comm", calls=tchain.collectives,
                          sweeps=tchain.sweeps, comm=comm,
                          allowed_groups=groups),
    ]


def static_artifacts(name, topo, cfg, device):
    """The chains executor ``name`` dispatches on ``topo``, run through the
    core analyzer hooks."""
    d = LINT_DIMS
    n, c, mr, mc, nt = (d["n_rows"], d["n_cols"], d["m_rows"], d["m_cols"],
                        d["n_test"])
    one = Topology(1, 1, devices=(device,))
    arts = []

    def single(lbl, **kw):
        tc = GIBBS.trace_chain(cfg, n, c, mr, mc, nt, device=device, **kw)
        return _chain_artifacts(lbl, tc, comm=None,
                                groups=topology_groups(one),
                                budget=materialization_budget(n, c, mr, mc,
                                                              cfg.K))

    def stacked(lbl, batch, **kw):
        tc = GIBBS.trace_chain(cfg, n, c, mr, mc, nt, batch=batch,
                               device=device, **kw)
        return _chain_artifacts(
            lbl, tc, comm=None, groups=topology_groups(one),
            budget=materialization_budget(n, c, mr, mc, cfg.K, batch=batch))

    def composed(lbl, topology, batch, comm, **kw):
        S = topology.data
        n_pad = -(-n // S) * S
        c_pad = -(-c // S) * S
        tc = DIST.trace_chain_2d(cfg, topology, n, c, mr, mc, nt,
                                 batch=batch, comm=comm, **kw)
        return _chain_artifacts(
            lbl, tc, comm=comm, groups=topology_groups(topology),
            budget=materialization_budget(n_pad, c_pad * S, mr, mc, cfg.K,
                                          batch=batch))

    if name == "serial":
        arts += single("serial/block_c")
        arts += single("serial/block_a", u_prior=False, v_prior=False)
    elif name == "stacked":
        arts += stacked("stacked/bucket_c", batch=4)
    elif name == "sharded":
        if topo.data == 1:
            arts += stacked(f"sharded/bucket_c@{topo.block}x1",
                            batch=max(topo.block, 1))
        else:
            for comm in DIST.COMM_MODES:
                arts += composed(
                    f"sharded/composed[{comm}]@{topo.block}x{topo.data}",
                    topo, batch=topo.block, comm=comm)
    elif name == "async":
        arts += single("async/block_c")
        if topo.data > 1:
            gt = Topology(1, topo.data, devices=topo.group(0))
            arts += composed(f"async/group_chain@1x{topo.data}", gt,
                             batch=1, comm="gather")
    elif name == "streaming":
        arts += stacked("streaming/window_chunk", batch=2, prior_use=True)
    return arts


def behavioral_artifacts(name, topo, part, cfg, test, seed, device):
    """One real mini PP run with ``record_trace=True``: the executor's
    trace + the phase graph + the shape plan (+ the streaming window's
    plane reuse)."""
    kw = {}
    if topo.n_devices > 1 and name in ("sharded", "async", "streaming"):
        kw["topology"] = topo
    if name == "streaming":
        kw["window"] = 2
    if name == "sharded" and topo.n_devices == 1:
        kw["topology"] = topo
    ex = ENG.make_executor(name, **kw)
    ex.record_trace = True
    PP.run_pp(seed, part, cfg, test, executor=ex, device=device)

    graph = ENG.build_phase_graph(part)
    deps = {t.coord: list(t.deps) for _, ts in graph for t in ts}
    bound = peak = None
    label = f"{name}@{topo.block}x{topo.data}"
    arts = []
    if name == "streaming":
        G = max(1, ex.topology.block if ex.topology is not None else 1)
        bound = G * ex.window * (ex.depth + 1)
        peak = ex.peak_window_blocks
        arts.append(LINT.ReuseArtifact(label=f"{label}/window",
                                       handed=list(ex.window_planes),
                                       slots=dict(ex.window_slots)))
    return arts + [
        LINT.TraceArtifact(label=f"{label}/trace", trace=list(ex.trace),
                           deps=deps, window_bound=bound,
                           reported_peak=peak),
        LINT.GraphArtifact(label=f"{label}/phase-graph", deps=deps),
        LINT.PlanArtifact(label=f"{label}/plan",
                          signatures=plan_signatures(name, part, test, cfg)),
    ]


def plan_signatures(name, part, test, cfg):
    """Distinct chain shapes the partition implies for this executor: per
    phase-tag buckets (serial/stacked/sharded/async run one chain shape
    per tag), or the coalesced window buckets (streaming's prior-use
    flags make its chain tag-agnostic)."""
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    shapes = PP.BlockShapes.per_phase(part, test_p)
    if name == "streaming":
        merged = PP.BlockShapes.coalesce(shapes, cfg.K, max_waste=1.0)
        return sorted({s.astuple() for s in merged.values()})
    return sorted((tag, s.astuple()) for tag, s in shapes.items())


def serving_artifacts(device):
    """The serving path's lintable surface: one scoring op trace per mode
    at SERVE_DIMS (materialization budget = ``scoring_budget``, plus the
    dtype-promotion and host-callback passes) and the router's coalesced
    shape plan."""
    from repro_torch.serving import router as ROUTE
    from repro_torch.serving import scoring as SCORE
    from repro_torch.serving.store import abstract_store
    d = SERVE_DIMS
    budget = SCORE.scoring_budget(d["n_users"], d["n_items"], d["K"],
                                  d["batch"], d["n_slots"])
    arts = []
    for mode in SCORE.MODES:
        ts = SCORE.trace_scoring(d["n_users"], d["n_items"], d["K"],
                                 d["batch"], d["n_seen"], d["n_fold"],
                                 d["n_slots"], k=d["k"], mode=mode,
                                 device=device)
        arts.append(LINT.OpArtifact(
            label=f"serving/score_topk[{mode}]/ops", ops=ts.ops,
            bytes_budget=budget))
    store = abstract_store(d["n_users"], d["n_items"], d["K"], d["n_slots"])
    router = ROUTE.MicroBatchRouter(store, k=d["k"], max_batch=d["batch"])
    arts.append(LINT.PlanArtifact(label="serving/router/plan",
                                  signatures=router.plan_signatures))
    return arts


def sweep_artifacts(cfg, device):
    """The kernels' lintable surface: the one-kernel Gibbs sweep in both
    precision modes — the factor step through
    ``bmf_sweep.ops.trace_sweep`` and the whole chain with ``sweep_fused``
    through ``gibbs.trace_chain`` — and the chain with ``use_kernel``
    (B1's sufficient statistics), against the same block budget the
    chains get. On the card the dtype pass checks B2's launch by operand:
    only the gathered factor may be bf16."""
    from repro_torch.kernels.bmf_sweep import ops as SWEEP
    d = LINT_DIMS
    n, c, mr, mc, nt = (d["n_rows"], d["n_cols"], d["m_rows"], d["m_cols"],
                        d["n_test"])
    b1 = materialization_budget(n, c, mr, mc, cfg.K)
    one = topology_groups(Topology(1, 1, devices=(device,)))
    arts = []
    for dt in SWEEP.SWEEP_DTYPES:
        ts = SWEEP.trace_sweep(cfg.K, n, mr, c, dtype=dt, device=device)
        arts.append(LINT.OpArtifact(label=f"sweep/factor_step[{dt}]/ops",
                                    ops=ts.ops, bytes_budget=b1))
        cfg_f = cfg._replace(sweep_fused=True, sweep_dtype=dt)
        tc = GIBBS.trace_chain(cfg_f, n, c, mr, mc, nt, device=device)
        arts += _chain_artifacts(f"sweep/chain[{dt}]", tc, comm=None,
                                 groups=one, budget=b1)
    tc = GIBBS.trace_chain(cfg._replace(use_kernel=True), n, c, mr, mc, nt,
                           device=device)
    return arts + _chain_artifacts("sweep/chain[use_kernel]", tc, comm=None,
                                   groups=one, budget=b1)


def kernel_ops(arts):
    """Launches per hand-written kernel over the artifacts' op traces."""
    n = Counter()
    for a in arts:
        if a.kind == "ops":
            n.update(LINT.optrace.kernel_counts(a.ops))
    return dict(n)


def _run_record(executor, topo, arts):
    violations = [v for a in arts for v in LINT.analyze(a)]
    return {
        "executor": executor,
        "topology": list(topo),
        "artifacts": [a.label for a in arts],
        "kernel_ops": kernel_ops(arts),
        "violations": [v.as_dict() for v in violations],
    }, violations


def lint_executor(name, topo, part, cfg, test, seed, device):
    arts = static_artifacts(name, topo, cfg, device)
    arts += behavioral_artifacts(name, topo, part, cfg, test, seed, device)
    return _run_record(name, (topo.block, topo.data), arts)


def lint_serving(device):
    return _run_record("serving", (1, 1), serving_artifacts(device))


def lint_sweep(cfg, device):
    return _run_record("sweep", (1, 1), sweep_artifacts(cfg, device))


# -- negative cases -----------------------------------------------------------


def _chain_with(step, device):
    """A one-block chain at LINT_DIMS whose U-step runs ``step(V)`` first,
    recorded as an op artifact."""
    d = LINT_DIMS
    dims = (d["n_rows"], d["n_cols"], d["m_rows"], d["m_cols"])
    cfg = BMF.BMFConfig(K=8, n_samples=2, burnin=1)
    inp = GIBBS.lint_inputs(0, 1, *dims, d["n_test"], cfg.K, device)
    base = GIBBS.default_sampler(cfg, None)

    def u_sampler(z, csr, other, prior, sweep):
        step(other)
        return base(z, csr, other, prior, sweep)

    noise = GIBBS.as_noise([0], 1, device)
    U0, V0 = BMF.init_factors(noise, dims[0], dims[1], cfg.K)
    with LINT.optrace.record() as tr:
        GIBBS._run_gibbs_impl(noise, inp.rows, inp.cols, inp.test_rows,
                              inp.test_cols, cfg, 2, 1, None, None, U0, V0,
                              u_sampler=u_sampler)
    return LINT.OpArtifact("chain", tr.ops)


class _FreshPlanes(ENG._Window):
    """A window that builds each chunk's planes in buffers of their own,
    allocated when the chunk takes its slot and freed when the slot is
    taken again: the 'fresh planes per chunk' regression, whose addresses
    the allocator may hand out again."""

    def __init__(self, *args, **kw):
        self.fresh = {}
        super().__init__(*args, **kw)

    def acquire(self):
        slot = super().acquire()
        self.fresh[id(slot)] = None
        return slot

    def planes(self, slot, s, W):
        pl = self.fresh[id(slot)]
        if pl is None:
            pl = self.fresh[id(slot)] = {
                k: torch.empty_like(v)
                for k, v in super().planes(slot, s, W).items()}
        return pl


def _window_reuse(device, fresh: bool):
    """A streaming run's plane hand-outs on mini 2x2; ``fresh`` plants
    ``_FreshPlanes`` in this executor."""
    coo, p = SYN.generate("mini", seed=13)
    train, test = train_test_split(coo, 0.15, seed=14)
    ex = ENG.StreamingExecutor(window=1, depth=1, record_trace=True)
    if fresh:
        ex.window_cls = _FreshPlanes
    PP.run_pp(5, partition(train, 2, 2),
              BMF.BMFConfig(K=p.K, n_samples=2, burnin=1), test,
              executor=ex, device=device)
    return LINT.ReuseArtifact("window", ex.window_planes, ex.window_slots)


def negative_cases(device) -> dict:
    """Each pass on a negative case built on ``device``, beside its clean
    twin: ``{case: (pass name, case artifact, twin artifact)}``. The
    analyzer sees on this device only if every case fires and every twin
    is quiet (``self_check``)."""
    from repro_torch.analysis import optrace as OPT
    from repro_torch.core.topology import Group, record_collectives
    device = resolve_device(device)
    d = LINT_DIMS
    dims = (d["n_rows"], d["n_cols"], d["m_rows"], d["m_cols"])
    K = 8
    out = {}

    def case(name, bad, good):
        out[name] = (name.split(":")[0], bad, good)

    def ops(fn, label, refused=False, **kw):
        """``fn``'s op trace; ``refused``: the backend may refuse the op,
        which is then recorded as far as it ran."""
        with OPT.record() as tr:
            try:
                fn()
            except RuntimeError:
                if not refused:
                    raise
        return LINT.OpArtifact(label, tr.ops, **kw)

    rows = GIBBS.lint_inputs(0, 1, *dims, 1, K, device).rows
    V = torch.randn(1, d["n_cols"], K, device=device)
    budget = materialization_budget(*dims, K)
    case("materialization: dense (N, D, K) factor tensor",
         ops(lambda: torch.einsum("bnd,bdk->bndk", rows.mask.new_ones(
             1, d["n_rows"], d["n_cols"]), V), "dense", bytes_budget=budget),
         ops(lambda: BMF.sufficient_stats(rows, V, 2.0), "gather",
             bytes_budget=budget))
    x = torch.randn(4, K, K, device=device)
    A = x @ x.mT + K * torch.eye(K, device=device)
    case("dtype-promotion: float64 intermediate",
         ops(lambda: (A.double() * 2).float(), "f64"),
         ops(lambda: A * 2, "f32"))
    case("dtype-promotion: bf16 operand to cholesky_ex",
         ops(lambda: torch.linalg.cholesky_ex(A.bfloat16()), "bf16",
             refused=True),
         ops(lambda: torch.linalg.cholesky_ex(A), "f32"))
    b2 = dict(prior_eta=V[0], z=V[0], other=V[0], prior_lam=A)
    case("dtype-promotion: bf16 prior into B2",
         ops(lambda: OPT.note_kernel("repro_torch::bmf_sweep", {
             **b2, "prior_lam": A.bfloat16()}, {}), "b2"),
         ops(lambda: OPT.note_kernel("repro_torch::bmf_sweep", {
             **b2, "other": V[0].bfloat16()}, {}), "b2"))
    quiet = _chain_with(lambda v: v.sum(), device)
    case("host-callback: .item() in a chain",
         _chain_with(lambda v: v.sum().item(), device), quiet)
    case("host-callback: boolean-mask index in a chain",
         _chain_with(lambda v: v[v > 0], device), quiet)
    if device.type == "cuda":
        case("host-callback: copy to the CPU in a chain",
             _chain_with(lambda v: v.cpu(), device), quiet)
    topo = Topology(2, 2, devices=(device,) * 4)
    parts = [torch.ones(4, K, device=device)] * 2
    with record_collectives() as good:
        g = topo.slots(1)
        g.broadcast(parts[0])
        g.all_gather(parts)
        g.psum(parts)
        g.psum(parts)
    with record_collectives() as extra:
        g.psum_scatter(parts, dim=-2)
    with record_collectives() as rogue:
        Group(5, (device, device)).all_gather(parts)

    def comm(calls):
        return LINT.CommArtifact("comm", calls, comm="psum",
                                 allowed_groups=topology_groups(topo))

    case("collective-confinement: a collective over budget",
         comm(good + extra), comm(good))
    case("collective-confinement: a group outside the topology",
         comm(rogue), comm(good))
    case("donation-effectiveness: fresh planes per chunk",
         _window_reuse(device, True), _window_reuse(device, False))
    sigs = [(n, 1) for n in range(9)]
    case("recompilation-budget: a plan over cap",
         LINT.PlanArtifact("plan", sigs), LINT.PlanArtifact("plan", sigs[1:]))
    deps = {(0, 0): [], (1, 0): [(0, 0)]}
    ok = [("dispatch", (0, 0)), ("resolve", (0, 0)), ("dispatch", (1, 0)),
          ("resolve", (1, 0))]
    early = [ok[0], ok[2], ok[1], ok[3]]
    case("happens-before: dispatch before a dep resolved",
         LINT.TraceArtifact("t", early, deps),
         LINT.TraceArtifact("t", ok, deps))
    case("window-occupancy: over the window bound",
         LINT.TraceArtifact("t", early, deps, window_bound=1),
         LINT.TraceArtifact("t", ok, deps, window_bound=1))
    case("graph-validation: a dependency cycle",
         LINT.GraphArtifact("g", {**deps, (0, 0): [(1, 0)]}),
         LINT.GraphArtifact("g", deps))
    return out


def self_check(cases) -> dict:
    """``{case: (violations of its pass on the case, on the twin)}``."""
    return {name: tuple(sum(v.pass_name == pass_name
                            for v in LINT.analyze(a)) for a in (bad, good))
            for name, (pass_name, bad, good) in cases.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="static invariant lint over the executor registry")
    ap.add_argument("--all-executors", action="store_true",
                    help="lint every executor in engine.EXECUTORS")
    ap.add_argument("--executors", nargs="*", default=None,
                    help="subset of executor names to lint")
    ap.add_argument("--topo", type=int, nargs=2, default=(2, 2),
                    metavar=("BLOCK", "DATA"),
                    help="composed topology linted in addition to 1x1 "
                         "(single-controller slots on --device)")
    ap.add_argument("--json-out", type=Path, default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    names = sorted(ENG.EXECUTORS) if (args.all_executors
                                      or not args.executors) \
        else list(args.executors)
    for nm in names:
        if nm not in ENG.EXECUTORS:
            ap.error(f"unknown executor {nm!r}")

    topos = [Topology(1, 1, devices=(device,))]
    tb, td = args.topo
    if (tb, td) != (1, 1):
        topos.append(Topology(tb, td, devices=(device,) * (tb * td)))

    coo, p = SYN.generate("mini", seed=13)
    train, test = train_test_split(coo, 0.15, seed=14)
    cfg = BMF.BMFConfig(K=p.K, n_samples=5, burnin=1)
    part = partition(train, 3, 3)          # covers all four phase tags

    runs, all_violations = [], []
    for topo in topos:
        for name in names:
            rec, vs = lint_executor(name, topo, part, cfg, test, 5, device)
            runs.append(rec)
            all_violations += vs
            print(f"[bmf_lint] {name}@{topo.block}x{topo.data}: "
                  f"{len(rec['artifacts'])} artifact(s), "
                  f"{len(vs)} violation(s)", flush=True)
    for label, (rec, vs) in (("serving", lint_serving(device)),
                             ("sweep", lint_sweep(cfg, device))):
        runs.append(rec)
        all_violations += vs
        print(f"[bmf_lint] {label}: {len(rec['artifacts'])} artifact(s), "
              f"{len(vs)} violation(s)", flush=True)

    # the analyzer must see on this device: each pass fires on its
    # negative case and stays quiet on the clean twin
    cases = self_check(negative_cases(device))
    blind = [name for name, (bad, good) in cases.items()
             if not (bad > 0 and good == 0)]
    print(f"[bmf_lint] self-check: {len(cases) - len(blind)} of "
          f"{len(cases)} negative cases fire, their clean twins quiet",
          flush=True)

    report = {
        "executors": names,
        "topologies": [[t.block, t.data] for t in topos],
        "passes": [{"name": pz.name, "kind": pz.kind, "doc": pz.doc}
                   for pz in LINT.passes()],
        "runs": runs,
        "n_violations": len(all_violations),
        "device": str(device),
        "kernel_ops": dict(sum((Counter(r["kernel_ops"]) for r in runs),
                               Counter())),
        "self_check": {k: list(v) for k, v in cases.items()},
    }
    args.json_out.parent.mkdir(parents=True, exist_ok=True)
    args.json_out.write_text(json.dumps(report, indent=1))
    print(f"-> {args.json_out}")
    if all_violations:
        print(f"[bmf_lint] {len(all_violations)} violation(s):")
        for v in all_violations:
            print(str(v))
        return 1
    if blind:
        print(f"[bmf_lint] the analyzer missed {len(blind)} negative "
              f"case(s): {blind}")
        return 1
    print(f"[bmf_lint] OK: {len(runs)} executor/topology runs, "
          f"zero violations; kernel ops {report['kernel_ops']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
