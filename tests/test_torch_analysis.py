"""The port's static invariant analyzer (``repro_torch.analysis``): the
registry, every pass on a negative case that must fire and on its clean
twin that must stay quiet, and the numbers and plans the reference's
pure-Python pieces still compute (its jaxpr and HLO passes need a JAX
this container's version broke, so only budgets, collective budgets and
plans are held to it). CPU only; no JAX subprocess."""
import dataclasses
from collections import Counter

import pytest
import torch

from repro_torch import analysis as A
from repro_torch.analysis import comm_passes as CP
from repro_torch.analysis import op_passes as OP
from repro_torch.analysis import optrace as OPT
from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import gibbs as TG
from repro_torch.core.partition import partition
from repro_torch.data import synthetic as TSYN
from repro_torch.data.sparse import train_test_split
from repro_torch.launch import bmf_lint as TLINT
from torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D = TLINT.LINT_DIMS
DIMS = (D["n_rows"], D["n_cols"], D["m_rows"], D["m_cols"])
K = 8
# the reference's HLO collective kinds -> the port's ``Group`` methods
KINDS = {"all-gather": "all_gather", "all-reduce": "psum",
         "reduce-scatter": "psum_scatter"}


def fired(art, name):
    """The violations of pass ``name`` on ``art`` (through the registry)."""
    return [v for v in A.analyze(art) if v.pass_name == name]


@pytest.fixture(scope="module")
def mini():
    coo, p = TSYN.generate("mini", seed=13)
    train, test = train_test_split(coo, 0.15, seed=14)
    return train, test, partition(train, 3, 3), p.K


# -- registry -----------------------------------------------------------------


def test_registry_refuses_duplicates_and_unknown_kinds():
    p = A.get_pass("materialization")
    with pytest.raises(ValueError, match="duplicate"):
        A.register(p)
    with pytest.raises(ValueError, match="unknown artifact kind"):
        A.register(A.Pass("x-pass", "jaxpr", "", lambda a: []))
    with pytest.raises(KeyError):
        A.get_pass("no-such-pass")
    assert {q.kind for q in A.passes()} <= set(A.KINDS)
    assert [q.name for q in A.passes("plan")] == ["recompilation-budget"]


def test_pass_names_and_violation_keys_are_the_reference_s():
    import repro.analysis as RA
    assert {p.name for p in A.passes()} == {p.name for p in RA.passes()}
    assert len(A.passes()) == 9
    args = ("p", "a", "m", "f")
    assert A.Violation(*args).as_dict() == RA.Violation(*args).as_dict()
    assert str(A.Violation(*args)) == str(RA.Violation(*args))


# -- numbers held to the reference ------------------------------------------


@pytest.mark.parametrize("dims", [
    (64, 48, 16, 24, 8, 1), (64, 96, 16, 24, 8, 2), (8656, 6820, 1088, 1432,
                                                      10, 45),
    (17, 3, 40, 2, 100, 3)])
def test_materialization_budget_is_the_reference_s(dims):
    from repro.analysis.jaxpr_passes import materialization_budget as ref
    n, c, mr, mc, k, b = dims
    assert OP.materialization_budget(n, c, mr, mc, k, batch=b) == \
        ref(n, c, mr, mc, k, batch=b)
    assert OP.materialization_budget(n, c, mr, mc, k, batch=b, slack=1.0) \
        == ref(n, c, mr, mc, k, batch=b, slack=1.0)


@pytest.mark.parametrize("dims", [(1024, 256, 8, 32, 8), (138493, 27278,
                                                          10, 32, 8),
                                  (5, 900, 3, 64, 1)])
def test_scoring_budget_is_the_reference_s(dims):
    from repro.serving.scoring import scoring_budget as ref
    from repro_torch.serving.scoring import scoring_budget
    assert scoring_budget(*dims) == ref(*dims)


def test_collective_budgets_map_onto_the_reference_s():
    """The reference's HLO kinds map one to one on the port's collectives;
    the only addition is one broadcast of V per U-step wherever the chain
    is data-sharded."""
    from repro.analysis.hlo_passes import COLLECTIVE_BUDGETS as REF
    assert set(REF) == set(CP.COLLECTIVE_BUDGETS)
    for comm, ref in REF.items():
        mapped = {KINDS[k]: n for k, n in ref.items()}
        port = dict(CP.COLLECTIVE_BUDGETS[comm])
        assert port.pop("broadcast", 0) == (0 if comm is None else 1)
        assert port == mapped, comm
    with pytest.raises(ValueError, match="unknown comm"):
        CP.default_budget("ring")


# -- plans held to the reference ----------------------------------------------


def _ref_plan(name, part, test, K):
    """The reference bmf_lint's ``plan_signatures``, recomputed from
    ``repro.core.pp`` (importing ``repro.launch.bmf_lint`` would set
    XLA_FLAGS for the whole worker)."""
    from repro.core import pp as JPP
    from repro.core.engine import apply_permutation
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    shapes = JPP.BlockShapes.per_phase(part, test_p)
    if name == "streaming":
        merged = JPP.BlockShapes.coalesce(shapes, K, max_waste=1.0)
        return sorted({s.astuple() for s in merged.values()})
    return sorted((tag, s.astuple()) for tag, s in shapes.items())


def test_plan_signatures_are_the_reference_s(mini):
    from repro.core.partition import partition as jpartition
    from repro.data import synthetic as JSYN
    from repro.data.sparse import train_test_split as jsplit
    _, test, part, K_ = mini
    coo, _ = JSYN.generate("mini", seed=13)
    jtrain, jtest = jsplit(coo, 0.15, seed=14)
    jpart = jpartition(jtrain, 3, 3)
    for name in TENG.EXECUTORS:
        port = TLINT.plan_signatures(name, part, test, TB.BMFConfig(K=K_))
        assert port == _ref_plan(name, jpart, jtest, K_), name
        assert not A.analyze(A.PlanArtifact("plan", port))


def test_router_plan_is_the_reference_s():
    from repro.serving import router as JR
    from repro.serving import scoring as JS
    from repro_torch.serving.router import MicroBatchRouter
    from repro_torch.serving.store import abstract_store
    d = TLINT.SERVE_DIMS
    dims = (d["n_users"], d["n_items"], d["K"], d["n_slots"])
    port = MicroBatchRouter(abstract_store(*dims), k=d["k"],
                            max_batch=d["batch"]).plan_signatures
    ref = JR.MicroBatchRouter(JS.abstract_store(*dims), k=d["k"],
                              max_batch=d["batch"]).plan_signatures
    assert port == ref


# -- negative cases, each with its clean twin ---------------------------------


@pytest.fixture(scope="module")
def cases(one_torch_thread):
    """``bmf_lint.negative_cases`` on the CPU: {case: (pass, bad, twin)}."""
    return TLINT.negative_cases("cpu")


def case(cases, prefix):
    """The (case, twin) artifacts of the one case named ``prefix``..."""
    (hit,) = [v for k, v in cases.items() if k.startswith(prefix)]
    return hit[1], hit[2]


@pytest.mark.parametrize("name", sorted(p.name for p in A.passes()))
def test_each_pass_fires_on_its_case_and_not_on_its_twin(cases, name):
    mine = [(bad, good) for p, bad, good in cases.values() if p == name]
    assert mine, f"no negative case for {name}"
    for bad, good in mine:
        assert fired(bad, name), bad.label
        assert not fired(good, name), good.label
    assert TLINT.self_check(cases) == {
        k: (len(fired(b, p)), 0) for k, (p, b, _) in cases.items()}


def test_materialization_names_the_dense_buffer(cases):
    """A dense (N, D, K) factor tensor against the block budget; the
    padded-plane gather of ``bmf.sufficient_stats`` is the clean twin."""
    bad, _ = case(cases, "materialization: dense")
    vs = fired(bad, "materialization")
    assert len(vs) == 1 and "[1, 64, 48, 8]" in vs[0].message
    assert not fired(dataclasses.replace(bad, bytes_budget=None),
                     "materialization")


def test_dense_path_gathers_no_int64_index_plane():
    """The dense sufficient statistics gather f32 rows through one int64
    (n·M) index, not an (N, M, K) int64 index twice the plane: at the
    lint dims the largest buffer is the f32 gather, half the budget."""
    tc = TG.trace_chain(TB.BMFConfig(K=K), *DIMS, D["n_test"], device="cpu")
    nb, op, dt, shape = OPT.largest_buffer(tc.ops)
    assert (nb, dt) == (D["n_cols"] * D["m_cols"] * K * 4, "float32")
    assert nb * 2 == OP.materialization_budget(*DIMS, K)
    idx = [b for o in tc.ops for d, _, b in o.new if d == "int64"]
    assert max(idx) <= 8 * D["n_cols"] * D["m_cols"]


def test_dtype_promotion_names_float64_and_the_bf16_operand(cases):
    f64, _ = case(cases, "dtype-promotion: float64")
    v64 = fired(f64, "dtype-promotion")
    assert v64 and all("float64" in v.message for v in v64)
    assert not fired(dataclasses.replace(f64, allow_f64=True),
                     "dtype-promotion")
    bf16, _ = case(cases, "dtype-promotion: bf16 operand to cholesky")
    vs = fired(bf16, "dtype-promotion")
    assert len(vs) == 1 and "linalg_cholesky_ex" in vs[0].message
    with OPT.record() as sqrt:
        torch.sqrt(torch.ones(4, dtype=torch.bfloat16))
    vs = fired(A.OpArtifact("sqrt", sqrt.ops), "dtype-promotion")
    assert len(vs) == 1 and "sqrt" in vs[0].message


def test_dtype_promotion_checks_b2_operands_by_name(cases):
    """B2 factors inside the kernel: only its gathered ``other`` may be
    bf16, never the prior or the noise it factors and solves with."""
    bad, ok = case(cases, "dtype-promotion: bf16 prior into B2")
    assert OPT.kernel_counts(ok.ops) == {"repro_torch::bmf_sweep": 1}
    vs = fired(bad, "dtype-promotion")
    assert len(vs) == 1 and "'prior_lam'" in vs[0].message


def test_host_callback_names_the_host_read(cases):
    bad, _ = case(cases, "host-callback: .item()")
    vs = fired(bad, "host-callback")
    assert len(vs) == 2 and "_local_scalar_dense" in vs[0].message
    assert "host-callback: copy to the CPU in a chain" not in cases


def test_host_callback_ignores_the_kernels_plain_routes():
    """B1's and B2's plain versions trim their stripes with a host read of
    the live lengths; on the card those regions are one launch each."""
    for cfg in (dict(use_kernel=True), dict(sweep_fused=True)):
        tc = TG.trace_chain(TB.BMFConfig(K=K, **cfg), *DIMS, D["n_test"],
                            device="cpu")
        reads = [o for o in tc.ops if o.op == "aten::_local_scalar_dense"]
        assert reads and all(o.plain for o in reads)
        assert not fired(A.OpArtifact("c", tc.ops), "host-callback")


def test_collective_confinement_names_the_extra_call_and_the_group(cases):
    over, clean = case(cases, "collective-confinement: a collective over")
    # recorded at the public entry: psum_scatter counts once, no inner psum
    assert Counter(c.op for c in over.calls) == {
        "broadcast": 1, "all_gather": 1, "psum": 2, "psum_scatter": 1}
    vs = fired(over, "collective-confinement")
    assert len(vs) == 1 and vs[0].message.split()[1] == "psum_scatter"
    assert len(fired(dataclasses.replace(clean, comm="gather"),
                     "collective-confinement")) == 1
    assert fired(dataclasses.replace(clean, comm=None),
                 "collective-confinement")
    # two sweeps of a 'psum' chain are twice the per-sweep budget
    assert not fired(dataclasses.replace(clean, calls=clean.calls * 2,
                                         sweeps=2), "collective-confinement")
    rogue, _ = case(cases, "collective-confinement: a group outside")
    vs = fired(rogue, "collective-confinement")
    assert len(vs) == 1 and "none of the topology" in vs[0].message
    with pytest.raises(ValueError, match="unknown comm"):
        fired(dataclasses.replace(clean, comm="ring"),
              "collective-confinement")


def test_donation_effectiveness_names_planes_outside_the_slots(cases):
    """Planes allocated per chunk and freed after it may come back at
    the same addresses; they are never a slot's storage."""
    fresh, clean = case(cases, "donation-effectiveness")
    assert len(clean.handed) > len(clean.slots[0]) == 2
    vs = fired(fresh, "donation-effectiveness")
    assert len(vs) == 1 and "outside its 2 slot(s)" in vs[0].message
    assert TENG.StreamingExecutor.window_cls is TENG._Window


def test_recompilation_budget_fires_on_a_plan_over_cap(mini):
    _, test, part, K_ = mini
    sigs = TLINT.plan_signatures("stacked", part, test, TB.BMFConfig(K=K_))
    assert len(sigs) == 4
    assert not fired(A.PlanArtifact("p", sigs, cap=4), "recompilation-budget")
    assert fired(A.PlanArtifact("p", sigs, cap=3), "recompilation-budget")


def test_trace_and_graph_twins_pass_every_pass(cases):
    for prefix in ("happens-before", "window-occupancy", "graph-validation"):
        _, good = case(cases, prefix)
        assert not A.analyze(good), prefix
