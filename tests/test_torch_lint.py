"""``launch/bmf_lint`` and the analyzer hooks it runs: every chain the
executors dispatch (``gibbs.trace_chain``, ``distributed.trace_chain_2d``),
the fused factor step (``bmf_sweep.ops.trace_sweep``) and the scoring call
(``serving.scoring.trace_scoring``) run clean at the lint dims, and the
composed chains call exactly their comm mode's collectives per sweep. CPU
legs run the plain kernel versions; the ``cuda`` leg lints on the card,
where B1 and B2 run and appear in the op traces as ops of their own."""
import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch import analysis as A
from repro_torch.analysis import comm_passes as CP
from repro_torch.analysis.op_passes import materialization_budget
from repro_torch.core import bmf as TB
from repro_torch.core import distributed as TD
from repro_torch.core import gibbs as TG
from repro_torch.core.topology import Topology
from repro_torch.kernels.bmf_sweep import ops as SWEEP
from repro_torch.launch import bmf_lint as TLINT
from repro_torch.serving import scoring as SCORE
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D = TLINT.LINT_DIMS
DIMS = (D["n_rows"], D["n_cols"], D["m_rows"], D["m_cols"])
K = 8
REF_REPORT = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "bmf_lint_report.json"


def clean(tc, budget, comm=None, groups=None):
    """Every pass over a chain run's ops and collectives: no violation."""
    arts = [A.OpArtifact("ops", tc.ops, bytes_budget=budget),
            A.CommArtifact("comm", tc.collectives, sweeps=tc.sweeps,
                           comm=comm, allowed_groups=groups)]
    vs = [str(v) for a in arts for v in A.analyze(a)]
    assert not vs, "\n".join(vs)


CONFIGS = {"dense": {}, "use_kernel": dict(use_kernel=True),
           "fused": dict(sweep_fused=True),
           "fused_bf16": dict(sweep_fused=True, sweep_dtype="bf16")}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("chain,kw", [
    ("serial", {}), ("serial_no_prior", dict(u_prior=False, v_prior=False)),
    ("stacked", dict(batch=4)), ("prior_use", dict(batch=2, prior_use=True))])
def test_trace_chain_is_clean(chain, kw, cfg):
    tc = TG.trace_chain(TB.BMFConfig(K=K, **CONFIGS[cfg]), *DIMS,
                        D["n_test"], device="cpu", **kw)
    assert tc.sweeps == 2 and not tc.collectives
    assert {"aten::linalg_cholesky_ex", "aten::linalg_solve_triangular"} \
        <= {o.op for o in tc.ops}
    clean(tc, materialization_budget(*DIMS, K, batch=kw.get("batch", 1)))


@pytest.mark.parametrize("cfg", ["dense", "use_kernel", "fused"])
@pytest.mark.parametrize("comm", TD.COMM_MODES)
def test_trace_chain_2d_is_clean_and_on_budget(comm, cfg):
    """All three comm modes on Topology(2, 2) CPU groups: the collectives
    per sweep are exactly the budget, on group 0's slots only."""
    topo = Topology(2, 2, devices=("cpu",) * 4)
    tc = TD.trace_chain_2d(TB.BMFConfig(K=K, **CONFIGS[cfg]), topo, *DIMS,
                           D["n_test"], comm=comm, sweeps=3)
    per_sweep = {op: n / tc.sweeps for op, n in
                 Counter(c.op for c in tc.collectives).items()}
    assert per_sweep == CP.COLLECTIVE_BUDGETS[comm]
    assert {c.group for c in tc.collectives} == {0}
    n, c = DIMS[0], -(-DIMS[1] // 2) * 2
    clean(tc, materialization_budget(n, c * 2, *DIMS[2:], K, batch=2),
          comm=comm, groups=TLINT.topology_groups(topo))


@pytest.mark.parametrize("dtype", SWEEP.SWEEP_DTYPES)
def test_trace_sweep_is_clean(dtype):
    ts = SWEEP.trace_sweep(K, D["n_rows"], D["m_rows"], D["n_cols"],
                           dtype=dtype, device="cpu")
    assert all(o.plain == "repro_torch::bmf_sweep" for o in ts.ops
               if o.op == "aten::linalg_cholesky_ex")
    clean(ts, materialization_budget(*DIMS, K))


@pytest.mark.parametrize("mode", SCORE.MODES)
def test_trace_scoring_is_clean(mode):
    d = TLINT.SERVE_DIMS
    ts = SCORE.trace_scoring(d["n_users"], d["n_items"], d["K"], d["batch"],
                             d["n_seen"], d["n_fold"], d["n_slots"],
                             k=d["k"], mode=mode, device="cpu")
    budget = SCORE.scoring_budget(d["n_users"], d["n_items"], d["K"],
                                  d["batch"], d["n_slots"])
    assert not A.analyze(A.OpArtifact("s", ts.ops, bytes_budget=budget))
    # the dense all-users score matrix would not fit the budget
    assert 4 * d["n_users"] * d["n_items"] > budget


def test_bmf_lint_cli_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = TLINT.main(["--all-executors", "--topo", "2", "2", "--device",
                     "cpu", "--json-out", str(out)])
    assert rc == 0, capsys.readouterr().out
    rep = json.loads(out.read_text())
    ref_keys = set(json.loads(REF_REPORT.read_text()))
    assert ref_keys <= set(rep) and rep["n_violations"] == 0
    assert rep["topologies"] == [[1, 1], [2, 2]]
    assert len(rep["runs"]) == 5 * 2 + 2
    assert {p["name"] for p in rep["passes"]} == {p.name for p in
                                                  A.passes()}
    assert rep["kernel_ops"] == {}          # the CPU runs the plain versions
    labels = {lb for r in rep["runs"] for lb in r["artifacts"]}
    assert {"streaming@2x2/window", "sharded/composed[scatter]@2x2/comm",
            "serving/router/plan", "sweep/chain[bf16]/ops"} <= labels
    assert TLINT.OUT.parent.name == "build"
    cases = rep["self_check"]
    assert len(cases) >= 13 and {p.name for p in A.passes()} == {
        c.split(":")[0] for c in cases}
    assert all(bad > 0 and good == 0 for bad, good in cases.values())


@pytest.mark.cuda
def test_bmf_lint_on_the_card(cuda_device, tmp_path):
    """The lint on the card: zero violations, and B1 and B2 in the op
    traces as ops; the runtime guard refuses a host read."""
    out = tmp_path / "report.json"
    assert TLINT.main(["--all-executors", "--topo", "2", "2", "--device",
                       "cuda", "--json-out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert {"repro_torch::bmf_sweep", "repro_torch::bmf_precision"} <= set(
        rep["kernel_ops"])
    assert "host-callback: copy to the CPU in a chain" in rep["self_check"]
    tc = TG.trace_chain(TB.BMFConfig(K=K, use_kernel=True), *DIMS,
                        D["n_test"], device=cuda_device)
    assert {o.op for o in tc.ops if o.kernel} == {
        "repro_torch::bmf_precision"}
    with pytest.raises(RuntimeError):
        with A.guards.no_host_transfers():
            torch.ones(2, device=cuda_device).sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
