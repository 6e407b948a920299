"""The port's dry run (``launch.bmf_dryrun``) against the reference's.

One subprocess runs the reference's lowerings at N = 64, D = 48, M = 16,
K = 10 on 4 faked devices: ``lower_sweep`` (psum and scatter-V) and
``lower_pp_phase_2d`` on a 2 × 2 topology in the 'scatter' mode. It
starts with the module (importing ``repro.launch.bmf_dryrun`` sets
``XLA_FLAGS`` for 512 host devices, so it never runs in the test worker)
and the port-only tests run while it compiles.

Collectives, kind by kind (bytes per device, the reference's result-shape
convention):
- the port's one sweep makes the reference's calls, plus its ``broadcast``
  of V to the slots (a kind of its own: the reference's shard_map gets V
  replicated). One more difference: the reference's sweep keeps U
  sharded and psums U's moments (Σu, Σuuᵀ: 4(K² + K) bytes, one
  all-reduce) for the NW draw, where the port's U-step all-gathers U
  (N·K floats, one all-gather), as both packages' composed 2-D chains do.
  Everything else is equal: psum's (Λ, η) all-reduce (2 calls), and
  scatter-V's reduce-scatter (2 calls) and V all-gather (1 call).
- the composed 2-D chain: per group and sweep the reference's 4
  collectives (2 all-gathers, 2 reduce-scatters) plus the broadcast, all
  confined to a group's slots, none crossing groups. The reference
  reports 0.0 bytes for them (its HLO graph walk misses them); the port
  records their bytes.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.core import bmf as TB
from repro_torch.launch import bmf_dryrun as DRY
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
N, D, M, K, S, L = 64, 48, 16, 10, 4, 4
U_MOMENTS = 4 * (K * K + K)        # the reference's psum of U's moments
SMALL = ["--shards", "4", "--k", "10", "--n", "64", "--d", "48", "--m",
         "16", "--pp-engine", "--samples", "4", "--window", "2", "--topo",
         "2", "2"]
VARIANTS = ["paper_psum", "scatter_v", "pp_phase_c_sharded",
            "pp_phase_c_composed_2d", "pp_phase_c_composed_2d",
            "pp_block_async_donated", "pp_window_streaming_donated"]
# each reference record's keys (src/repro/launch/bmf_dryrun.py)
REF_KEYS = {
    "paper_psum": {"variant", "n_shards", "N", "D", "M", "K", "roofline",
                   "analytic_comm_bytes", "collectives"},
    "pp_phase_c_sharded": {"variant", "n_blocks", "N", "D", "M", "K",
                           "chain_len", "roofline", "collectives",
                           "intra_phase_collective_bytes"},
    "pp_phase_c_composed_2d": {"variant", "comm", "topology", "N", "D", "M",
                               "K", "chain_len", "roofline", "collectives",
                               "collective_axis_check"},
    "pp_block_async_donated": {"variant", "N", "D", "M", "K", "chain_len",
                               "roofline", "collectives",
                               "intra_phase_collective_bytes",
                               "has_input_output_alias", "alias_bytes",
                               "donated_input_bytes"},
    "pp_window_streaming_donated": {"variant", "window", "n_blocks", "N",
                                    "D", "M", "K", "chain_len",
                                    "window_effective_peak_bytes",
                                    "stacked_bucket_effective_peak_bytes",
                                    "peak_ratio"},
}
REF_KEYS["scatter_v"] = REF_KEYS["paper_psum"]

REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.launch import bmf_dryrun as DRY
    N, D, M, K, S, L = %d, %d, %d, %d, %d, %d
    out = {}
    for sv in (False, True):
        r = DRY.lower_sweep(S, N, D, M, K, sv)
        out[r["variant"]] = r
    out["composed"] = DRY.lower_pp_phase_2d(2, 2, N, D, M, K, L,
                                            comm="scatter")
    json.dump(out, open(sys.argv[1], "w"), default=str)
""") % (N, D, M, K, S, L)


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    """The reference's lowerings, started with the module."""
    path = tmp_path_factory.mktemp("ref") / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_ref_proc):
    proc, path = _ref_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def small():
    """The port's records at the test shape, every unit on ``meta``."""
    return DRY.run(DRY.parser().parse_args(SMALL))


def test_records_have_the_references_variants_and_keys(small):
    assert [r["variant"] for r in small] == VARIANTS
    assert [r.get("comm") for r in small if "comm" in r] == ["scatter",
                                                             "gather"]
    for r in small:
        assert REF_KEYS[r["variant"]] <= set(r), r["variant"]
        assert isinstance(r["fits_80gb"], bool)
        if "roofline" in r:
            assert r["roofline"]["dominant"] in ("compute", "memory",
                                                 "collective")


def test_units_without_collectives(small):
    """Same-phase blocks never talk: the stacked bucket and the async
    block record no collective. The async unit reuses no input storage
    (no donation: each factor step allocates its U and V); what the
    reference donates is computed as it computes it."""
    by = {r["variant"]: r for r in small}
    for v in ("pp_phase_c_sharded", "pp_block_async_donated"):
        assert by[v]["intra_phase_collective_bytes"] == 0.0
    a = by["pp_block_async_donated"]
    assert a["alias_bytes"] == 0 and a["has_input_output_alias"] is False
    m_c = DRY.cols_budget(N // 5 + 1, D // 5 + 1, 8)
    n, d = N // 5 + 1, D // 5 + 1
    assert a["donated_input_bytes"] == (12 * (n * 8 + d * m_c)
                                        + 8 * DRY.N_TEST + 4 * (n + d) * K)
    assert a["kernel_launches"] == {"repro_torch::bmf_sweep": 2}


def test_window_peak_below_the_bucket(small):
    """The streaming chunk's planned peak scales with W, the stacked
    bucket's with B (the reference's ratio at its test shape: 0.51)."""
    w = small[-1]
    assert 0 < w["window_effective_peak_bytes"] < \
        w["stacked_bucket_effective_peak_bytes"]
    assert w["peak_ratio"] < 1


def test_meta_plan_allocates_nothing_on_the_host():
    """The phase-c bucket at the reference's defaults (16 blocks of
    96,052 × 3,559, K = 100) planned on ``meta``: no host storage above
    64 MiB is made, and the plan holds a (16, 96,052, 100, 100) f32 Λ
    (61.5 GB) among much else, so it does not fit one card."""
    with OPT.record() as tr:
        rec = DRY.lower_pp_phase(16, 96_052, 3_559, 128, 100, 60)
    host = [nb for o in tr.ops for (_, _, nb), (_, dev) in
            zip(o.new, o.new_keys) if dev == "cpu"]
    assert max(host, default=0) < 64 * 2**20
    assert sum(host) < 64 * 2**20
    assert rec["peak_bytes"] > 16 * 96_052 * 100 * 100 * 4
    assert rec["fits_80gb"] is False
    assert rec["kernel_launches"] == {"repro_torch::bmf_precision": 2}


def test_cli_writes_its_json(tmp_path, capsys):
    out = tmp_path / "plan.json"
    DRY.main(SMALL + ["--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["variant"] for r in recs] == VARIANTS
    text = capsys.readouterr().out
    assert "paper_psum" in text and "crossing-'block'=0" in text
    assert f"-> {out}" in text


def test_chain_config_is_what_the_card_runs():
    assert DRY.chain_config(10).sweep_fused
    assert DRY.chain_config(32).sweep_fused
    c = DRY.chain_config(100)
    assert c.use_kernel and not c.sweep_fused


@pytest.mark.parametrize("variant", ["paper_psum", "scatter_v"])
def test_sweep_collectives_against_the_reference(ref, variant):
    """Kind by kind (module docstring): equal, with the port's broadcast
    of V beside them and its all-gather of U where the reference psums
    U's moments."""
    port = DRY.lower_sweep(S, N, D, M, K, variant == "scatter_v")
    want, got = ref[variant]["collectives"], port["collectives"]
    assert port["analytic_comm_bytes"] == ref[variant][
        "analytic_comm_bytes"]
    assert (got["broadcast"], got["n_broadcast"]) == (4 * D * K, 1)
    u_gather = 4 * N * K
    assert want["all-reduce"] - U_MOMENTS == got["all-reduce"]
    if variant == "paper_psum":
        assert (want["n_all-reduce"], got["n_all-reduce"]) == (2, 2)
        assert (want["n_all-gather"], got["n_all-gather"]) == (0, 1)
        assert got["all-gather"] == u_gather
        assert got["all-reduce"] == 4 * D * (K * K + K)
    else:
        assert (want["n_all-reduce"], got["n_all-reduce"]) == (1, 0)
        for kind in ("reduce-scatter", "n_reduce-scatter"):
            assert got[kind] == want[kind]
        assert got["all-gather"] - u_gather == want["all-gather"]
        assert got["n_all-gather"] - 1 == want["n_all-gather"] == 1
    assert want["all-to-all"] == got["all-to-all"] == 0


def test_composed_2d_against_the_reference(ref):
    """Per group and sweep the reference's collectives plus the broadcast,
    every one confined to its group; the port records their bytes where
    the reference reports 0.0."""
    port = DRY.lower_pp_phase_2d(2, 2, N, D, M, K, L, comm="scatter")
    want = ref["composed"]
    chk = port["collective_axis_check"]
    per = dict(chk["per_group_per_sweep"])
    assert per.pop("broadcast") == 1
    assert sum(per.values()) == want["collective_axis_check"][
        "n_collectives"] == 4
    assert per == {"all-gather": want["collectives"]["n_all-gather"],
                   "reduce-scatter": want["collectives"]["n_reduce-scatter"]}
    assert chk["n_crossing_block_axis"] == 0 == want[
        "collective_axis_check"]["n_crossing_block_axis"]
    assert chk["n_confined_to_data_axis"] == chk["n_collectives"] == 2 * 5
    assert sum(v for k, v in want["collectives"].items()
               if not k.startswith("n_")) == 0.0
    assert port["collectives"]["reduce-scatter"] > 0
    assert port["collectives"]["all-gather"] > 0


@pytest.mark.cuda
def test_plan_against_the_card(cuda_device):
    """A small bucket planned on ``meta``, then run on the card: the
    launches are the planned ones and the peak within 25%."""
    from repro_torch.core import gibbs as TG
    from repro_torch.kernels.bmf_sweep import ops as B2
    cfg = TB.BMFConfig(K=K, sweep_fused=True)
    dims = (512, 384, 64, 96)
    plan = DRY.trace_bucket(cfg, 4, *dims, sweeps=2, n_test=256)
    inp = TG.lint_inputs(0, 4, *dims, 256, K, cuda_device)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - plan.input_bytes
    torch.cuda.reset_peak_memory_stats()
    B2.fused_sweep.launches = 0
    TG.run_gibbs_stacked(
        list(range(4)), inp.rows, inp.cols, inp.test_rows, inp.test_cols,
        cfg._replace(n_samples=2, burnin=1), inp.U_prior, inp.V_prior,
        device=cuda_device)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - held
    assert B2.fused_sweep.launches == OPT.kernel_counts(plan.ops)[
        "repro_torch::bmf_sweep"] == 4
    assert abs(plan.peak_bytes / measured - 1) <= 0.25
