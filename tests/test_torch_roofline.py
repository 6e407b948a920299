"""The port's roofline cost model (``roofline.op_cost``,
``roofline.analysis``) against the reference's ``jaxpr_cost``.

One subprocess costs the reference's jaxprs (``jax.make_jaxpr`` +
``repro.roofline.jaxpr_cost``) of single ops and of one plain sweep —
both NW hyperpriors, the U-step and the V-step on the dense path — and
saves its numpy inputs; the port costs the op traces of the same calls
on the same inputs.

- Single ops (matmul, batched matmul, the chain's einsum, a gather, an
  elementwise op): ``dot_flops`` and ``bytes_min`` equal exactly.
- The sweep: ``dot_flops`` equal within 1% (they are equal). ``flops``
  and ``bytes`` are not: the port's sweep counts 0.839 of the
  reference's flops and 0.626 of its unfused bytes at this shape. Both
  sides count one flop per output element of every elementwise op, and
  the ops differ: each ``jax.random`` draw is dozens of threefry
  primitives where the port's is one ``normal_``; ``jnp.linalg.inv`` is
  an LU with pivoting, ``cho_solve`` and the symmetrizations add
  ``transpose``/``add``/``select`` eqns; the port's ``cholesky_ex``,
  ``cholesky_solve`` and ``solve_triangular`` are one op each. So the
  matmul work agrees and the elementwise counts describe each side's own
  decomposition.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.core import bmf as TB
from repro_torch.core import gibbs as TG
from repro_torch.core import posterior as TPOST
from repro_torch.core.topology import CollectiveCall
from repro_torch.data.sparse import PaddedCSR
from repro_torch.kernels.bmf_precision import ops as PREC
from repro_torch.kernels.bmf_precision.ref import gather_rows
from repro_torch.kernels.bmf_sweep import ops as SWEEP
from repro_torch.noise import GeneratorNoise
from repro_torch.roofline import analysis as ROOF
from repro_torch.roofline import op_cost as COST
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
N, D, M, MC, K = 64, 48, 16, 24, 10
SINGLE = ("matmul", "bmm", "einsum", "gather", "elementwise")

REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.roofline.jaxpr_cost import jaxpr_cost
    from repro.core import bmf as BMF, posterior as POST
    from repro.data.sparse import PaddedCSR

    N, D, M, MC, K = %d, %d, %d, %d, %d
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(a=f(N, K), b=f(K, D), a3=f(3, N, K), b3=f(3, K, D),
             vm=f(N, M, K), vg=f(N, M, K), other=f(D, K),
             idx=rng.integers(0, D, (N, M)).astype(np.int32),
             val_r=f(N, M), idx_c=rng.integers(0, N, (D, MC)).astype(
                 np.int32), val_c=f(D, MC), U=f(N, K), V=f(D, K))
    cost = lambda fn, *a: jaxpr_cost(jax.make_jaxpr(fn)(*a))
    out = {}
    out["matmul"] = cost(lambda p, q: p @ q, x["a"], x["b"])
    out["bmm"] = cost(lambda p, q: p @ q, x["a3"], x["b3"])
    out["einsum"] = cost(lambda p, q: jnp.einsum("nmk,nml->nkl", p, q),
                         x["vm"], x["vg"])
    out["gather"] = cost(lambda o, i: o[i], x["other"], x["idx"])
    out["elementwise"] = cost(lambda p, q, r: p * q + r, x["a"], x["a"],
                              x["a"])
    csr_r = PaddedCSR(jnp.asarray(x["idx"]), jnp.asarray(x["val_r"]),
                      jnp.ones((N, M)), D)
    csr_c = PaddedCSR(jnp.asarray(x["idx_c"]), jnp.asarray(x["val_c"]),
                      jnp.ones((D, MC)), N)
    nw = POST.default_nw(K)

    def sweep(key, U, V):
        kh1, kh2, ku, kv = jax.random.split(key, 4)
        mu, Lam = BMF.sample_hyper(kh1, U, nw)
        up = POST.broadcast_prior(mu, Lam, N)
        mu, Lam = BMF.sample_hyper(kh2, V, nw)
        vp = POST.broadcast_prior(mu, Lam, D)
        U = BMF.sample_factor(ku, csr_r, V, 2.0, up)
        return BMF.sample_factor(kv, csr_c, U, 2.0, vp)

    out["sweep"] = cost(sweep, jax.random.key(0), x["U"], x["V"])
    json.dump(out, open(sys.argv[1] + ".json", "w"))
    np.savez(sys.argv[1] + ".npz", **x)
""") % (N, D, M, MC, K)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's costs and the numpy inputs, from one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "cost"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    costs = json.loads(Path(str(path) + ".json").read_text())
    x = {k: torch.from_numpy(v) for k, v in
         np.load(str(path) + ".npz").items()}
    return costs, x


def _single(name, x):
    if name == "matmul":
        return lambda p, q: p @ q, (x["a"], x["b"])
    if name == "bmm":
        return lambda p, q: p @ q, (x["a3"], x["b3"])
    if name == "einsum":     # as ``precision_accum_ref`` writes it
        return (lambda p, q: torch.einsum("...mk,...ml->...kl", p, q),
                (x["vm"], x["vg"]))
    if name == "gather":     # as the dense path gathers rows
        return (lambda o, i: gather_rows(o[None], i[None]),
                (x["other"], x["idx"]))
    return lambda p, q, r: p * q + r, (x["a"], x["a"], x["a"])


@pytest.mark.parametrize("name", SINGLE)
def test_single_op_costs_match_jaxpr_cost(ref, name):
    costs, x = ref
    fn, args = _single(name, x)
    got = COST.traced_cost(fn, *args)
    want = costs[name]
    assert got["dot_flops"] == want["dot_flops"], (got, want)
    assert got["bytes_min"] == want["bytes_min"], (got, want)


def _sweep_cost(x, dev):
    """One plain sweep of the port's chain (``gibbs.sweep`` with the dense
    samplers, NW hyperpriors on both sides) on the reference's inputs."""
    to = lambda t: t.to(dev)[None]          # noqa: E731
    rows = PaddedCSR(to(x["idx"]), to(x["val_r"]),
                     torch.ones(1, N, M, device=dev), D)
    cols = PaddedCSR(to(x["idx_c"]), to(x["val_c"]),
                     torch.ones(1, D, MC, device=dev), N)
    step = TG.default_sampler(TB.BMFConfig(K=K), None)
    noise = GeneratorNoise([0], dev)
    nw = TPOST.default_nw(K, device=dev)
    return COST.traced_cost(
        lambda U, V: TG.sweep(noise, nw, 0, U, V, rows, cols, N, D, K, None,
                              None, None, None, step, step),
        to(x["U"]), to(x["V"]))


def test_plain_sweep_matches_jaxpr_cost(ref):
    """dot_flops within 1% (equal); the flops and unfused-bytes ratios
    stated in the module docstring (0.839, 0.626) stay where they are.
    The sweep on ``meta`` costs exactly what it costs on the CPU."""
    costs, x = ref
    got, want = _sweep_cost(x, "cpu"), costs["sweep"]
    assert abs(got["dot_flops"] / want["dot_flops"] - 1) <= 0.01
    assert got["flops"] / want["flops"] == pytest.approx(0.839, abs=0.005)
    assert got["bytes"] / want["bytes"] == pytest.approx(0.626, abs=0.005)
    meta = _sweep_cost(x, "meta")
    assert {k: meta[k] for k in COST.KEYS} == {k: got[k] for k in COST.KEYS}


def _full_lint_dims():
    """Chain dims whose lint planes have a full row on both sides, so the
    CPU plain versions' stripe trims keep every slot (as the plan's
    kernel costing does)."""
    n, c, mr, mc = 64, 48, 16, 12
    inp = TG.lint_inputs(0, 2, n, c, mr, mc, 8, K, "cpu")
    for p in (inp.rows, inp.cols):
        assert int(p.mask.sum(-1).max()) == p.mask.shape[-1]
    return n, c, mr, mc


@pytest.mark.parametrize("route", ["use_kernel", "sweep_fused"])
def test_kernel_routes_cost_the_plain_route(route):
    """The same work whatever implements it: a chain whose factor steps
    are kernel launches (``meta``: launch records costed by the plain
    versions) costs the flops and dot_flops of the same chain whose
    wrappers ran the plain versions (the CPU)."""
    cfg = TB.BMFConfig(K=K, **{route: True})
    dims = _full_lint_dims()
    meta = TG.trace_chain(cfg, *dims, 8, batch=2, sweeps=1, device="meta")
    cpu = TG.trace_chain(cfg, *dims, 8, batch=2, sweeps=1, device="cpu")
    name = ("repro_torch::bmf_precision" if route == "use_kernel"
            else "repro_torch::bmf_sweep")
    assert OPT.kernel_counts(meta.ops) == {name: 2}
    assert OPT.kernel_counts(cpu.ops) == {}
    cm, cc = COST.op_cost(meta.ops), COST.op_cost(cpu.ops)
    assert cm["flops"] == cc["flops"] and cm["dot_flops"] == cc["dot_flops"]
    # the kernel reads each slot once where the plain version also
    # gathers a (B, N, M, K) tensor
    assert cm["bytes_min"] < cc["bytes_min"]


def _refuse(*a, **k):
    raise AssertionError("the meta path ran on a non-meta operand")


def test_meta_path_never_runs_off_meta(monkeypatch):
    """The kernels' ``_plan`` runs only for ``meta`` operands: a CPU
    chain through both kernels' wrappers never reaches it."""
    monkeypatch.setattr(PREC, "_plan", _refuse)
    monkeypatch.setattr(SWEEP, "_plan", _refuse)
    for kw in (dict(use_kernel=True), dict(sweep_fused=True),
               dict(sweep_fused=True, K=40)):
        cfg = TB.BMFConfig(**{"K": K, **kw})
        TG.trace_chain(cfg, 24, 16, 8, 8, 4, batch=2, sweeps=1, device="cpu")


@pytest.mark.cuda
def test_meta_path_never_runs_on_the_card(monkeypatch, cuda_device):
    monkeypatch.setattr(PREC, "_plan", _refuse)
    monkeypatch.setattr(SWEEP, "_plan", _refuse)
    for kw in (dict(use_kernel=True), dict(sweep_fused=True)):
        tc = TG.trace_chain(TB.BMFConfig(K=K, **kw), 24, 16, 8, 8, 4,
                            batch=2, sweeps=1, device=cuda_device)
        assert sum(OPT.kernel_counts(tc.ops).values()) == 2


def _launch(kernel, B, n, m, d, k, dtype=torch.float32):
    """One launch record on ``meta`` operands through the wrapper."""
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,  # noqa: E731
                                                 device="meta")
    idx, val, mask = e(B, n, m, dt=torch.int32), e(B, n, m), e(B, n, m)
    other = e(B, d, k, dt=dtype)
    with OPT.record() as tr:
        if kernel == "b1":
            PREC.precision_accum(idx, val, mask, other, 2.0)
        else:
            SWEEP.fused_sweep(e(B, n, k), idx, val, mask, e(B, n, k),
                              e(B, n, k, k), other, 2.0,
                              dtype="bf16" if dtype == torch.bfloat16
                              else "fp32")
    recs = [o for o in tr.ops if o.kernel]
    assert len(recs) == 1
    return recs[0]


def _attention_launch(kernel, dtype):
    """One L1 (with lse), L2 or L3 launch record on ``meta`` operands
    through the wrapper, at a small GQA shape."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    B, S, H, Hkv, hd = 2, 48, 4, 2, 32

    def e(*s, dt=dtype):
        return torch.empty(s, dtype=dt, device="meta")

    q, k, v = e(B, S, H, hd), e(B, S, Hkv, hd), e(B, S, Hkv, hd)
    with OPT.record() as tr:
        if kernel == "l1":
            FA.flash_attention(q, k, v, causal=True, return_lse=True)
        elif kernel == "l2":
            FA.flash_bwd(q, k, v, q, q, e(B, S, H, dt=torch.float32))
        else:
            DA.decode_attention(e(B, H, hd), k, v,
                                e(S, dt=torch.int32), S - 1)
    recs = [o for o in tr.ops if o.kernel]
    assert len(recs) == 1
    return recs[0]


@pytest.mark.parametrize("case", ["b1-k10", "b1-k40-fp32", "b1-k40-bf16",
                                  "b2-k10", "l1-fp32", "l1-bf16", "l2-fp32",
                                  "l2-bf16", "l3-fp32", "l3-bf16"])
def test_kernel_cost_rules(case):
    """A launch's bytes are its operands read once (planes at the live
    slots) and outputs written once; its flops the plain version's at the
    mean live length; B1 above K = 16 on the tensor cores. L1 and L2 run
    their products on the tensor cores in either dtype (f32: 3xTF32, as
    B1), L3 on the CUDA cores."""
    if case.startswith("l"):
        kernel, name = case.split("-")
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        rec = _attention_launch(kernel, dtype)
        c = COST.kernel_cost(rec)
        assert c["bytes_min"] == c["bytes"] == sum(
            COST._nbytes(x) for x in rec.operands + rec.outputs)
        assert c["dot_flops"] > 0
        if kernel == "l3":
            assert c["fp32_flops"] == c["flops"]
            assert c["tf32_flops"] == c["bf16_flops"] == 0
            return
        assert c["fp32_flops"] == c["flops"] - c["dot_flops"]
        if dtype == torch.bfloat16:
            assert c["bf16_flops"] == c["dot_flops"] and c["tf32_flops"] == 0
        else:
            assert c["tf32_flops"] == 3 * c["dot_flops"]
            assert c["bf16_flops"] == 0
        return
    kernel, k = case.split("-")[0], int(case.split("-")[1][1:])
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    B, n, m, d = 2, 20, 12, 30
    rec = _launch(kernel, B, n, m, d, k, dtype)
    elt = 2 if dtype == torch.bfloat16 else 4
    out = 4 * B * n * (k * k + k) if kernel == "b1" else 4 * B * n * k
    extra = 0 if kernel == "b1" else 4 * B * n * (k * k + 2 * k)
    for slots in (None, B * n * 5, B * n * 5 + 7):
        c = COST.kernel_cost(rec, slots)
        s = B * n * m if slots is None else slots
        assert c["bytes_min"] == c["bytes"] == (
            12 * s + 4 * B * n + elt * B * d * k + extra + out)
    # flops are linear in the live slots between whole row lengths
    c5, c6 = COST.kernel_cost(rec, B * n * 5), COST.kernel_cost(rec, B * n * 6)
    half = COST.kernel_cost(rec, B * n * 5.5)
    assert half["flops"] == pytest.approx((c5["flops"] + c6["flops"]) / 2)
    assert c6["dot_flops"] > c5["dot_flops"]
    full = COST.kernel_cost(rec)
    if case.startswith("b1-k40"):
        rate = "bf16" if dtype == torch.bfloat16 else "tf32"
        mult = 1 if rate == "bf16" else 3
        assert full[f"{rate}_flops"] == mult * full["dot_flops"]
        assert full["fp32_flops"] == full["flops"] - full["dot_flops"]
    else:
        assert full["fp32_flops"] == full["flops"]
        assert full["tf32_flops"] == full["bf16_flops"] == 0


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_peak_buffer_bytes_tracks_frees(dev):
    """The high-water mark sees each buffer from its op to its death:
    inputs, then a (kept) and b (freed before c) live together."""
    x = torch.ones(1000, device=dev)            # 4,000 B, an input

    def fn(x):
        a = x * 2                   # 4,000 B
        b = x + 1                   # 4,000 B: peak 12,000 with x and a
        del b
        c = a.repeat(2)             # 8,000 B: x + a + c = 16,000
        return c

    with OPT.record() as tr:
        fn(x)
    assert COST.peak_buffer_bytes(tr, [x]) == 16000
    assert COST.peak_buffer_bytes(tr.ops, [x]) == 20000   # no frees
    assert COST.peak_buffer_bytes(tr, [x], device="cuda") == 0
    assert COST.traced_cost(fn, x)["peak_bytes"] == 16000


def test_meta_plan_matches_the_cpu_trace():
    """A chain planned on ``meta`` runs the same ops as on the CPU and
    plans the CPU's high-water mark exactly."""
    cfg = TB.BMFConfig(K=K)
    meta = TG.trace_chain(cfg, 40, 30, 12, 16, 8, batch=3, device="meta")
    cpu = TG.trace_chain(cfg, 40, 30, 12, 16, 8, batch=3, device="cpu")
    # the CPU run also checks the planes' ids on the host (numpy)
    assert [o.op for o in meta.ops] == [o.op for o in cpu.ops
                                        if o.op != "aten::detach"]
    assert meta.peak_bytes == cpu.peak_bytes > meta.input_bytes > 0
    assert COST.op_cost(meta.ops) == COST.op_cost(cpu.ops)


def test_roofline_terms():
    """The reference's ``as_dict`` keys; the compute term by precision."""
    t = ROOF.RooflineTerms(flops=67e9 + 495e9, hbm_bytes=3.35e9,
                           coll_bytes=450e9,
                           flops_by_rate={"fp32": 67e9, "tf32": 495e9})
    assert set(t.as_dict()) == {"flops", "hbm_bytes", "coll_bytes",
                                "compute_s", "memory_s", "collective_s",
                                "dominant"}
    assert t.compute_s == pytest.approx(2e-3)
    assert t.memory_s == pytest.approx(1e-3)
    assert t.collective_s == pytest.approx(1.0)
    assert t.dominant == "collective"
    assert t.step_time_s == pytest.approx(1.003)
    assert (t.bound_s, t.bound_by) == (pytest.approx(2e-3), "operations")
    assert ROOF.RooflineTerms(67e9, 0, 0).compute_s == pytest.approx(1e-3)
    assert ROOF.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert ROOF.bound(0, 989e9, "bf16") == (pytest.approx(1.0),
                                            "operations")
    assert ROOF.model_flops_per_step(10, 3, "train") == 180.0
    assert ROOF.model_flops_per_step(10, 3, "serve") == 60.0


def test_terms_from_divides_by_devices():
    costs = dict(flops=8e12, bytes_min=4e9, fp32_flops=2e12,
                 tf32_flops=18e12, bf16_flops=0.0)
    calls = [CollectiveCall("psum", 0, ("cuda:0",) * 2, ((10, 10),) * 2)]
    t = ROOF.terms_from(costs, calls, n_devices=2, coll_mult=3)
    assert t.flops == 4e12 and t.hbm_bytes == 2e9
    assert t.coll_bytes == 3 * 400
    assert t.compute_s == pytest.approx(1e12 / 67e12 + 9e12 / 495e12)


def test_collective_summaries():
    """Bytes per slot by the reference's kinds (per-device results: a
    gather's whole, a psum's part, a reduce-scatter's tile), counts under
    ``n_<kind>``, and confinement to the topology's groups."""
    g0, g1 = ("meta",) * 4, ("meta",) * 4
    calls = [CollectiveCall("broadcast", 0, g0, ((48, 10),)),
             CollectiveCall("all_gather", 0, g0, ((16, 10),) * 4),
             CollectiveCall("psum", 0, g0, ((48, 10, 10),) * 4),
             CollectiveCall("psum", 0, g0, ((48, 10),) * 4),
             CollectiveCall("psum_scatter", 1, g1, ((48, 10, 10),) * 4)]
    b = ROOF.collective_bytes(calls)
    assert b["broadcast"] == 1920 and b["n_broadcast"] == 1
    assert b["all-gather"] == 2560 and b["n_all-gather"] == 1
    assert b["all-reduce"] == 21120 and b["n_all-reduce"] == 2
    assert b["reduce-scatter"] == 4800 and b["n_reduce-scatter"] == 1
    assert b["all-to-all"] == 0 and b["n_collective-permute"] == 0
    ok = ROOF.collectives_confined_to_groups(calls, [(0, g0), (1, g1)])
    assert ok["n_collectives"] == 5 and ok["n_crossing"] == 0
    bad = ROOF.collectives_confined_to_groups(calls, [(0, g0)])
    assert bad["n_crossing"] == 1 and bad["crossing"][0][0] == \
        "reduce-scatter"
