"""The port's Gibbs chain and Posterior Propagation against the reference.

Numerical: the reference's key schedule is replayed with jax.random into a
noise tape (``torch_helpers.jax_chain_tape``) that the port's noise seam
consumes, so both chains see the same draws. Tolerances:
  - RMSE and per-block RMSE: 1e-4 absolute — an average over thousands of
    posterior-mean predictions, which differ only by f32 rounding;
  - final U/V: 1e-3 relative to the largest entry — a dozen sweeps of
    f32 Cholesky factor/solve rounded in other orders;
  - U_agg / V_agg: 1e-3 relative in the Frobenius norm — summaries invert
    a sample covariance of 20 kept draws in K = 8 dimensions, which
    amplifies that rounding;
  - card against CPU, U_agg / V_agg: 5e-3 — one f32 ulp at the start
    already moves them by ~1e-3 on the CPU alone, and the card rounds in
    other orders than the CPU (``test_one_ulp_...`` below);
  - bf16 sweep: 1e-3 absolute on RMSE — both chains round the factor to
    bf16, but factors that differ at 1e-5 round to different bf16 values
    now and then, so the chains drift apart at bf16 resolution.
Statistical: with the port's own generators the quickstart setting must
land within 0.05 RMSE of the reference, and both must beat the mean
predictor.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import gibbs as TG
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.data import sparse as TSP
from repro_torch.data import synthetic as TSYN
from repro_torch.noise import TapeNoise
from torch_helpers import (cuda_device, jax_chain_tape,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 8
NS, BURN = 24, 4          # 20 kept draws >= K + 4


def _fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _maxrel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mini(test_frac=0.15):
    coo, _ = TSYN.generate("mini", seed=0)
    return TSP.train_test_split(coo, test_frac, seed=1)


def _jax_mini(test_frac=0.15):
    from repro.data import sparse as JSP
    from repro.data import synthetic as JSYN
    coo, _ = JSYN.generate("mini", seed=0)
    return JSP.train_test_split(coo, test_frac, seed=1)


def _csr_np(jcsr):
    return TSP.PaddedCSR(np.array(jcsr.idx), np.array(jcsr.val),
                         np.array(jcsr.mask), jcsr.n_cols)


@pytest.mark.parametrize("kw", [dict(use_kernel=True),
                                dict(sweep_fused=True)])
def test_run_gibbs_tape_replay(kw):
    import jax
    import jax.numpy as jnp
    from repro.core import bmf as JB
    from repro.core import gibbs as JG
    from repro.data import sparse as JSP
    tr, te = _jax_mini()
    rows, cols = JSP.coo_to_padded_csr(tr), JSP.coo_to_padded_csr(
        tr.transpose())
    key = jax.random.key(3)
    res_j = JG.run_gibbs(key, rows, cols, jnp.asarray(te.row),
                         jnp.asarray(te.col),
                         JB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw))
    tape = jax_chain_tape(key, rows.n_rows, cols.n_rows, K, NS)
    res_t = TG.run_gibbs(TapeNoise([tape], "cpu"), _csr_np(rows),
                         _csr_np(cols), te.row, te.col,
                         TB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw),
                         device="cpu")
    rmse_j = float(JG.rmse_from_acc(res_j.acc, jnp.asarray(te.val)))
    rmse_t = float(TG.rmse_from_acc(res_t.acc, te.val))
    assert abs(rmse_t - rmse_j) < 1e-4
    assert _maxrel(res_t.U, res_j.U) < 1e-3
    assert _maxrel(res_t.V, res_j.V) < 1e-3
    assert _fro(res_t.U_post.Lambda, res_j.U_post.Lambda) < 1e-3
    assert _fro(res_t.V_post.eta, res_j.V_post.eta) < 1e-3
    assert bool(res_t.health) and bool(res_j.health)


def test_run_gibbs_stacked_with_prior_flags_tape_replay():
    """Two blocks in one batch, with propagated priors and per-block
    prior-use flags (block 0 uses the fixed U prior, block 1 resamples
    it): each block equals the reference's stacked chain."""
    import jax
    import jax.numpy as jnp
    from repro.core import bmf as JB
    from repro.core import gibbs as JG
    from repro.core import posterior as JP
    from repro.data import sparse as JSP
    tr, te = _jax_mini()
    rows, cols = JSP.coo_to_padded_csr(tr), JSP.coo_to_padded_csr(
        tr.transpose())
    N, D = rows.n_rows, cols.n_rows
    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, N, K, K)).astype(np.float32) * 0.3
    lam = np.einsum("bnij,bnkj->bnik", A, A) + 2 * np.eye(K, dtype=np.float32)
    eta = rng.normal(size=(2, N, K)).astype(np.float32)
    stack = lambda x: jnp.stack([x, x])                  # noqa: E731
    keys = jax.random.split(jax.random.key(7), 2)
    cfg = dict(K=K, n_samples=NS, burnin=BURN, sweep_fused=True)
    use = np.array([1.0, 0.0], np.float32)
    res_j = JG.run_gibbs_stacked(
        keys, JSP.PaddedCSR(*(stack(x) for x in (rows.idx, rows.val,
                                                 rows.mask)), rows.n_cols),
        JSP.PaddedCSR(*(stack(x) for x in (cols.idx, cols.val, cols.mask)),
                      cols.n_cols),
        stack(jnp.asarray(te.row)), stack(jnp.asarray(te.col)),
        JB.BMFConfig(**cfg),
        U_prior=JP.RowGaussians(jnp.asarray(eta), jnp.asarray(lam)),
        V_prior=JP.RowGaussians(jnp.zeros((2, D, K)),
                                jnp.broadcast_to(jnp.eye(K), (2, D, K, K))),
        prior_use=(jnp.asarray(use), jnp.zeros(2)))
    tapes = [jax_chain_tape(keys[b], N, D, K, NS) for b in range(2)]
    r, c = _csr_np(rows), _csr_np(cols)
    st = lambda x: np.stack([x, x])                      # noqa: E731
    res_t = TG.run_gibbs_stacked(
        TapeNoise(tapes, "cpu"),
        TSP.PaddedCSR(st(r.idx), st(r.val), st(r.mask), r.n_cols),
        TSP.PaddedCSR(st(c.idx), st(c.val), st(c.mask), c.n_cols),
        st(te.row), st(te.col), TB.BMFConfig(**cfg),
        U_prior=TG.RowGaussians(torch.from_numpy(eta), torch.from_numpy(lam)),
        V_prior=TG.RowGaussians(torch.zeros((2, D, K)),
                                torch.eye(K).expand(2, D, K, K)),
        prior_use=(use, np.zeros(2, np.float32)), device="cpu")
    for b in range(2):
        assert _maxrel(res_t.U[b], res_j.U[b]) < 1e-3
        assert _maxrel(res_t.acc.pred_sum[b], res_j.acc.pred_sum[b]) < 1e-4
        assert _fro(res_t.U_post.Lambda[b], res_j.U_post.Lambda[b]) < 1e-3


def test_run_gibbs_bf16_tape_replay():
    import jax
    import jax.numpy as jnp
    from repro.core import bmf as JB
    from repro.core import gibbs as JG
    from repro.data import sparse as JSP
    tr, te = _jax_mini()
    rows, cols = JSP.coo_to_padded_csr(tr), JSP.coo_to_padded_csr(
        tr.transpose())
    cfg = dict(K=K, n_samples=14, burnin=2, sweep_fused=True,
               sweep_dtype="bf16")
    key = jax.random.key(3)
    res_j = JG.run_gibbs(key, rows, cols, jnp.asarray(te.row),
                         jnp.asarray(te.col), JB.BMFConfig(**cfg))
    tape = jax_chain_tape(key, rows.n_rows, cols.n_rows, K, 14)
    res_t = TG.run_gibbs(TapeNoise([tape], "cpu"), _csr_np(rows),
                         _csr_np(cols), te.row, te.col, TB.BMFConfig(**cfg),
                         device="cpu")
    rmse_j = float(JG.rmse_from_acc(res_j.acc, jnp.asarray(te.val)))
    rmse_t = float(TG.rmse_from_acc(res_t.acc, te.val))
    assert abs(rmse_t - rmse_j) < 1e-3


@pytest.mark.parametrize("kw", [dict(use_kernel=True),
                                dict(sweep_fused=True)])
def test_run_pp_tape_replay_serial_and_stacked(kw):
    """mini 2×2 (phases a, b_row, b_col, c): the port's serial and stacked
    runs both match the reference's run_pp block by block."""
    import jax
    from repro.core import bmf as JB
    from repro.core import partition as JPA
    from repro.core import pp as JPP
    jtr, jte = _jax_mini()
    tr, te = _mini()
    jpart, part = JPA.partition(jtr, 2, 2), TPA.partition(tr, 2, 2)
    res_j = JPP.run_pp(jax.random.key(5), jpart,
                       JB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw),
                       jte, executor="stacked")
    keys = jax.random.split(jax.random.key(5), 4).reshape(2, 2)
    shapes = TPP.BlockShapes.per_phase(
        part, TSP.apply_permutation(te, part.row_perm, part.col_perm))
    tapes = {(b.i, b.j): jax_chain_tape(keys[b.i, b.j],
                                        shapes[b.phase].n_rows,
                                        shapes[b.phase].n_cols, K, NS)
             for b in part.all_blocks()}
    noise = lambda blocks: TapeNoise([tapes[c] for c, _ in blocks], "cpu")  # noqa: E731
    for executor in ("serial", "stacked"):
        res_t = TPP.run_pp(5, part, TB.BMFConfig(K=K, n_samples=NS,
                                                 burnin=BURN, **kw),
                           te, executor=executor, device="cpu", noise=noise)
        assert res_t.executor == executor
        assert abs(res_t.rmse - res_j.rmse) < 1e-4
        np.testing.assert_allclose(res_t.per_block_rmse, res_j.per_block_rmse,
                                   atol=1e-4)
        assert res_t.n_test == res_j.n_test
        for t, j in ((res_t.U_agg, res_j.U_agg), (res_t.V_agg, res_j.V_agg)):
            assert _fro(t.eta, j.eta) < 1e-3
            assert _fro(t.Lambda, j.Lambda) < 1e-3
        np.testing.assert_array_equal(res_t.row_perm, res_j.row_perm)
        assert (res_t.tau, res_t.K) == (res_j.tau, res_j.K)
        assert set(res_t.phase_times_s) == set(res_j.phase_times_s)
        assert res_t.faults == []


def test_quickstart_statistical_gate():
    """The quickstart setting with the port's own generators: within 0.05
    RMSE of the reference, both below the mean predictor; the serial and
    stacked executors agree block by block (same per-block seeds)."""
    import jax
    from repro.core import bmf as JB
    from repro.core import partition as JPA
    from repro.core import pp as JPP
    jtr, jte = _jax_mini()
    tr, te = _mini()
    cfg = dict(K=K, n_samples=50, burnin=20)
    res_j = JPP.run_pp(jax.random.key(1), JPA.partition(jtr, 2, 2),
                       JB.BMFConfig(**cfg), jte, executor="stacked")
    part = TPA.partition(tr, 2, 2)
    res_s = TPP.run_pp(1, part, TB.BMFConfig(**cfg), te, executor="stacked",
                       device="cpu")
    res_1 = TPP.run_pp(1, part, TB.BMFConfig(**cfg), te, executor="serial",
                       device="cpu")
    mean_rmse = float(np.sqrt(np.mean((te.val - tr.val.mean()) ** 2)))
    assert res_s.rmse < mean_rmse and res_j.rmse < mean_rmse
    assert abs(res_s.rmse - res_j.rmse) < 0.05
    np.testing.assert_allclose(res_1.per_block_rmse, res_s.per_block_rmse,
                               atol=1e-4)
    assert _fro(res_1.U_agg.Lambda, res_s.U_agg.Lambda) < 1e-3
    rmse_full, _, _ = TPP.run_full_bmf(0, tr, te, TB.BMFConfig(**cfg),
                                       device="cpu")
    assert rmse_full < mean_rmse


def test_health_guard_retries_a_nan_chain():
    """A block whose first attempt draws NaN noise fails the health guard
    and is re-run with attempt 1's fresh seed; the run stays finite and
    the fault ledger records the retry."""
    from repro_torch.noise import GeneratorNoise, block_seed

    class PoisonFirstAttempt(GeneratorNoise):
        def factor(self, sweep, f, n, K):
            z = super().factor(sweep, f, n, K)
            if self.poison:
                z[:] = float("nan")
            return z

    def noise(blocks):
        src = PoisonFirstAttempt([block_seed(2, *c, a) for c, a in blocks],
                                 "cpu")
        src.poison = any(c == (1, 1) and a == 0 for c, a in blocks)
        return src

    tr, te = _mini()
    part = TPA.partition(tr, 2, 2)
    cfg = TB.BMFConfig(K=K, n_samples=8, burnin=2, sweep_fused=True)
    res = TPP.run_pp(2, part, cfg, te, executor="serial", device="cpu",
                     noise=noise)
    assert np.isfinite(res.rmse)
    assert [(f.coord, f.kind, f.action) for f in res.faults] == \
        [((1, 1), "nonfinite", "retried")]
    assert bool(torch.isfinite(res.U_agg.Lambda).all())
    with pytest.raises(TENG.BlockFaultError):
        TPP.run_pp(2, part, cfg, te, executor="stacked", device="cpu",
                   noise=noise, max_retries=0)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    tr, te = _mini()
    part = TPA.partition(tr, 2, 2)
    cfg = TB.BMFConfig(K=K, n_samples=2, burnin=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        TPP.run_pp(0, part, cfg, te)
    with pytest.raises(RuntimeError, match="GPU"):
        TPP.run_full_bmf(0, tr, te, cfg)


@pytest.mark.parametrize("kw,err", [
    (dict(executor="sharded", comm="ring"), ValueError),
    (dict(executor="bogus"), ValueError),
    (dict(executor="stacked", topology=(2, 2)), ValueError),
    (dict(distributed_mesh=2, topology=(1, 2)), ValueError),
    (dict(executor="stacked", block_mesh=("cpu",)), ValueError),
    (dict(window=0, executor="streaming"), ValueError),
    (dict(window=2, executor=TENG.StreamingExecutor()), ValueError),
    (dict(on_fault="ignore"), ValueError)])
def test_run_pp_rejects_what_is_not_ported(kw, err):
    tr, te = _mini()
    part = TPA.partition(tr, 2, 2)
    with pytest.raises(err):
        TPP.run_pp(0, part, TB.BMFConfig(K=K, n_samples=2, burnin=1), te,
                   device="cpu", **kw)


def test_bmf_train_cli_on_cpu(capsys):
    from repro_torch.launch import bmf_train
    res = bmf_train.main(["--dataset", "mini", "--blocks", "4", "--samples",
                          "4", "--fused-sweep", "--executor", "serial",
                          "--device", "cpu"])
    assert np.isfinite(res.rmse) and res.executor == "serial"
    assert "RMSE=" in capsys.readouterr().out


def _numpy_tape(rng, N, D, n_samples):
    """A tape of numpy draws with the reference schedule's keys."""
    tape = {("init", "U"): rng.normal(size=(N, K)),
            ("init", "V"): rng.normal(size=(D, K))}
    for i in range(n_samples):
        for f, n in (("U", N), ("V", D)):
            tape[("hyper", i, f)] = (rng.chisquare(K + n - np.arange(K)),
                                     rng.normal(size=(K, K)),
                                     rng.normal(size=K))
            tape[("z", i, f)] = rng.normal(size=(n, K))
    return tape


def _mini_pp_tapes():
    """mini 2×2 and one numpy tape per block, sized to its phase bucket."""
    tr, te = _mini()
    part = TPA.partition(tr, 2, 2)
    shapes = TPP.BlockShapes.per_phase(
        part, TSP.apply_permutation(te, part.row_perm, part.col_perm))
    rng = np.random.default_rng(0)
    tapes = {(b.i, b.j): _numpy_tape(rng, shapes[b.phase].n_rows,
                                     shapes[b.phase].n_cols, NS)
             for b in part.all_blocks()}
    return te, part, tapes


def _tape_pp(part, te, tapes, kw, dev):
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw)
    return TPP.run_pp(5, part, cfg, te, executor="stacked", device=dev,
                      noise=lambda blocks: TapeNoise(
                          [tapes[c] for c, _ in blocks], dev))


def _pp_gaps(res, ref):
    """RMSE, per-block RMSE and aggregate gaps of one PP run to another."""
    err = dict(rmse=abs(res.rmse - ref.rmse),
               block=float(np.abs(res.per_block_rmse
                                  - ref.per_block_rmse).max()))
    for f in ("U_agg", "V_agg"):
        for g in ("eta", "Lambda"):
            err[f"{f}.{g}"] = _fro(getattr(getattr(res, f), g).cpu(),
                                   getattr(getattr(ref, f), g))
    return err


def _ulp_nudge(tape, rng):
    """The tape with each starting factor entry moved by one f32 ulp, up
    or down at random."""
    out = dict(tape)
    for k in (("init", "U"), ("init", "V")):
        x = tape[k].astype(np.float32)
        sign = rng.choice(np.array([-1, 1], np.float32), x.shape)
        out[k] = x * (1 + np.float32(2.0 ** -23) * sign)
    return out


def test_one_ulp_at_the_start_moves_the_aggregates_not_the_rmse():
    """The chain's own sensitivity, on the CPU: the same tapes with the
    starting factors moved by one f32 ulp. The RMSE stays within the 1e-4
    that the tape-replay tests allow; the aggregates move by ~1e-3 (V_agg
    0.8-1.1e-3 over two nudges), because 24 sweeps carry the difference
    into every kept draw and the summaries invert a 20-draw sample
    covariance. Two devices that round differently see such a gap, and
    the card-vs-CPU limit below rests on it."""
    te, part, tapes = _mini_pp_tapes()
    ref = _tape_pp(part, te, tapes, {}, "cpu")
    worst = 0.0
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        nudged = {c: _ulp_nudge(t, rng) for c, t in tapes.items()}
        err = _pp_gaps(_tape_pp(part, te, nudged, {}, "cpu"), ref)
        print(f"[ulp gap] seed {seed} {json.dumps(err)}")
        assert err["rmse"] < 1e-4 and err["block"] < 1e-4, err
        worst = max(worst, *(v for k, v in err.items() if "agg" in k))
    assert 1e-4 < worst < 2.5e-3, worst


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(use_kernel=True),
                                dict(sweep_fused=True)])
def test_cuda_pp_matches_cpu_pp(cuda_device, kw):
    """The whole PP run on the card against the same run on the CPU (plain
    versions), both fed one numpy tape per block; the factor step in plain
    torch, through B1 and through B2. Prints the gaps (``-s``)."""
    te, part, tapes = _mini_pp_tapes()
    err = _pp_gaps(_tape_pp(part, te, tapes, kw, cuda_device),
                   _tape_pp(part, te, tapes, kw, "cpu"))
    print(f"[pp gap] {kw} {json.dumps(err)}")
    assert err["rmse"] < 1e-4 and err["block"] < 1e-4, err
    # aggregates at 5e-3, about five times what one ulp at the start moves
    # them on the CPU alone (test above: up to 1.1e-3): the card rounds
    # every factor step in other orders than the CPU (V_agg measured at
    # 0.8-1.4e-3 on an H100)
    assert max(v for k, v in err.items() if "agg" in k) < 5e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(use_kernel=True),
                                dict(sweep_fused=True)])
def test_cuda_chain_gap_by_layer(cuda_device, kw):
    """Where one chain on the card leaves the same chain on the CPU (one
    numpy tape, the whole mini matrix): the factor gap after one sweep and
    after NS sweeps, the gap of the kept-draw accumulators, of the
    summarized posteriors, and of ``_summarize`` alone on the CPU chain's
    accumulators. Prints the gaps (``-s``)."""
    tr, te = _mini()
    rows = TSP.coo_to_padded_csr(tr, as_numpy=True)
    cols = TSP.coo_to_padded_csr(tr.transpose(), as_numpy=True)
    tape = _numpy_tape(np.random.default_rng(0), rows.n_rows, cols.n_rows,
                       NS)
    runs = {}
    for dev in ("cpu", cuda_device):
        for ns, burn in ((1, 0), (NS, BURN)):
            cfg = TB.BMFConfig(K=K, n_samples=ns, burnin=burn, **kw)
            runs[str(dev), ns] = TG.run_gibbs(
                TapeNoise([tape], dev), rows, cols, te.row, te.col, cfg,
                device=dev)
    cpu = lambda ns: runs["cpu", ns]                      # noqa: E731
    gpu = lambda ns: TG.tree_map(                         # noqa: E731
        lambda x: x.cpu(), runs[str(cuda_device), ns])
    acc = cpu(NS).acc
    cnt = torch.clamp(acc.pred_cnt, min=1.0)
    alone = TG._summarize(acc.V_sum.to(cuda_device),
                          acc.V_outer.to(cuda_device), cnt.to(cuda_device))
    err = dict(
        U_sweep1=_maxrel(gpu(1).U, cpu(1).U),
        V_sweep1=_maxrel(gpu(1).V, cpu(1).V),
        U_final=_maxrel(gpu(NS).U, cpu(NS).U),
        V_final=_maxrel(gpu(NS).V, cpu(NS).V),
        V_outer=_fro(gpu(NS).acc.V_outer, acc.V_outer),
        V_post=_fro(gpu(NS).V_post.Lambda, cpu(NS).V_post.Lambda),
        summarize_alone=_fro(alone.Lambda.cpu(), cpu(NS).V_post.Lambda))
    print(f"[chain gap] {kw} {json.dumps(err)}")
    # one sweep and the summary alone stay at rounding level (H100: up to
    # 5.4e-7 and 1.8e-6): no single layer on the card accounts for the
    # ~1e-3 of the posteriors (H100: 4.8-8.4e-4, from accumulators 1.5e-5
    # apart), which the chain builds from rounding as a one-ulp nudge does
    # on the CPU
    assert max(err["U_sweep1"], err["V_sweep1"]) < 1e-5, err
    assert err["summarize_alone"] < 1e-5, err
    assert err["V_post"] < 5e-3, err


@pytest.mark.parametrize("executor", sorted(TENG.EXECUTORS))
def test_executor_trace_is_dependency_safe_and_reruns_bitwise(executor):
    """No block is dispatched before the blocks it depends on resolved, and
    a rerun with the same seed reproduces the run bit for bit."""
    tr, te = _mini()
    part = TPA.partition(tr, 3, 2)
    cfg = TB.BMFConfig(K=K, n_samples=4, burnin=1, sweep_fused=True)
    runs = []
    for _ in range(2):
        ex = TENG.EXECUTORS[executor](record_trace=True)
        runs.append((TPP.run_pp(4, part, cfg, te, executor=ex,
                                device="cpu"), ex.trace))
    (res, trace), (res2, _) = runs
    deps = {t.coord: t.deps for _, ts in TENG.build_phase_graph(part)
            for t in ts}
    resolved = set()
    for event, coord, *_ in trace:     # overlapped executors add the group
        if event == "dispatch":
            assert set(deps[coord]) <= resolved, (coord, trace)
        else:
            resolved.add(coord)
    assert resolved == set(deps)
    assert res.rmse == res2.rmse
    torch.testing.assert_close(res.U_agg.Lambda, res2.U_agg.Lambda,
                               rtol=0, atol=0)
