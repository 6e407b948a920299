"""Gibbs sampler for BMF (port of ``repro.core.gibbs``).

One sweep:
  1. (optional) resample NW hyperparameters for U and V given current factors
  2. sample all rows of U | V  (parallel across rows)
  3. sample all rows of V | U

Running accumulators (post-burn-in): predictive sums on the test entries
(for RMSE of the posterior-mean predictor), factor means and outer-product
sums (for Posterior Propagation summarization).

The reference's ``fori_loop`` is a Python loop over sweeps here, and its
``vmap`` over blocks a leading block axis B that every tensor of the chain
carries: ``_run_gibbs_impl`` always runs a batch, the kernels take the
batch directly, ``run_gibbs`` is a batch of one. Random draws come from a
noise source addressed by (sweep, factor) (``repro_torch.noise``), so
block b of a stacked chain reproduces ``run_gibbs`` on block b alone.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import posterior as POST
from repro_torch.core.posterior import RowGaussians
from repro_torch.data.sparse import COO, PaddedCSR, coo_to_padded_csr, row_live
from repro_torch.noise import GeneratorNoise


class GibbsAccumulators(NamedTuple):
    pred_sum: torch.Tensor     # (…, n_test) sum over kept samples of u·v
    pred_cnt: torch.Tensor     # (…) kept-sample count
    U_sum: torch.Tensor        # (…, N, K)
    U_outer: torch.Tensor      # (…, N, K, K)
    V_sum: torch.Tensor        # (…, D, K)
    V_outer: torch.Tensor      # (…, D, K, K)


class GibbsResult(NamedTuple):
    U: torch.Tensor
    V: torch.Tensor
    acc: GibbsAccumulators
    U_post: RowGaussians       # summarized per-row posteriors
    V_post: RowGaussians
    # chain-health flag (bool; (B,) for a stacked chain): every final
    # factor, summarized posterior and predictive sum is finite
    health: Optional[torch.Tensor] = None


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, PaddedCSR):
        yield from (tree.idx, tree.val, tree.mask)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a (nested) NamedTuple/tuple or
    PaddedCSR."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, PaddedCSR):
        return PaddedCSR(fn(tree.idx), fn(tree.val), fn(tree.mask),
                         tree.n_cols)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return tree


def chain_health(*trees, batch_dims: int = 0) -> torch.Tensor:
    """All-finite reduction over every tensor of ``trees``, keeping the
    first ``batch_dims`` axes (one flag per block of a stacked chain)."""
    ok = None
    for leaf in _leaves(trees):
        f = torch.isfinite(leaf).reshape(leaf.shape[:batch_dims] + (-1,))
        f = f.all(-1)
        ok = f if ok is None else ok & f
    return ok


def _summarize(sum_, outer, cnt, ridge=1e-4):
    """Per-row Gaussian of the kept draws: moments -> natural params.
    ``cnt`` has the batch shape of ``sum_`` without its (N, K) axes."""
    c = cnt.reshape(cnt.shape + (1, 1))
    mean = sum_ / c
    cov = outer / c[..., None] - mean[..., :, None] * mean[..., None, :]
    K = mean.shape[-1]
    # relative ridge: scaled by the row's largest diagonal and floored at
    # the absolute value, so O(1)-scale rows see exactly 1e-4 while a row
    # whose variances sit at 1e4 still gets a nudge that keeps it PD
    mag = torch.diagonal(cov, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
    row_ridge = ridge * torch.clamp(mag, min=1.0)                 # (…, N, 1)
    cov = cov + row_ridge[..., None] * torch.eye(K, dtype=cov.dtype,
                                                 device=cov.device)
    return POST.from_moments_cov(mean, cov, ridge=0.0)


def as_noise(noise, batch: int, device):
    """A noise source for ``batch`` blocks: an int seed (batch of one), a
    sequence of per-block seeds, or a ready source."""
    if isinstance(noise, (int, np.integer)):
        noise = [int(noise)]
    if isinstance(noise, (list, tuple)):
        noise = GeneratorNoise(noise, device)
    if noise.batch != batch:
        raise ValueError(f"noise source serves {noise.batch} block(s), "
                         f"the chain runs {batch}")
    return noise


def _to(x, dev, dtype=None):
    return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)


def _csr_to(csr: PaddedCSR, dev) -> PaddedCSR:
    return PaddedCSR(idx=_to(csr.idx, dev, torch.int32),
                     val=_to(csr.val, dev, torch.float32),
                     mask=_to(csr.mask, dev, torch.float32),
                     n_cols=csr.n_cols)


def _prior_to(p: Optional[RowGaussians], dev) -> Optional[RowGaussians]:
    return None if p is None else RowGaussians(
        eta=_to(p.eta, dev, torch.float32),
        Lambda=_to(p.Lambda, dev, torch.float32))


def _check_indices(csr: PaddedCSR, n_other: int):
    """Every slot must gather a row of the other factor: the kernels read
    ``other[idx]`` without bounds checks. Planes given on the host (numpy
    or a CPU tensor) are checked here, before they move; planes already
    on the card were checked where the port built them on the host
    (``data.sparse.padded_csr_host``), so a chain never reads its ids
    back from the device (which would block the host until the card's
    queue drained)."""
    idx = csr.idx
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            return
        idx = idx.numpy()
    idx = np.asarray(idx)
    if idx.size and not (int(idx.min()) >= 0 and int(idx.max()) < n_other):
        raise ValueError(f"CSR column ids outside [0, {n_other})")


def run_gibbs(noise,
              csr_rows: PaddedCSR,      # R rows:    users x items
              csr_cols: PaddedCSR,      # R^T rows:  items x users
              test_rows,                # (n_test,) user ids
              test_cols,                # (n_test,) item ids
              cfg: BMF.BMFConfig,
              U_prior: Optional[RowGaussians] = None,
              V_prior: Optional[RowGaussians] = None,
              U0=None, V0=None, device=None) -> GibbsResult:
    """Run cfg.n_samples sweeps (cfg.burnin of them discarded) on one
    block. ``noise``: an int seed or a noise source of batch 1.

    U_prior / V_prior: propagated per-row priors (PP phases b/c). When None,
    the factor gets the NW hierarchical prior resampled each sweep."""
    dev = resolve_device(device)
    _check_indices(csr_rows, csr_cols.n_rows)
    _check_indices(csr_cols, csr_rows.n_rows)
    one = lambda t: tree_map(lambda x: x[None], t)   # noqa: E731
    rows, cols = one(_csr_to(csr_rows, dev)), one(_csr_to(csr_cols, dev))
    noise = as_noise(noise, 1, dev)
    N, D, K = rows.n_rows, cols.n_rows, cfg.K
    U0_, V0_ = (BMF.init_factors(noise, N, D, K)
                if U0 is None or V0 is None else (None, None))
    U0 = U0_ if U0 is None else _to(U0, dev, torch.float32)[None]
    V0 = V0_ if V0 is None else _to(V0, dev, torch.float32)[None]
    res = _run_gibbs_impl(noise, rows, cols,
                          _to(test_rows, dev)[None], _to(test_cols, dev)[None],
                          cfg, cfg.n_samples, cfg.burnin,
                          one(_prior_to(U_prior, dev)),
                          one(_prior_to(V_prior, dev)), U0, V0)
    return tree_map(lambda x: x[0], res)


def run_gibbs_stacked(noise,
                      csr_rows: PaddedCSR,      # (B, N, M) planes
                      csr_cols: PaddedCSR,      # (B, D, M_c) planes
                      test_rows,                # (B, n_test)
                      test_cols,                # (B, n_test)
                      cfg: BMF.BMFConfig,
                      U_prior: Optional[RowGaussians] = None,
                      V_prior: Optional[RowGaussians] = None,
                      prior_use: Optional[Sequence] = None,
                      device=None) -> GibbsResult:
    """Batched analogue of ``run_gibbs``: B identically-shaped blocks'
    chains at once. ``noise``: a sequence of B per-block seeds or a noise
    source of batch B; block b of the result reproduces ``run_gibbs`` with
    block b's seed.

    ``prior_use``: optional ``(u_use, v_use)`` per-block {0,1} flags (B,).
    With flags, ``U_prior``/``V_prior`` are full (B, …) tensors and block b
    uses the fixed prior where its flag is 1 and the resampled NW
    hyperprior where it is 0."""
    dev = resolve_device(device)
    _check_indices(csr_rows, csr_cols.n_rows)
    _check_indices(csr_cols, csr_rows.n_rows)
    rows, cols = _csr_to(csr_rows, dev), _csr_to(csr_cols, dev)
    B, N, D, K = rows.idx.shape[0], rows.n_rows, cols.n_rows, cfg.K
    noise = as_noise(noise, B, dev)
    U0, V0 = BMF.init_factors(noise, N, D, K)
    u_use, v_use = (None, None) if prior_use is None else (
        _to(prior_use[0], dev), _to(prior_use[1], dev))
    return _run_gibbs_impl(noise, rows, cols, _to(test_rows, dev),
                           _to(test_cols, dev), cfg, cfg.n_samples,
                           cfg.burnin, _prior_to(U_prior, dev),
                           _prior_to(V_prior, dev), U0, V0, u_use, v_use)


def default_sampler(cfg: BMF.BMFConfig, live):
    """The single-device factor step ``sampler(z, csr, other, prior,
    sweep)``: ``bmf.sample_factor``, or the fused sweep (kernel B2) under
    ``cfg.sweep_fused``; ``live`` holds the planes' per-row live
    lengths."""
    if cfg.sweep_fused:
        from repro_torch.kernels.bmf_sweep import ops as SWEEP
        return lambda z, csr, other, prior, sweep: SWEEP.sample_factor_fused(
            z, csr, other, cfg.tau, prior, dtype=cfg.sweep_dtype, live=live)
    return lambda z, csr, other, prior, sweep: BMF.sample_factor(
        z, csr, other, cfg.tau, prior, cfg.use_kernel, live=live)


def pick_prior(noise, nw, fixed, use, sweep_i, f, X, n, K):
    """Prior for one factor at sweep ``sweep_i``: the fixed prior, the
    resampled NW hyperprior, or per block one of the two by its ``use``
    flag."""
    if fixed is not None and use is None:
        return fixed
    chi2, lower, z = noise.hyper(sweep_i, f, float(K + n), K)
    mu, Lam = BMF.sample_hyper_noise(X, nw, chi2, lower, z)
    hier = POST.broadcast_prior(mu, Lam, n)
    if fixed is None:
        return hier
    flag = use.to(torch.bool)
    return RowGaussians(
        eta=torch.where(flag[:, None, None], fixed.eta, hier.eta),
        Lambda=torch.where(flag[:, None, None, None], fixed.Lambda,
                           hier.Lambda))


def sweep(noise, nw, i, U, V, csr_rows, csr_cols, N, D, K, U_prior, V_prior,
          u_use, v_use, u_sampler, v_sampler):
    """Sweep ``i`` of a chain: the two priors, then the U-step and the
    V-step; returns the new (U, V). The chain body's loop, and one sweep
    alone for a dry run's plan (``launch.bmf_dryrun.lower_sweep``)."""
    u_prior = pick_prior(noise, nw, U_prior, u_use, i, "U", U, N, K)
    v_prior = pick_prior(noise, nw, V_prior, v_use, i, "V", V, D, K)
    U = u_sampler(noise.factor(i, "U", N, K), csr_rows, V, u_prior, i)
    V = v_sampler(noise.factor(i, "V", D, K), csr_cols, U, v_prior, i)
    return U, V


def _run_gibbs_impl(noise, csr_rows, csr_cols, test_rows, test_cols, cfg,
                    n_samples, burnin, U_prior, V_prior, U0, V0,
                    u_use=None, v_use=None,
                    u_sampler=None, v_sampler=None,
                    n_rows=None, n_cols=None) -> GibbsResult:
    """Chain body shared by every executor path; every tensor carries the
    leading block axis B.

    ``u_sampler`` / ``v_sampler`` are the factor-step seams:
    ``sampler(z, csr, other, prior, sweep) -> factor``, defaulting to
    ``default_sampler``. The intra-block distributed chain
    (``core.distributed``) swaps in data-sharded samplers; everything else
    — noise addressing, prior selection, accumulators, summaries — is this
    code, so the composed chains share its semantics by construction.
    ``n_rows`` / ``n_cols`` give the factor sizes when ``csr_rows`` /
    ``csr_cols`` are a sharded sampler's own planes (the carried factors
    stay whole, on U0's device)."""
    N = csr_rows.n_rows if n_rows is None else n_rows
    D = csr_cols.n_rows if n_cols is None else n_cols
    K = cfg.K
    dev = U0.device
    nw = POST.default_nw(K, device=dev)
    # per-row live lengths, once per chain: the planes never change, and
    # the kernels skip each row's all-padding tail with them
    if u_sampler is None:
        u_sampler = default_sampler(cfg, row_live(csr_rows.mask))
    if v_sampler is None:
        v_sampler = default_sampler(cfg, row_live(csr_cols.mask))

    B = U0.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    acc = GibbsAccumulators(
        pred_sum=torch.zeros(test_rows.shape, **f32),
        pred_cnt=torch.zeros((B,), **f32),
        U_sum=torch.zeros((B, N, K), **f32),
        U_outer=torch.zeros((B, N, K, K), **f32),
        V_sum=torch.zeros((B, D, K), **f32),
        V_outer=torch.zeros((B, D, K, K), **f32))

    U, V = U0, V0
    for i in range(int(n_samples)):
        U, V = sweep(noise, nw, i, U, V, csr_rows, csr_cols, N, D, K,
                     U_prior, V_prior, u_use, v_use, u_sampler, v_sampler)
        if i >= burnin:
            acc.pred_sum.add_(BMF.predict(U, V, test_rows, test_cols))
            acc.pred_cnt.add_(1.0)
            acc.U_sum.add_(U)
            acc.U_outer.addcmul_(U[..., :, None], U[..., None, :])
            acc.V_sum.add_(V)
            acc.V_outer.addcmul_(V[..., :, None], V[..., None, :])

    cnt = torch.clamp(acc.pred_cnt, min=1.0)
    U_post = _summarize(acc.U_sum, acc.U_outer, cnt)
    V_post = _summarize(acc.V_sum, acc.V_outer, cnt)
    health = chain_health(U, V, U_post, V_post, acc.pred_sum, batch_dims=1)
    return GibbsResult(U=U, V=V, acc=acc, U_post=U_post, V_post=V_post,
                       health=health)


def rmse_from_acc(acc: GibbsAccumulators, test_vals) -> torch.Tensor:
    pred = acc.pred_sum / torch.clamp(acc.pred_cnt, min=1.0)[..., None]
    test_vals = torch.as_tensor(test_vals, device=pred.device)
    return torch.sqrt(torch.mean((pred - test_vals) ** 2, dim=-1))


# ---------------------------------------------------------------------------
# static-analyzer hooks (launch.bmf_lint)
# ---------------------------------------------------------------------------


class TracedChain(NamedTuple):
    """What the analyzer needs from one run of a chain, the port's
    counterpart of the reference's lowering: every op it ran
    (``analysis.optrace.OpRecord``), every collective its group was asked
    for (``core.topology.CollectiveCall``; none on one slot) and the
    sweeps it ran, which turn collective counts into per-sweep ones;
    since the dry run (``launch.bmf_dryrun``) also the live-bytes
    high-water mark on the chain's device, its inputs included
    (``roofline.op_cost.peak_buffer_bytes``), the inputs' bytes, and the
    bytes of inputs whose storage an output reuses (the counterpart of
    XLA's aliased donations)."""
    ops: List
    collectives: List
    sweeps: int
    peak_bytes: int = 0
    input_bytes: int = 0
    alias_bytes: int = 0


class LintInputs(NamedTuple):
    """Seeded random chain inputs at lint dims, with a leading block axis
    B: planes, test ids, PD propagated priors, and each block's COO."""
    rows: PaddedCSR
    cols: PaddedCSR
    test_rows: torch.Tensor
    test_cols: torch.Tensor
    U_prior: RowGaussians
    V_prior: RowGaussians
    coos: List[COO]


def lint_block(rng: np.random.Generator, n_rows: int, n_cols: int,
               m_rows: int, m_cols: int) -> COO:
    """A random n_rows × n_cols block with at most ``m_rows`` ratings per
    row and ``m_cols`` per column (row 0 has ``m_rows``): each row draws
    distinct columns, and a column keeps its first ``m_cols`` entries."""
    m_rows = min(m_rows, n_cols)
    cols = np.argsort(rng.random((n_rows, n_cols)), axis=1)[:, :m_rows]
    cnt = rng.integers(1, m_rows + 1, n_rows)
    cnt[0] = m_rows
    keep = np.arange(m_rows)[None, :] < cnt[:, None]
    r = np.broadcast_to(np.arange(n_rows)[:, None], cols.shape)[keep]
    c = cols[keep]
    order = np.lexsort((r, c))
    r, c = r[order], c[order]
    ok = np.arange(len(c)) - np.searchsorted(c, c) < m_cols
    r, c = r[ok], c[ok]
    return COO(row=r.astype(np.int32), col=c.astype(np.int32),
               val=rng.normal(size=len(r)).astype(np.float32),
               n_rows=n_rows, n_cols=n_cols)


def lint_prior(rng: np.random.Generator, lead: Sequence[int], K: int,
               dev) -> RowGaussians:
    """Random PD row Gaussians of shape ``(*lead, K)`` / ``(*lead, K,
    K)`` on ``dev``."""
    A = rng.normal(size=(*lead, K, K)) * 0.2
    lam = np.einsum("...ij,...kj->...ik", A, A) + 1.5 * np.eye(K)
    eta = rng.normal(size=(*lead, K)) * 0.3
    return RowGaussians(*(torch.from_numpy(a.astype(np.float32)).to(dev)
                          for a in (eta, lam)))


def meta_inputs(B: int, n_rows: int, n_cols: int, m_rows: int, m_cols: int,
                n_test: int, K: int) -> LintInputs:
    """``lint_inputs``' tensors as shapes only, on the ``meta`` device:
    a dry run's plan at full size allocates nothing (random planes at the
    Netflix shape would take gigabytes of host memory). No COO."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def planes(n, mm, n_other):
        return PaddedCSR(m(B, n, mm, dtype=torch.int32), m(B, n, mm),
                         m(B, n, mm), n_cols=n_other)

    return LintInputs(
        rows=planes(n_rows, m_rows, n_cols),
        cols=planes(n_cols, m_cols, n_rows),
        test_rows=m(B, n_test, dtype=torch.int32),
        test_cols=m(B, n_test, dtype=torch.int32),
        U_prior=RowGaussians(m(B, n_rows, K), m(B, n_rows, K, K)),
        V_prior=RowGaussians(m(B, n_cols, K), m(B, n_cols, K, K)),
        coos=[])


def lint_inputs(seed: int, B: int, n_rows: int, n_cols: int, m_rows: int,
                m_cols: int, n_test: int, K: int, device) -> LintInputs:
    """B random blocks at exactly the given dims (planes (B, n_rows,
    m_rows) / (B, n_cols, m_cols)) on ``device``; on ``meta``, their
    shapes only (``meta_inputs``)."""
    if torch.device(device).type == "meta":
        return meta_inputs(B, n_rows, n_cols, m_rows, m_cols, n_test, K)
    rng = np.random.default_rng(seed)
    coos = [lint_block(rng, n_rows, n_cols, m_rows, m_cols)
            for _ in range(B)]

    def planes(cs, n, m, n_other):
        ps = [coo_to_padded_csr(c, max_nnz=m, pad_to_multiple=1,
                                n_rows_pad=n, n_cols_pad=n_other,
                                as_numpy=True) for c in cs]
        return PaddedCSR(*(torch.from_numpy(np.stack(
            [getattr(p, k) for p in ps])).to(device)
            for k in ("idx", "val", "mask")), n_cols=n_other)

    tr = rng.integers(0, n_rows, (B, n_test)).astype(np.int32)
    tc = rng.integers(0, n_cols, (B, n_test)).astype(np.int32)
    return LintInputs(
        rows=planes(coos, n_rows, m_rows, n_cols),
        cols=planes([c.transpose() for c in coos], n_cols, m_cols, n_rows),
        test_rows=torch.from_numpy(tr).to(device),
        test_cols=torch.from_numpy(tc).to(device),
        U_prior=lint_prior(rng, (B, n_rows), K, device),
        V_prior=lint_prior(rng, (B, n_cols), K, device), coos=coos)


def lint_flags(B: int, device):
    """Per-block prior-use flags (u_use, v_use) that mix the fixed and the
    resampled prior within one batch, as a streaming window chunk does."""
    b = torch.arange(B, device=device)
    return ((b % 2 == 0).float(), (b % 2 == 1).float())


def trace_chain(cfg: BMF.BMFConfig, n_rows: int, n_cols: int, m_rows: int,
                m_cols: int, n_test: int, *, batch: Optional[int] = None,
                u_prior: bool = True, v_prior: bool = True,
                prior_use: bool = False, sweeps: int = 2,
                device=None) -> TracedChain:
    """Analyzer hook (``launch.bmf_lint``): run the chain ``run_gibbs``
    (batch=None) or ``run_gibbs_stacked`` (batch=B) dispatches once, at
    these block dims, on seeded random planes, under the op and collective
    recorders — where the reference traces the executable at abstract
    shapes, the port runs it and records what ran. ``prior_use`` adds the
    streaming executor's per-block prior-use flags (stacked only, both
    priors given). ``sweeps`` sweeps run, the last one kept. There is no
    ``donate``: the window's slot reuse is the ``reuse`` artifact's.
    On ``device="meta"`` the inputs are shapes only (``meta_inputs``) and
    the kernels record their launches without computing (a dry run's
    plan)."""
    dev = resolve_device(device)
    B = 1 if batch is None else int(batch)
    inp = lint_inputs(0, B, n_rows, n_cols, m_rows, m_cols, n_test, cfg.K,
                      dev)
    cfg = cfg._replace(n_samples=sweeps, burnin=sweeps - 1,
                       phase_bc_samples=None)
    up = inp.U_prior if (u_prior or prior_use) else None
    vp = inp.V_prior if (v_prior or prior_use) else None
    if batch is None:
        one = lambda t: tree_map(lambda x: x[0], t)   # noqa: E731
        args = (0, one(inp.rows), one(inp.cols), inp.test_rows[0],
                inp.test_cols[0], cfg, one(up), one(vp))
        run, kw = run_gibbs, {}
    else:
        args = (list(range(B)), inp.rows, inp.cols,
                inp.test_rows, inp.test_cols, cfg, up, vp)
        run = run_gibbs_stacked
        kw = dict(prior_use=lint_flags(B, dev) if prior_use else None)
    return traced_run(run, args, dict(kw, device=dev), sweeps, dev)


def traced_run(run, args, kw, sweeps: int, dev) -> TracedChain:
    """``run(*args, **kw)`` once under the op and collective recorders:
    what it ran, its collectives, its live-bytes high-water mark on
    ``dev`` (the tensors in ``args`` and ``kw`` counted as live
    throughout) and the bytes of those inputs whose storage the result
    reuses."""
    from repro_torch.analysis import optrace as OPT
    from repro_torch.core.topology import record_collectives
    from repro_torch.roofline import op_cost as COST
    inputs = list(_leaves((args, tuple(kw.values()))))
    with OPT.record() as tr, record_collectives() as calls:
        out = run(*args, **kw)
    dev = torch.device(dev).type
    return TracedChain(
        ops=tr.ops, collectives=calls, sweeps=sweeps,
        peak_bytes=COST.peak_buffer_bytes(tr, inputs, device=dev),
        input_bytes=COST.storage_bytes(inputs, device=dev),
        alias_bytes=COST.alias_bytes(inputs, _leaves(out), device=dev))
