"""Distributed BMF within one block (port of ``repro.core.distributed``).

The paper's Fig. 2 communication pattern, single-controller: one process
drives a group's 'data' shard slots (``core.topology.Group``), each a
(device, stream) pair.

  - the block's users (rows of U) and their ratings are split over the
    shards: shard s owns padded rows [s·N_loc, (s+1)·N_loc), in a
    contiguous buffer of its own (B1 and B2 gather from 16-byte aligned
    factors, and a row slice of U at an odd N_loc would not be one);
  - U-step: each shard samples its rows against the replicated V with
    the SLICE of the single-device noise draw, then ``all_gather`` —
    every comm mode shares it, and the gathered U is the single-device
    sample row for row;
  - V-step, by ``comm`` (``COMM_MODES``):
      'gather'  the V-step runs replicated on the whole U, so the chain is
                the single-device chain (``gibbs.run_gibbs``);
      'psum'    each shard's partial item statistics (τ Σ u uᵀ, τ Σ r u)
                from its transposed planes, one ``psum`` (a sum in fixed
                shard order), V sampled once from the single-device draw;
      'scatter' ``psum_scatter`` of the statistics, each shard samples its
                D_pad/S item rows from its own draw (the reference's
                ``fold_in(kv, s)``, ``noise.factor(..., shard=s)``), then
                ``all_gather``.
    The V-step stays unfused under ``cfg.sweep_fused``: the reduction
    splits the Λ/η accumulate from the sample, so there is no one pass to
    fuse; its accumulate is kernel B1 (``item_stats_local``).

Communication per sweep is ``sweep_comm_bytes{,_scatter}``, independent of
the number of ratings: the paper's "limited communication". The samplers
plug into the shared chain body (``gibbs._run_gibbs_impl``), so key
handling, priors, accumulators and summaries are the single-device code.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bmf as BMF
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import posterior as POST
from repro_torch.core.posterior import RowGaussians
from repro_torch.core.topology import Group, Topology
from repro_torch.data.sparse import COO, PaddedCSR, row_live

#: intra-block communication modes of the composed chains (module
#: docstring); comm bytes per sweep: 'gather' N·K floats, 'psum'
#: D·(K²+K) more, 'scatter' about half of psum's plus D·K.
COMM_MODES = ("gather", "psum", "scatter")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``n``."""
    pad = n - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def pad_csr_for_mesh(csr: PaddedCSR, n_shards: int) -> PaddedCSR:
    """Planes (…, N, M) padded with empty rows to a multiple of
    ``n_shards``."""
    n = _ceil_to(csr.idx.shape[-2], n_shards)
    return PaddedCSR(*(_pad_rows(torch.as_tensor(x), n, -2)
                       for x in (csr.idx, csr.val, csr.mask)),
                     n_cols=csr.n_cols)


def _rows(x: torch.Tensor, lo: int, n: int, dim: int) -> torch.Tensor:
    """Rows [lo, lo + n) of ``x`` along ``dim``, zero rows past its end."""
    have = x.shape[dim]
    part = x.narrow(dim, min(lo, have), max(0, min(lo + n, have) - lo))
    return _pad_rows(part, n, dim)


def _prior_rows(p: RowGaussians, lo: int, n: int) -> RowGaussians:
    """Rows [lo, lo + n) of a (B, N, …) prior; rows past N are N(0, I)
    (finite, and their samples are never read back)."""
    eta = _rows(p.eta, lo, n, -2)
    lam = _rows(p.Lambda, lo, n, -3)
    extra = lo + n - p.eta.shape[-2]
    if extra > 0:               # ``_rows`` made a new tensor: fill it
        lam[..., n - min(extra, n):, :, :].diagonal(
            dim1=-2, dim2=-1).fill_(1.0)
    return RowGaussians(eta=eta, Lambda=lam)


def row_shards(csr: PaddedCSR, group: Group, n_rows_pad: int
               ) -> List[PaddedCSR]:
    """Each shard's rows of (B, N, M) planes as a contiguous buffer on its
    slot's device; rows past N are empty."""
    n_loc = n_rows_pad // group.size
    return [PaddedCSR(*(_rows(x, s * n_loc, n_loc, -2).to(dev).contiguous()
                        for x in (csr.idx, csr.val, csr.mask)),
                      n_cols=csr.n_cols)
            for s, dev in enumerate(group.devices)]


def item_stats_local(U_loc, csr_t_loc: PaddedCSR, tau: float,
                     use_kernel: bool = True, live=None):
    """Per-item partial statistics from one shard's ratings.

    U_loc: (…, N_loc, K) the shard's rows of U; csr_t_loc: its TRANSPOSED
    planes (rows = items, columns = local user slots,
    ``shard_transposed_planes``). Returns (…, D, K, K), (…, D, K) before
    the reduction — ``bmf.sufficient_stats``, the U-step's gather, through
    kernel B1 by default."""
    return BMF.sufficient_stats(csr_t_loc, U_loc, tau, use_kernel, live)


def shard_transposed_planes(rows, cols, vals, n_shards: int, n_rows_pad: int,
                            n_items: int, max_nnz: int):
    """Host-side per-shard TRANSPOSED padded planes for the 'psum' and
    'scatter' V-steps: shard s holds items × its LOCAL users (rows
    [s·N_loc, (s+1)·N_loc) of the padded row space). ``rows`` / ``cols`` /
    ``vals``: the block's COO triplets (numpy). Returns (idx, val, mask)
    numpy arrays (n_shards, n_items, M), M = ``max_nnz`` rounded up to 8 —
    the reference's layout."""
    from repro_torch.data.sparse import coo_to_padded_csr
    n_loc = n_rows_pad // n_shards
    shard_of = rows // n_loc
    out = []
    for s in range(n_shards):
        sel = shard_of == s
        coo_t = COO(row=cols[sel].astype(np.int32),
                    col=(rows[sel] - s * n_loc).astype(np.int32),
                    val=vals[sel].astype(np.float32),
                    n_rows=n_items, n_cols=n_loc)
        out.append(coo_to_padded_csr(coo_t, max_nnz=max_nnz,
                                     n_rows_pad=n_items, n_cols_pad=n_loc,
                                     as_numpy=True))
    return tuple(np.stack([getattr(c, k) for c in out])
                 for k in ("idx", "val", "mask"))


def shard_transposed_entries(rows, cols, vals, n_shards: int,
                             n_rows_pad: int, n_items: int, max_nnz: int):
    """``shard_transposed_planes`` as live entries, O(nnz) on the host:
    per shard ``(flat slot, column id, value)`` for ``pp.scatter_entries``
    into zeroed (n_items, M) planes on the device."""
    from repro_torch.core.pp import csr_entries
    n_loc = n_rows_pad // n_shards
    shard_of = rows // n_loc
    out = []
    for s in range(n_shards):
        sel = shard_of == s
        coo_t = COO(row=cols[sel].astype(np.int32),
                    col=(rows[sel] - s * n_loc).astype(np.int32),
                    val=vals[sel].astype(np.float32),
                    n_rows=n_items, n_cols=n_loc)
        out.append(csr_entries(coo_t, max_nnz, n_items, n_loc))
    return out


def _gather_trimmed(group: Group, parts, n: int, n_loc: int):
    """all_gather of the shards' (…, n_loc, K) tiles, trimmed to ``n``
    rows (padding rows are dropped before the exchange)."""
    keep = [p.narrow(-2, 0, min(n_loc, n - s * n_loc))
            for s, p in enumerate(parts) if s * n_loc < n]
    return group.all_gather(keep, dim=-2)


def _sharded_u_sampler(cfg: BMF.BMFConfig, group: Group,
                       shards: Sequence[PaddedCSR], N: int, N_pad: int,
                       state: Dict):
    """U-step over the group's shards: each samples its rows (B2 under
    ``sweep_fused``, else B1 or the dense statistics + Cholesky) with the
    slice of the full noise draw, then one all_gather. The shards' rows
    stay in ``state`` for the V-step's partial statistics."""
    n_loc = N_pad // group.size
    lives = [row_live(c.mask) for c in shards]
    steps = [GIBBS.default_sampler(cfg, live) for live in lives]

    def u_sampler(z, _csr, V, prior, sweep):
        Vs = group.broadcast(V)
        group.fork()
        parts = []
        for s, dev in enumerate(group.devices):
            with group.on(s):
                lo = s * n_loc
                parts.append(steps[s](
                    _rows(z, lo, n_loc, -2).to(dev).contiguous(),
                    shards[s], Vs[s],
                    _prior_rows(prior, lo, n_loc).to(dev), sweep))
        group.join()
        U = _gather_trimmed(group, parts, N, n_loc)
        state["U"], state["U_loc"] = U, parts
        return U

    return u_sampler


def _sharded_v_sampler(cfg: BMF.BMFConfig, group: Group,
                       csrt: Sequence[PaddedCSR], N: int, N_pad: int,
                       D: int, D_pad: int, scatter: bool, noise,
                       state: Dict):
    """V-step from the shards' transposed planes: partial statistics
    (kernel B1 under ``use_kernel`` or ``sweep_fused``) reduced by
    ``psum`` (replicated sampling from the single-device draw) or by
    ``psum_scatter`` (each shard samples its D_pad/S rows from its own
    draw, then all_gather)."""
    K = cfg.K
    S = group.size
    n_loc, d_loc = N_pad // S, D_pad // S
    lives = [row_live(c.mask) for c in csrt]
    kernel = cfg.use_kernel or cfg.sweep_fused
    if not scatter and D_pad != D:
        raise ValueError(f"psum: the transposed planes hold {D_pad} items, "
                         f"the block {D}")

    def v_sampler(z, _csr, U, prior, sweep):
        if state.get("U") is U:
            U_loc = state["U_loc"]
        else:
            U_loc = [_rows(U, s * n_loc, n_loc, -2).to(dev).contiguous()
                     for s, dev in enumerate(group.devices)]
        group.fork()
        lam_p, eta_p = [], []
        for s in range(S):
            with group.on(s):
                lam, eta = item_stats_local(U_loc[s], csrt[s], cfg.tau,
                                            kernel, lives[s])
                lam_p.append(lam)
                eta_p.append(eta)
        group.join()
        if not scatter:
            cond = RowGaussians(eta=prior.eta + group.psum(eta_p),
                                Lambda=prior.Lambda + group.psum(lam_p))
            return POST.sample_rows_noise(cond, z)
        lam_t = group.psum_scatter(lam_p, dim=-3)
        eta_t = group.psum_scatter(eta_p, dim=-2)
        group.fork()
        parts = []
        for s, dev in enumerate(group.devices):
            with group.on(s):
                pr = _prior_rows(prior, s * d_loc, d_loc).to(dev)
                cond = RowGaussians(eta=pr.eta + eta_t[s],
                                    Lambda=pr.Lambda + lam_t[s])
                z_s = noise.factor(sweep, "V", d_loc, K, shard=s)
                parts.append(POST.sample_rows_noise(cond, z_s.to(dev)))
        group.join()
        return _gather_trimmed(group, parts, D, d_loc)

    return v_sampler


def make_distributed_sweep(cfg: BMF.BMFConfig, group: Group, noise,
                           rows: Sequence[PaddedCSR], N: int, N_pad: int,
                           D: int, csrt: Optional[Sequence[PaddedCSR]] = None,
                           D_pad: Optional[int] = None,
                           comm: str = "gather"):
    """The data-sharded factor steps of one sweep, as the
    ``(u_sampler, v_sampler)`` pair ``gibbs._run_gibbs_impl`` takes
    (``v_sampler`` None in 'gather' mode: the single-device V-step). The
    reference returns a shard_mapped sweep; the port's chain body is the
    shared one."""
    if comm not in COMM_MODES:
        raise ValueError(f"comm={comm!r} not in {COMM_MODES}")
    state: Dict = {}
    u = _sharded_u_sampler(cfg, group, rows, N, N_pad, state)
    if comm == "gather":
        return u, None
    if csrt is None:
        raise ValueError(f"comm={comm!r} needs the per-shard transposed "
                         f"planes (shard_transposed_planes)")
    v = _sharded_v_sampler(cfg, group, csrt, N, N_pad, D,
                           D if D_pad is None else D_pad,
                           comm == "scatter", noise, state)
    return u, v


def _as_group(topology, group) -> Group:
    return group if isinstance(group, Group) else \
        Topology.from_spec(topology).slots(int(group))


def _csrt_shards(csrt, group: Group, n_loc: int) -> List[PaddedCSR]:
    """Per-shard transposed planes on the slots' devices, from the
    reference's stacked form (idx, val, mask) with leaves (B, S, D_pad,
    M_c), or as given when already a list of per-shard ``PaddedCSR``."""
    if isinstance(csrt, list) and csrt and isinstance(csrt[0], PaddedCSR):
        return csrt
    idx, val, mask = (torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x for x in csrt)
    if idx.shape[1] != group.size:
        raise ValueError(f"csrt shard dim {idx.shape[1]} != data axis "
                         f"{group.size}")
    return [PaddedCSR(idx[:, s].to(dev, torch.int32).contiguous(),
                      val[:, s].to(dev, torch.float32).contiguous(),
                      mask[:, s].to(dev, torch.float32).contiguous(),
                      n_cols=n_loc)
            for s, dev in enumerate(group.devices)]


def run_gibbs_stacked_2d(noise, csr_rows: PaddedCSR, csr_cols: PaddedCSR,
                         test_rows, test_cols, cfg: BMF.BMFConfig,
                         topology=None,
                         U_prior: Optional[RowGaussians] = None,
                         V_prior: Optional[RowGaussians] = None,
                         prior_use: Optional[Sequence] = None,
                         comm: str = "gather", csrt=None, group=0,
                         U0=None, V0=None) -> GIBBS.GibbsResult:
    """B identically shaped blocks' chains on ONE group of ``topology``
    (``group``: its index or a ``Group``), each chain data-sharded over
    the group's slots — the per-group unit of the sharded, async and
    streaming executors. Planes (B, N, M) / (B, D, M_c), priors and tests
    as ``gibbs.run_gibbs_stacked``; ``noise`` a source of batch B (or B
    seeds). ``csrt``: the 'psum'/'scatter' transposed planes, in the
    reference's (B, S, D_pad, M_c) form or as S ``PaddedCSR``.

    Rows are padded to a multiple of ``topology.data`` with empty rows
    that never enter the chain's semantics (zero-mask planes, zero noise,
    trimmed before the exchange), so 'gather' reproduces
    ``run_gibbs_stacked`` under the same noise. At data == 1 every mode is
    the single-device chain. Runs on the caller's current stream of the
    group's lead device; the shards fork onto their own streams."""
    if comm not in COMM_MODES:
        raise ValueError(f"comm={comm!r} not in {COMM_MODES}")
    grp = _as_group(topology, group)
    dev = grp.lead
    rows = GIBBS._csr_to(csr_rows, dev)
    cols = GIBBS._csr_to(csr_cols, dev)
    B, N, D, K = rows.idx.shape[0], rows.n_rows, cols.n_rows, cfg.K
    noise = GIBBS.as_noise(noise, B, dev)
    if U0 is None or V0 is None:
        U0, V0 = BMF.init_factors(noise, N, D, K)
    u_use, v_use = (None, None) if prior_use is None else (
        GIBBS._to(prior_use[0], dev), GIBBS._to(prior_use[1], dev))
    tr, tc = GIBBS._to(test_rows, dev), GIBBS._to(test_cols, dev)
    up, vp = GIBBS._prior_to(U_prior, dev), GIBBS._prior_to(V_prior, dev)
    args = (cfg, cfg.n_samples, cfg.burnin, up, vp, U0, V0, u_use, v_use)
    if grp.size == 1:
        return GIBBS._run_gibbs_impl(noise, rows, cols, tr, tc, *args)
    N_pad = _ceil_to(N, grp.size)
    shards = row_shards(rows, grp, N_pad)
    csrt_s, D_pad = None, None
    if comm != "gather":
        if csrt is None:
            raise ValueError(f"comm={comm!r} needs the per-shard transposed "
                             f"planes (shard_transposed_planes)")
        csrt_s = _csrt_shards(csrt, grp, N_pad // grp.size)
        D_pad = csrt_s[0].n_rows
        if comm == "scatter" and D_pad % grp.size:
            raise ValueError(f"scatter: D_pad = {D_pad} is not a multiple "
                             f"of data = {grp.size}")
    u_s, v_s = make_distributed_sweep(cfg, grp, noise, shards, N, N_pad, D,
                                      csrt_s, D_pad, comm)
    return GIBBS._run_gibbs_impl(
        noise, shards, csrt_s if v_s is not None else cols, tr, tc, *args,
        u_sampler=u_s, v_sampler=v_s, n_rows=N, n_cols=D)


def run_gibbs_group(noise, csr_rows: PaddedCSR, csr_cols: PaddedCSR,
                    test_rows, test_cols, cfg: BMF.BMFConfig,
                    topology=None, group=0,
                    U_prior: Optional[RowGaussians] = None,
                    V_prior: Optional[RowGaussians] = None,
                    comm: str = "gather", csrt=None,
                    U0=None, V0=None) -> GIBBS.GibbsResult:
    """One block's chain data-sharded over one group: the batch-of-one
    ``run_gibbs_stacked_2d`` (planes (N, M), ``csrt`` leaves (S, D_pad,
    M_c)); under the same noise 'gather' matches ``gibbs.run_gibbs``."""
    dev = _as_group(topology, group).lead
    one = lambda t: GIBBS.tree_map(lambda x: x[None], t)  # noqa: E731
    cs = lambda c: GIBBS._csr_to(c, dev)                    # noqa: E731
    if csrt is not None and not isinstance(csrt, list):
        csrt = tuple(torch.as_tensor(np.asarray(x))[None] if not isinstance(
            x, torch.Tensor) else x[None] for x in csrt)
    res = run_gibbs_stacked_2d(
        noise, one(cs(csr_rows)), one(cs(csr_cols)),
        GIBBS._to(test_rows, dev)[None], GIBBS._to(test_cols, dev)[None],
        cfg, topology, one(GIBBS._prior_to(U_prior, dev)),
        one(GIBBS._prior_to(V_prior, dev)), comm=comm, csrt=csrt,
        group=group,
        U0=None if U0 is None else GIBBS._to(U0, dev, torch.float32)[None],
        V0=None if V0 is None else GIBBS._to(V0, dev, torch.float32)[None])
    return GIBBS.tree_map(lambda x: x[0], res)


def run_gibbs_distributed(noise, csr_rows: PaddedCSR, csr_cols: PaddedCSR,
                          test_rows, test_cols, cfg: BMF.BMFConfig,
                          topology=None,
                          U_prior: Optional[RowGaussians] = None,
                          V_prior: Optional[RowGaussians] = None,
                          scatter_v: bool = False, U0=None, V0=None,
                          device=None) -> GIBBS.GibbsResult:
    """One (large) block's chain over the ``data`` shards of a one-group
    ``topology`` (``Topology(1, S)``, an int S for S slots on ``device``,
    or None for ``Topology.default``'s first group): 'psum' item
    statistics, or 'scatter' with ``scatter_v``. The transposed shard
    planes are assembled here on the host from ``csr_rows``' entries.

    The reference's version draws each shard's U noise with
    ``fold_in(ku, shard)``; the port takes the slice of the single-device
    draw, as the composed chain does, so this chain matches
    ``gibbs.run_gibbs`` under the same noise up to the statistics'
    reassociation (psum)."""
    if isinstance(topology, int):
        dev = resolve_device(device)
        topology = Topology(1, topology, devices=(dev,) * topology)
    topo = Topology.from_spec(topology)
    if topo.block != 1:
        raise ValueError(f"run_gibbs_distributed runs one block on one "
                         f"group; got {topo.describe()}")
    S = topo.data
    idx, val, mask = (np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                 else x) for x in (csr_rows.idx,
                                                   csr_rows.val,
                                                   csr_rows.mask))
    N, D = idx.shape[0], csr_rows.n_cols
    r, sl = np.nonzero(mask > 0)
    N_pad = _ceil_to(N, S)
    D_pad = _ceil_to(D, S) if scatter_v else D
    # M_c: the most ratings an item has within one shard, as the reference
    m_c = max([1] + [int(np.bincount(idx[r, sl][r // (N_pad // S) == s],
                                     minlength=D).max())
                     for s in range(S)])
    csrt = shard_transposed_planes(r, idx[r, sl], val[r, sl], S, N_pad,
                                   D_pad, m_c)
    return run_gibbs_group(noise, csr_rows, csr_cols, test_rows, test_cols,
                           cfg, topo, 0, U_prior, V_prior,
                           comm="scatter" if scatter_v else "psum",
                           csrt=csrt, U0=U0, V0=V0)


def sweep_comm_bytes(D: int, K: int) -> int:
    """The paper's 'limited communication': bytes reduced per Gibbs sweep
    (the 'psum' item statistics plus the hyperparameter moments)."""
    return 4 * (D * (K * K + K) + 2 * (K * K + K))


def sweep_comm_bytes_scatter(D: int, K: int) -> int:
    """The 'scatter' variant: a ring reduce-scatter moves half the bytes of
    a ring all-reduce, plus the sampled-V gather."""
    return 4 * (D * (K * K + K) // 2 + D * K + 2 * (K * K + K))


def trace_chain_2d(cfg: BMF.BMFConfig, topology, n_rows: int, n_cols: int,
                   m_rows: int, m_cols: int, n_test: int, *,
                   batch: Optional[int] = None, comm: str = "gather",
                   u_prior: bool = True, v_prior: bool = True,
                   prior_use: bool = False, sweeps: int = 2,
                   group: int = 0) -> GIBBS.TracedChain:
    """Analyzer hook: run the composed chain ``run_gibbs_stacked_2d``
    dispatches — B blocks on group ``group`` of ``topology``, each chain
    data-sharded over the group's slots — once at these block dims on
    seeded random planes, under the op and collective recorders (see
    ``gibbs.trace_chain``). ``batch`` defaults to ``topology.block``. On
    a topology whose slots are ``meta`` the planes are shapes only (a dry
    run's plan)."""
    if comm not in COMM_MODES:
        raise ValueError(f"comm={comm!r} not in {COMM_MODES}")
    topo = Topology.from_spec(topology)
    dev = topo.group(group)[0]
    B = topo.block if batch is None else int(batch)
    S = topo.data
    inp = GIBBS.lint_inputs(0, B, n_rows, n_cols, m_rows, m_cols, n_test,
                            cfg.K, dev)
    csrt = None
    if comm != "gather":
        N_pad = _ceil_to(n_rows, S)
        D_pad = _ceil_to(n_cols, S) if comm == "scatter" else n_cols
        if dev.type == "meta":
            csrt = tuple(torch.empty((B, S, D_pad, m_cols), dtype=dt,
                                     device=dev)
                         for dt in (torch.int32, torch.float32,
                                    torch.float32))
        else:
            per = [shard_transposed_planes(c.row, c.col, c.val, S, N_pad,
                                           D_pad, m_cols) for c in inp.coos]
            csrt = tuple(torch.from_numpy(np.stack([p[k] for p in per]))
                         .to(dev) for k in range(3))
    cfg = cfg._replace(n_samples=sweeps, burnin=sweeps - 1,
                       phase_bc_samples=None)
    up = inp.U_prior if (u_prior or prior_use) else None
    vp = inp.V_prior if (v_prior or prior_use) else None
    use = GIBBS.lint_flags(B, dev) if prior_use else None
    return GIBBS.traced_run(
        run_gibbs_stacked_2d,
        (list(range(B)), inp.rows, inp.cols, inp.test_rows, inp.test_cols,
         cfg, topo, up, vp),
        dict(prior_use=use, comm=comm, csrt=csrt, group=group), sweeps, dev)
