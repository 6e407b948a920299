"""The PP aggregates behind serving at the MovieLens-20M shape, port
against reference, on the same per-block posteriors.

  python3 tests/torch_pp_aggregate_check.py dump OUT.npz     # on the GPU
  PYTHONPATH=src python tests/torch_pp_aggregate_check.py compare OUT.npz

``dump`` runs ``chip_smoke.py``'s main path (the MovieLens-20M shape,
16 x 4 grid, K = 10, 8 sweeps, fused sweep, stacked executor) with the
port alone and writes, for a sample of rows of each factor, every block's
posterior of those rows, the port's divide-away aggregate, its PD
projection and posterior mean (``serving.store``), plus each side's count
of aggregated rows that are indefinite. Rows: every indefinite row up to
``N_BAD`` and ``N_OK`` others, seeded. The aggregation and the projection
are row-local, so a sample of rows is a complete check of them.

``compare`` runs the reference's ``pp._aggregate_axis`` and
``serving.store._project_pd`` / ``_posterior_mean`` on the dumped
per-block rows on the CPU and prints the largest departures from the
port's, relative to each row's largest entry, and both sides' indefinite
counts on the sample.
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_BAD, N_OK = 2048, 2048
JITTER = 1e-6


def dump(out_path):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as SMOKE
    from repro_torch import resolve_device
    from repro_torch.core import bmf as BMF
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.serving import store as STORE

    class Capture(ENG.StackedExecutor):
        """The stacked executor, keeping the run's per-block posteriors."""

        def run_graph(self, ctx, graph, verbose=False):
            out = super().run_graph(ctx, graph, verbose)
            self.ctx = ctx
            return out

    dev = resolve_device("cuda")
    preset, train, test, _, part = SMOKE.make_data()
    cfg = BMF.BMFConfig(K=preset.K, n_samples=SMOKE.SAMPLES,
                        burnin=SMOKE.BURNIN, sweep_fused=True)
    ex = Capture()
    res = PP.run_pp(0, part, cfg, test, executor=ex, device=dev)
    rng = np.random.default_rng(0)
    out = {"rmse": np.asarray(res.rmse), "I": np.asarray(part.I),
           "J": np.asarray(part.J)}
    for side, agg, n_grp in (("U", res.U_agg, part.I),
                             ("V", res.V_agg, part.J)):
        lam = agg.Lambda
        bad = []
        for lo in range(0, lam.shape[0], STORE.EIGH_ROWS):
            x = lam[lo:lo + STORE.EIGH_ROWS]
            ev = torch.linalg.eigvalsh((x + x.mT) / 2)[:, 0]
            bad.append(torch.nonzero(ev <= 0)[:, 0].cpu().numpy() + lo)
        bad = np.concatenate(bad)
        ok = np.setdiff1d(np.arange(lam.shape[0]), bad)
        sel = np.sort(np.concatenate([
            rng.choice(bad, min(N_BAD, len(bad)), replace=False),
            rng.choice(ok, min(N_OK, len(ok)), replace=False)]))
        # a permuted aggregate row -> (group, local row): groups are the
        # row (col) groups in order, each as long as its blocks' rows
        sizes = [len(part.block(g, 0).row_ids) if side == "U"
                 else len(part.block(0, g).col_ids) for g in range(n_grp)]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        grp = np.searchsorted(starts, sel, side="right") - 1
        loc = sel - starts[grp]
        store_ = ex.ctx.U_posts if side == "U" else ex.ctx.V_posts
        n_blk = part.J if side == "U" else part.I
        eta = np.zeros((len(sel), n_blk, preset.K), np.float32)
        blam = np.zeros((len(sel), n_blk, preset.K, preset.K), np.float32)
        for g in range(n_grp):
            m = grp == g
            for b in range(n_blk):
                p = store_[(g, b) if side == "U" else (b, g)]
                idx = torch.from_numpy(loc[m]).to(dev)
                eta[m, b] = p.eta[idx].cpu().numpy()
                blam[m, b] = p.Lambda[idx].cpu().numpy()
        idx = torch.from_numpy(sel).to(dev)
        proj = STORE._project_pd(agg.Lambda[idx])
        mean = STORE._posterior_mean(
            STORE.RowGaussians(eta=agg.eta[idx], Lambda=proj), JITTER)
        out.update({f"{side}_rows": sel, f"{side}_n_bad": np.asarray(
            len(bad)), f"{side}_n": np.asarray(lam.shape[0]),
            f"{side}_eta": eta, f"{side}_lam": blam,
            f"{side}_agg_eta": agg.eta[idx].cpu().numpy(),
            f"{side}_agg_lam": agg.Lambda[idx].cpu().numpy(),
            f"{side}_proj": proj.cpu().numpy(),
            f"{side}_mean": mean.cpu().numpy()})
        print(f"[pp-agg] {side}: {len(bad)} of {lam.shape[0]} aggregated "
              f"rows indefinite; dumped {len(sel)} rows x {n_blk} blocks",
              flush=True)
    np.savez(out_path, **out)
    print(f"[pp-agg] RMSE {res.rmse:.4f}; wrote {out_path}", flush=True)


def _rel(a, b):
    """Largest |a - b| over each row's largest |b| entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ax = tuple(range(1, a.ndim))
    scale = np.maximum(np.abs(b).max(axis=ax), 1e-30)
    return float((np.abs(a - b).max(axis=ax) / scale).max())


def compare(path):
    import jax
    import jax.numpy as jnp
    from repro.core import pp as JPP
    from repro.core.posterior import RowGaussians as JRG
    from repro.serving import store as JSTORE
    d = dict(np.load(path))
    print(f"dump of the card run: RMSE {float(d['rmse']):.4f}, grid "
          f"{int(d['I'])}x{int(d['J'])}")
    for side, axis in (("U", "row"), ("V", "col")):
        eta, lam = d[f"{side}_eta"], d[f"{side}_lam"]
        n_blk = eta.shape[1]
        # every sampled row as one group of n_blk blocks: the reference's
        # reduction is row-local, so the grid's split does not matter
        blocks = [JRG(eta=jnp.asarray(eta[:, b]), Lambda=jnp.asarray(
            lam[:, b])) for b in range(n_blk)]
        posts = ((tuple(blocks),) if axis == "row"
                 else tuple((b,) for b in blocks))
        agg = JPP._aggregate_axis_jit(posts, axis)
        proj = JSTORE._project_pd(agg.Lambda)
        mean = JSTORE._posterior_mean(JRG(eta=agg.eta, Lambda=proj), JITTER)
        ev = np.linalg.eigvalsh(np.asarray(
            (agg.Lambda + jnp.swapaxes(agg.Lambda, -1, -2)) / 2))[:, 0]
        ev_p = np.linalg.eigvalsh(
            (d[f"{side}_agg_lam"] + np.swapaxes(d[f"{side}_agg_lam"], -1,
                                                -2)) / 2)[:, 0]
        print(f"{side}: {int(d[f'{side}_n_bad'])} of {int(d[f'{side}_n'])} "
              f"aggregated rows indefinite on the card; sample of "
              f"{eta.shape[0]} rows: indefinite {int((ev <= 0).sum())} "
              f"(reference) / {int((ev_p <= 0).sum())} (port); largest "
              f"departure per row: aggregate eta "
              f"{_rel(d[f'{side}_agg_eta'], agg.eta):.3e}, Lambda "
              f"{_rel(d[f'{side}_agg_lam'], agg.Lambda):.3e}; projected "
              f"Lambda {_rel(d[f'{side}_proj'], proj):.3e}; posterior mean "
              f"{_rel(d[f'{side}_mean'], mean):.3e}; largest |mean| "
              f"{float(np.abs(np.asarray(mean)).max()):.4g} (reference), "
              f"{float(np.abs(d[f'{side}_mean']).max()):.4g} (port)")


if __name__ == "__main__":
    {"dump": dump, "compare": compare}[sys.argv[1]](sys.argv[2])
