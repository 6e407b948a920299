"""The port's intra-block distributed BMF (``core.distributed``) and the
sharded executor against the reference.

One subprocess runs the reference's composed 2-D chain
(``run_gibbs_stacked_2d`` in the 'gather', 'psum' and 'scatter' modes)
and the sharded executor's ``run_pp`` ('psum', 'scatter') on a faked
4-device CPU mesh, as ``tests/test_topology.py`` does, and writes numpy.
The port replays the same key schedule through ``TapeNoise`` — the
'scatter' mode's per-shard ``fold_in`` draws included — on CPU topologies
whose slots repeat "cpu". Limits: RMSE within 1e-5, final factors within
1e-3 (the reference's own ``gather_U_diff`` limit), aggregates 1e-3
relative in the Frobenius norm (``test_torch_chain.py``).

``run_gibbs_distributed`` is held against the port's single-device chain
under one tape: the reference's own version fails at its final
``predict`` on JAX 0.9, so it is no oracle.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bmf as TB
from repro_torch.core import distributed as TD
from repro_torch.core import gibbs as TG
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.core.topology import Group, Topology
from repro_torch.data import sparse as TSP
from repro_torch.data import synthetic as TSYN
from repro_torch.noise import TapeNoise
from torch_helpers import jax_chain_tape, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
K, NS, BURN = 6, 8, 3
PP_NS, PP_BURN = 24, 4
S = 2                                  # data slots per group
TOPO = Topology(2, S, devices=("cpu",) * 4)
MODES = TD.COMM_MODES
RMSE_TOL, FACTOR_TOL, AGG_TOL = 1e-5, 1e-3, 1e-3

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import bmf as BMF, distributed as DIST, engine as ENG
    from repro.core import gibbs as GIBBS, pp as PP
    from repro.core.partition import partition
    from repro.core.topology import Topology
    from repro.data import synthetic as SYN
    from repro.data.sparse import coo_to_padded_csr, PaddedCSR, \\
        train_test_split

    K, NS, BURN, S, PP_NS, PP_BURN = %d, %d, %d, %d, %d, %d
    coo, _ = SYN.generate("mini", seed=3)
    train, test = train_test_split(coo, 0.15, seed=4)
    csr_r = coo_to_padded_csr(train)
    csr_c = coo_to_padded_csr(train.transpose())
    keys = jax.random.split(jax.random.key(7), 2)
    tr = jnp.stack([jnp.asarray(test.row)] * 2)
    tc = jnp.stack([jnp.asarray(test.col)] * 2)
    out = {"n_devices": np.asarray(len(jax.devices()))}

    def stack2(c):
        return PaddedCSR(idx=jnp.stack([c.idx] * 2),
                         val=jnp.stack([c.val] * 2),
                         mask=jnp.stack([c.mask] * 2), n_cols=c.n_cols)

    def keep(tag, res):
        out[tag + "_U"] = np.asarray(res.U)
        out[tag + "_V"] = np.asarray(res.V)
        out[tag + "_pred"] = np.asarray(
            res.acc.pred_sum / jnp.maximum(res.acc.pred_cnt, 1)[..., None])

    topo = Topology(block=2, data=S)
    N, D = csr_r.n_rows, csr_c.n_rows
    N_pad, D_pad = -(-N // S) * S, -(-D // S) * S
    m_c = int(csr_c.idx.shape[1])
    cfg = BMF.BMFConfig(K=K, n_samples=NS, burnin=BURN)
    for comm in ("gather", "psum", "scatter"):
        csrt = None
        if comm != "gather":
            csrt1 = DIST.shard_transposed_planes(
                train.row, train.col, train.val, S, N_pad,
                D_pad if comm == "scatter" else D, m_c)
            csrt = tuple(np.stack([x] * 2) for x in csrt1)
        keep(comm, DIST.run_gibbs_stacked_2d(
            keys, stack2(csr_r), stack2(csr_c), tr, tc, cfg, topo,
            comm=comm, csrt=csrt))

    # the sharded executor's run_pp on a 2 x 2 grid ('gather' is the
    # stacked chain, held to the reference in test_torch_executors.py);
    # 20 kept draws >= K + 4 keep the summaries' inversion tame
    part = partition(train, 2, 2)
    pcfg = BMF.BMFConfig(K=K, n_samples=PP_NS, burnin=PP_BURN)
    for comm in ("psum", "scatter"):
        r = PP.run_pp(jax.random.key(11), part, pcfg, test,
                      executor=ENG.ShardedExecutor(topology=topo, comm=comm))
        out["pp_" + comm + "_rmse"] = np.asarray(r.rmse)
        out["pp_" + comm + "_U_eta"] = np.asarray(r.U_agg.eta)
        out["pp_" + comm + "_V_lam"] = np.asarray(r.V_agg.Lambda)
    np.savez(sys.argv[1], **out)
""") % (K, NS, BURN, S, PP_NS, PP_BURN)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, from one subprocess on 4 faked devices."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = dict(np.load(path))
    assert int(out["n_devices"]) == 4
    return out


@pytest.fixture(scope="module")
def mini():
    coo, _ = TSYN.generate("mini", seed=3)
    train, test = TSP.train_test_split(coo, 0.15, seed=4)
    rows = TSP.coo_to_padded_csr(train, as_numpy=True)
    cols = TSP.coo_to_padded_csr(train.transpose(), as_numpy=True)
    return train, test, rows, cols


def _tapes(keys, N, D, n_samples=NS, shards=None):
    return [jax_chain_tape(k, N, D, K, n_samples, shards=shards)
            for k in keys]


def _stack2(c):
    return TSP.PaddedCSR(*(np.stack([x] * 2) for x in (c.idx, c.val,
                                                       c.mask)), c.n_cols)


def _rmse(pred, test):
    return np.sqrt(np.mean((np.asarray(pred) - test.val) ** 2, axis=-1))


def _maxrel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_2d(mini, comm, cfg, group=0):
    import jax
    train, test, rows, cols = mini
    N, D = rows.idx.shape[0], cols.idx.shape[0]
    N_pad, D_pad = -(-N // S) * S, -(-D // S) * S
    keys = jax.random.split(jax.random.key(7), 2)
    shards = (S, D_pad // S) if comm == "scatter" else None
    noise = TapeNoise(_tapes(keys, N, D, shards=shards), "cpu")
    csrt = None
    if comm != "gather":
        csrt1 = TD.shard_transposed_planes(
            train.row, train.col, train.val, S, N_pad,
            D_pad if comm == "scatter" else D, cols.idx.shape[1])
        csrt = tuple(np.stack([x] * 2) for x in csrt1)
    tr = np.stack([test.row] * 2)
    tc = np.stack([test.col] * 2)
    res = TD.run_gibbs_stacked_2d(noise, _stack2(rows), _stack2(cols), tr,
                                  tc, cfg, TOPO, comm=comm, csrt=csrt,
                                  group=group)
    pred = (res.acc.pred_sum / res.acc.pred_cnt[:, None]).numpy()
    return res, pred


@pytest.mark.parametrize("comm", MODES)
def test_stacked_2d_chain_matches_reference(ref, mini, comm):
    """Each comm mode's composed chain, tape-replayed, against the
    reference's on 4 faked devices: RMSE within 1e-5 per block, U and V
    within 1e-3."""
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN)
    res, pred = _port_2d(mini, comm, cfg, group=1 if comm == "psum" else 0)
    tag = comm
    test = mini[1]
    np.testing.assert_allclose(_rmse(pred, test), _rmse(ref[tag + "_pred"],
                                                       test), atol=RMSE_TOL)
    assert _maxrel(res.U.numpy(), ref[tag + "_U"]) < FACTOR_TOL
    assert _maxrel(res.V.numpy(), ref[tag + "_V"]) < FACTOR_TOL


@pytest.mark.parametrize("kw", [{}, dict(sweep_fused=True),
                                dict(use_kernel=True)])
def test_gather_is_the_single_device_chain(mini, kw):
    """Under one tape, 'gather' on 2 slots is ``run_gibbs_stacked``: the
    shards' rows are the single-device rows, through the dense step, the
    fused sweep (B2) and the statistics kernel (B1) alike."""
    import jax
    train, test, rows, cols = mini
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN, **kw)
    res, _ = _port_2d(mini, "gather", cfg)
    keys = jax.random.split(jax.random.key(7), 2)
    N, D = rows.idx.shape[0], cols.idx.shape[0]
    one = TG.run_gibbs_stacked(TapeNoise(_tapes(keys, N, D), "cpu"),
                               _stack2(rows), _stack2(cols),
                               np.stack([test.row] * 2),
                               np.stack([test.col] * 2), cfg, device="cpu")
    torch.testing.assert_close(res.U, one.U, rtol=0, atol=1e-6)
    torch.testing.assert_close(res.U_post.eta, one.U_post.eta, rtol=1e-5,
                               atol=1e-5)


def test_group_dispatch_matches_reference_and_run_gibbs(ref, mini):
    """``run_gibbs_group`` (one block on group 1) against the reference's
    composed chain of that key and against the port's ``run_gibbs`` under
    the same tape."""
    import jax
    train, test, rows, cols = mini
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN)
    N, D = rows.idx.shape[0], cols.idx.shape[0]
    key = jax.random.split(jax.random.key(7), 2)[1]
    res = TD.run_gibbs_group(TapeNoise(_tapes([key], N, D), "cpu"), rows,
                             cols, test.row, test.col, cfg, TOPO, group=1)
    one = TG.run_gibbs(TapeNoise(_tapes([key], N, D), "cpu"), rows, cols,
                       test.row, test.col, cfg, device="cpu")
    assert _maxrel(res.U.numpy(), ref["gather_U"][1]) < FACTOR_TOL
    torch.testing.assert_close(res.U, one.U, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pp_case():
    coo, _ = TSYN.generate("mini", seed=3)
    train, test = TSP.train_test_split(coo, 0.15, seed=4)
    return TPA.partition(train, 2, 2), test, TB.BMFConfig(
        K=K, n_samples=PP_NS, burnin=PP_BURN)


def test_run_pp_sharded_gather_is_stacked(pp_case):
    """'gather' on ``Topology(2, 2)`` is the stacked executor's run bitwise
    (its chains are the single-device chains, its batch split in two)."""
    part, test, cfg = pp_case
    res = TPP.run_pp(3, part, cfg, test, executor="sharded", topology=TOPO,
                     comm="gather", device="cpu")
    ref = TPP.run_pp(3, part, cfg, test, executor="stacked", device="cpu")
    assert res.rmse == ref.rmse and res.executor == "sharded"
    torch.testing.assert_close(res.U_agg.eta, ref.U_agg.eta, rtol=0, atol=0)


@pytest.mark.parametrize("comm", ["psum", "scatter"])
def test_run_pp_sharded_matches_reference(ref, pp_case, comm):
    """``run_pp(executor="sharded", topology=Topology(2, 2), comm=m)`` on a
    2×2 grid against the reference's sharded executor on the same
    topology, the reference's key schedule replayed per block."""
    import jax
    part, test, cfg = pp_case
    shapes = TPP.BlockShapes.per_phase(
        part, TSP.apply_permutation(test, part.row_perm, part.col_perm))
    keys = jax.random.split(jax.random.key(11), 4).reshape(2, 2)
    tapes = {}
    for b in part.all_blocks():
        s = shapes[b.phase]
        tapes[(b.i, b.j)] = jax_chain_tape(
            keys[b.i, b.j], s.n_rows, s.n_cols, K, PP_NS,
            shards=(S, -(-s.n_cols // S)) if comm == "scatter" else None)
    res = TPP.run_pp(0, part, cfg, test, executor="sharded", topology=TOPO,
                     comm=comm, device="cpu",
                     noise=lambda blocks: TapeNoise(
                         [tapes[c] for c, _ in blocks], "cpu"))
    assert abs(res.rmse - float(ref[f"pp_{comm}_rmse"])) < RMSE_TOL
    assert _fro(res.U_agg.eta.numpy(), ref[f"pp_{comm}_U_eta"]) < AGG_TOL
    assert _fro(res.V_agg.Lambda.numpy(), ref[f"pp_{comm}_V_lam"]) < AGG_TOL


def test_shard_transposed_planes_match_reference(mini):
    """The port's host copy of ``shard_transposed_planes`` equals the
    reference's, and the executor's device assembly from live entries
    (``shard_transposed_entries`` + ``pp.scatter_entries``) equals it."""
    from repro.core import distributed as JD
    train, _, rows, cols = mini
    N, D = rows.idx.shape[0], cols.idx.shape[0]
    N_pad, D_pad = -(-N // 3) * 3, -(-D // 3) * 3
    m_c = cols.idx.shape[1]
    got = TD.shard_transposed_planes(train.row, train.col, train.val, 3,
                                     N_pad, D_pad, m_c)
    want = JD.shard_transposed_planes(train.row, train.col, train.val, 3,
                                      N_pad, D_pad, m_c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    ents = TD.shard_transposed_entries(train.row, train.col, train.val, 3,
                                       N_pad, D_pad, m_c)
    for s, (lin, col, val) in enumerate(ents):
        planes = [torch.zeros(got[0][s].shape, dtype=dt) for dt in
                  (torch.int32, torch.float32, torch.float32)]
        TPP.scatter_entries(*planes, torch.from_numpy(lin),
                            torch.from_numpy(col), torch.from_numpy(val))
        for p, g in zip(planes, got):
            np.testing.assert_array_equal(p.numpy(), g[s])


@pytest.mark.parametrize("scatter", [False, True])
def test_run_gibbs_distributed_vs_single_device(mini, scatter):
    """One block over ``Topology(1, 2)``: 'psum' is the single-device chain
    up to the statistics' reassociation (RMSE within 1e-5); 'scatter'
    draws V from per-shard noise, a different valid chain (RMSE within
    0.15, the reference's limit, and below the mean predictor)."""
    import jax
    train, test, rows, cols = mini
    cfg = TB.BMFConfig(K=K, n_samples=NS, burnin=BURN)
    N, D = rows.idx.shape[0], cols.idx.shape[0]
    key = jax.random.key(9)
    one = TG.run_gibbs(TapeNoise(_tapes([key], N, D), "cpu"), rows, cols,
                       test.row, test.col, cfg, device="cpu")
    shards = (S, -(-D // S)) if scatter else None
    dist = TD.run_gibbs_distributed(
        TapeNoise(_tapes([key], N, D, shards=shards), "cpu"), rows, cols,
        test.row, test.col, cfg, S, scatter_v=scatter, device="cpu")
    r1 = float(TG.rmse_from_acc(one.acc, test.val))
    r2 = float(TG.rmse_from_acc(dist.acc, test.val))
    assert dist.U.shape == (N, K) and dist.V.shape == (D, K)
    if scatter:
        mean = float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))
        assert abs(r2 - r1) < 0.15 and r2 < mean
    else:
        assert abs(r2 - r1) < RMSE_TOL


def test_collectives_on_one_device():
    """A group whose slots share a device: all_gather concatenates in
    shard order, psum adds in fixed shard order (bitwise on rerun),
    psum_scatter splits the sum into equal tiles, broadcast is the
    tensor itself."""
    grp = Group(0, ("cpu",) * 3)
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn((2, 6, 4), generator=g) for _ in range(3)]
    torch.testing.assert_close(grp.all_gather(parts, dim=-2),
                               torch.cat(parts, dim=-2), rtol=0, atol=0)
    want = (parts[0] + parts[1]) + parts[2]
    torch.testing.assert_close(grp.psum(parts), want, rtol=0, atol=0)
    tiles = grp.psum_scatter(parts, dim=-2)
    assert [t.shape for t in tiles] == [(2, 2, 4)] * 3
    torch.testing.assert_close(torch.cat(tiles, -2), want, rtol=0, atol=0)
    assert all(x is parts[0] for x in grp.broadcast(parts[0]))
    with pytest.raises(ValueError, match="multiple"):
        Group(0, ("cpu",) * 4).psum_scatter(parts[:4] + parts[:1], dim=-2)
    assert grp.streams == [None] * 3         # no streams on the CPU


def test_padding_helpers_and_item_stats(mini):
    """``pad_csr_for_mesh`` adds empty rows; ``item_stats_local`` is the
    U-step's sufficient statistics on the transposed planes; the comm
    byte counts are the reference's."""
    from repro.core import distributed as JD
    _, _, rows, _ = mini
    p = TD.pad_csr_for_mesh(rows, 3)
    assert p.idx.shape[0] % 3 == 0 and float(p.mask[rows.idx.shape[0]:]
                                             .sum()) == 0.0
    g = torch.Generator().manual_seed(1)
    U = torch.randn((rows.n_cols, K), generator=g)
    csr = TG._csr_to(rows, "cpu")
    a = TD.item_stats_local(U, csr, 2.0, use_kernel=True)
    b = TB.sufficient_stats(csr, U, 2.0, use_kernel=False)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    for D_, K_ in ((120, 6), (27278, 10), (17770, 100)):
        assert TD.sweep_comm_bytes(D_, K_) == JD.sweep_comm_bytes(D_, K_)
        assert TD.sweep_comm_bytes_scatter(D_, K_) == \
            JD.sweep_comm_bytes_scatter(D_, K_)
    with pytest.raises(ValueError, match="comm"):
        TD.run_gibbs_stacked_2d(0, rows, rows, [0], [0], TB.BMFConfig(K=2),
                                TOPO, comm="ring")
