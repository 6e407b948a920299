"""Host-side data of the port against the JAX reference: exact equality.

sparse (padded CSR, occupancy, permutations, split), synthetic (the
presets' ratings), partition (permutations, splits, every block's COO)
and the PP shape buckets. These are numpy computations on both sides, so
every array must be identical, not merely close.
"""
import numpy as np
import pytest
import torch

from repro.core import partition as JPA
from repro.core import pp as JPP
from repro.data import sparse as JSP
from repro.data import synthetic as JSYN
from repro_torch.core import partition as TPA
from repro_torch.core import pp as TPP
from repro_torch.data import sparse as TSP
from repro_torch.data import synthetic as TSYN


def _eq_coo(t, j):
    for f in ("row", "col", "val"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)


def _pair(preset, seed=0):
    return TSYN.generate(preset, seed=seed)[0], JSYN.generate(preset,
                                                              seed=seed)[0]


@pytest.mark.parametrize("preset", ["mini", "movielens"])
@pytest.mark.parametrize("seed", [0, 3])
def test_generate_identical(preset, seed):
    t, j = _pair(preset, seed)
    _eq_coo(t, j)
    assert TSYN.PRESETS[preset] == TSYN.DatasetPreset(
        **JSYN.PRESETS[preset].__dict__)
    tr_t, te_t = TSP.train_test_split(t, 0.1, seed=seed + 1)
    tr_j, te_j = JSP.train_test_split(j, 0.1, seed=seed + 1)
    _eq_coo(tr_t, tr_j)
    _eq_coo(te_t, te_j)


def test_generate_keeps_tail_rows():
    """The shuffle-before-truncate fix: ratings thin the popularity
    profile uniformly instead of cutting off the highest row ids."""
    t, _ = _pair("movielens")
    assert t.row.max() > 0.95 * t.n_rows


@pytest.mark.parametrize("kw", [{}, {"max_nnz": 16},
                                {"max_nnz": 40, "n_rows_pad": 30,
                                 "n_cols_pad": 50, "pad_to_multiple": 4}])
def test_padded_csr_identical(kw):
    rng = np.random.default_rng(2)
    args = (rng.integers(0, 23, 500).astype(np.int32),
            rng.integers(0, 41, 500).astype(np.int32),
            rng.normal(size=500).astype(np.float32), 23, 41)
    t = TSP.coo_to_padded_csr(TSP.COO(*args), as_numpy=True, **kw)
    j = JSP.coo_to_padded_csr(JSP.COO(*args), **kw)
    for f in ("idx", "val", "mask"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)))
    assert (t.n_cols, t.n_rows, t.max_nnz) == (j.n_cols, j.n_rows, j.max_nnz)
    d = TSP.coo_to_padded_csr(TSP.COO(*args), device="cpu", **kw)
    assert isinstance(d.idx, torch.Tensor) and d.idx.dtype == torch.int32
    np.testing.assert_array_equal(d.val.numpy(), t.val)


def test_tile_occupancy_and_row_live():
    rng = np.random.default_rng(4)
    nnz = rng.integers(0, 300, 32)
    nnz[[0, 9, 10]] = 0
    mask = (np.arange(512)[None] < nnz[:, None]).astype(np.float32)
    mask[5, 7] = 0.0                          # a hole inside a live row
    t = TSP.tile_occupancy(torch.from_numpy(mask), 8, 128)
    j = JSP.tile_occupancy(mask, 8, 128)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    live = TSP.row_live(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(live, nnz)


def test_permutations_identical():
    t, j = _pair("mini")
    for axis in ("row", "col"):
        np.testing.assert_array_equal(TSP.occupancy_permutation(t, axis),
                                      JSP.occupancy_permutation(j, axis))
        np.testing.assert_array_equal(TSP.balance_permutation(t, axis),
                                      JSP.balance_permutation(j, axis))
    for n in (0, 5, 64, 65, 1000):
        np.testing.assert_array_equal(TSP._round_robin_positions(n),
                                      JSP._round_robin_positions(n))
    rp, cp = TSP.balance_permutation(t), TSP.balance_permutation(t, "col")
    _eq_coo(TSP.apply_permutation(t, rp, cp),
            JSP.apply_permutation(j, rp, cp))


@pytest.mark.parametrize("preset,grid,balance", [
    ("mini", (2, 2), True), ("mini", (4, 1), False), ("mini", (3, 2), "none"),
    ("movielens", (8, 2), True)])
def test_partition_identical(preset, grid, balance):
    t, j = _pair(preset)
    tp = TPA.partition(t, *grid, balance=balance, seed=1)
    jp = JPA.partition(j, *grid, balance=balance, seed=1)
    for f in ("row_perm", "col_perm", "row_splits", "col_splits"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    for tb, jb in zip(tp.all_blocks(), jp.all_blocks()):
        assert (tb.i, tb.j, tb.phase) == (jb.i, jb.j, jb.phase)
        np.testing.assert_array_equal(tb.row_ids, jb.row_ids)
        np.testing.assert_array_equal(tb.col_ids, jb.col_ids)
        _eq_coo(tb.coo, jb.coo)
    assert TPA.nnz_balance_stats(tp) == JPA.nnz_balance_stats(jp)
    assert TPA.suggest_grid(t.n_rows, t.n_cols, 16) == \
        JPA.suggest_grid(j.n_rows, j.n_cols, 16)


def test_block_shapes_and_padding_identical():
    t, j = _pair("movielens")
    tr_t, te_t = TSP.train_test_split(t, 0.1, seed=1)
    tr_j, te_j = JSP.train_test_split(j, 0.1, seed=1)
    tp, jp = TPA.partition(tr_t, 4, 2), JPA.partition(tr_j, 4, 2)
    te_tp = TSP.apply_permutation(te_t, tp.row_perm, tp.col_perm)
    te_jp = JSP.apply_permutation(te_j, jp.row_perm, jp.col_perm)
    ts, js = TPP.BlockShapes.per_phase(tp, te_tp), \
        JPP.BlockShapes.per_phase(jp, te_jp)
    assert {k: v.astuple() for k, v in ts.items()} == \
        {k: v.astuple() for k, v in js.items()}
    assert {k: v.astuple() for k, v in
            TPP.BlockShapes.coalesce(ts, 10).items()} == \
        {k: v.astuple() for k, v in JPP.BlockShapes.coalesce(js, 10).items()}
    assert ts["c"].block_bytes(10) == js["c"].block_bytes(10)
    tb, jb = tp.block(2, 1), jp.block(2, 1)
    host_t = TPP.pad_block_inputs_host(tb, ts["c"], te_tp)
    host_j = JPP.pad_block_inputs_host(jb, js["c"], te_jp)
    for a, b in zip(host_t[:2], host_j[:2]):
        for f in ("idx", "val", "mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(host_t[2:], host_j[2:]):
        np.testing.assert_array_equal(a, b)
    # the device padding (slot layout scattered on the device) equals the
    # host planes
    dev = TPP.pad_block_inputs(tb, ts["c"], 10, te_tp, None, None,
                               device="cpu")
    for a, b in zip(dev[:2], host_t[:2]):
        for f in ("idx", "val", "mask"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f))
    for a, b in zip(dev[2:6], host_t[2:]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_coalesce_shapes_identical():
    shapes = {"a": (10, 4, 30, 7, 5), "b": (12, 4, 28, 7, 5),
              "c": (100, 40, 3, 2, 1), "d": (9, 5, 31, 6, 5)}
    fp = lambda s: float(np.prod(s))      # noqa: E731
    for w in (1.0, 1.5, 10.0):
        assert TPA.coalesce_shapes(shapes, fp, w) == \
            JPA.coalesce_shapes(shapes, fp, w)
