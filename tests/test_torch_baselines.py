"""The port's Table 2 baselines (``repro_torch.baselines``: ALS, CCD++,
blocked SGD) against the reference on the same data and initial factors.

The initial factors cross over through a noise tape that replays
``repro.core.bmf.init_factors``' key split (``split(key)`` → normal
(N, K) / (D, K)). ALS (dense path) and CCD++ must give the reference's
test predictions within 1e-5 relative; SGD within 1e-4 after a few
epochs (its duplicate-row scatter-adds sum in another order). Each, as
``tests/test_baselines.py`` asks, beats 0.9 × the mean predictor. ALS
through kernel B1 (``use_kernel=True``) must agree with its dense path;
the ``cuda`` legs hold the card's B1 path and the graphed SGD rounds to
the CPU.
"""
import numpy as np
import pytest

from repro_torch.baselines import als as TALS
from repro_torch.baselines import ccd as TCCD
from repro_torch.baselines import sgd as TSGD
from repro_torch.data import synthetic as TSYN
from repro_torch.data.sparse import coo_to_padded_csr, train_test_split
from repro_torch.noise import TapeNoise
from torch_helpers import (assert_rel_close, cuda_device,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
SGD_RTOL = 1e-4


@pytest.fixture(scope="module")
def data():
    coo, p = TSYN.generate("mini", seed=7)
    train, test = train_test_split(coo, 0.15, seed=8)
    csr_r = coo_to_padded_csr(train, device="cpu")
    csr_c = coo_to_padded_csr(train.transpose(), device="cpu")
    base = float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))
    return train, test, csr_r, csr_c, base, p.K


@pytest.fixture(scope="module")
def reference(data):
    """The reference's inputs, its key, and the tape of its initial
    standard normals."""
    import jax
    import jax.numpy as jnp
    from repro.data.sparse import coo_to_padded_csr as jcsr
    train, test, _, _, _, K = data
    key = jax.random.key(0)
    ku, kv = jax.random.split(key)
    tape = {("init", "U"): np.asarray(jax.random.normal(
                ku, (train.n_rows, K), jnp.float32)),
            ("init", "V"): np.asarray(jax.random.normal(
                kv, (train.n_cols, K), jnp.float32))}
    return dict(key=key, tape=tape, csr_r=jcsr(train),
                csr_c=jcsr(train.transpose()), tr=jnp.asarray(test.row),
                tc=jnp.asarray(test.col))


def _rmse(pred, test):
    return float(np.sqrt(np.mean((np.asarray(pred) - test.val) ** 2)))


def _noise(reference):
    return TapeNoise([reference["tape"]], "cpu")


def test_als_matches_reference(data, reference):
    from repro.baselines import als as JALS
    train, test, csr_r, csr_c, base, K = data
    _, _, want = JALS.run_als(reference["key"], reference["csr_r"],
                              reference["csr_c"], reference["tr"],
                              reference["tc"], JALS.ALSConfig(K=K, n_iters=15))
    _, _, got = TALS.run_als(_noise(reference), csr_r, csr_c, test.row,
                             test.col, TALS.ALSConfig(K=K, n_iters=15),
                             device="cpu")
    assert_rel_close(got.numpy(), np.asarray(want), RTOL)
    assert _rmse(got, test) < 0.9 * base


def test_ccd_matches_reference(data, reference):
    from repro.baselines import ccd as JCCD
    train, test, csr_r, csr_c, base, K = data
    _, _, want = JCCD.run_ccd(reference["key"], reference["csr_r"],
                              reference["csr_c"], reference["tr"],
                              reference["tc"], JCCD.CCDConfig(K=K, n_iters=12))
    _, _, got = TCCD.run_ccd(_noise(reference), csr_r, csr_c, test.row,
                             test.col, TCCD.CCDConfig(K=K, n_iters=12),
                             device="cpu")
    assert_rel_close(got.numpy(), np.asarray(want), RTOL)
    assert _rmse(got, test) < 0.9 * base


def test_ccd_row_stripes_change_nothing(data, monkeypatch):
    """CCD++'s update is row-local: computing it in stripes of a few rows
    must give the one-stripe result."""
    train, test, csr_r, csr_c, _, K = data
    cfg = TCCD.CCDConfig(K=K, n_iters=2)
    _, _, whole = TCCD.run_ccd(3, csr_r, csr_c, test.row, test.col, cfg,
                               device="cpu")
    monkeypatch.setattr(TCCD, "STRIPE_ELEMS", 7 * csr_r.max_nnz * K)
    _, _, striped = TCCD.run_ccd(3, csr_r, csr_c, test.row, test.col, cfg,
                                 device="cpu")
    assert_rel_close(striped.numpy(), whole.numpy(), RTOL)


def test_sgd_block_schedule_matches_reference(data):
    from repro.baselines import sgd as JSGD
    train = data[0]
    for B in (1, 3, 4):
        for got, want in zip(TSGD._block_schedule(train, B),
                             JSGD._block_schedule(train, B)):
            np.testing.assert_array_equal(got, want)


def test_sgd_matches_reference(data, reference):
    from repro.baselines import sgd as JSGD
    train, test, _, _, _, K = data
    _, _, want = JSGD.run_sgd(reference["key"], train, reference["tr"],
                              reference["tc"], JSGD.SGDConfig(K=K, n_epochs=4))
    _, _, got = TSGD.run_sgd(_noise(reference), train, test.row, test.col,
                             TSGD.SGDConfig(K=K, n_epochs=4), device="cpu")
    assert_rel_close(got.numpy(), np.asarray(want), SGD_RTOL)


def test_sgd_beats_mean_predictor(data):
    train, test, _, _, base, K = data
    _, _, pred = TSGD.run_sgd(0, train, test.row, test.col,
                              TSGD.SGDConfig(K=K, n_epochs=40), device="cpu")
    assert _rmse(pred, test) < 0.9 * base


def test_als_kernel_path_matches_dense(data):
    """``use_kernel=True`` routes the sufficient statistics through B1's
    wrapper (its plain version on a CPU tensor)."""
    train, test, csr_r, csr_c, _, K = data
    preds = [TALS.run_als(0, csr_r, csr_c, test.row, test.col,
                          TALS.ALSConfig(K=K, n_iters=5, use_kernel=uk),
                          device="cpu")[2] for uk in (False, True)]
    assert_rel_close(preds[1].numpy(), preds[0].numpy(), RTOL)


@pytest.mark.cuda
def test_cuda_als_b1_matches_dense(data, cuda_device):
    """On the card: ALS through kernel B1 on the whole matrix's padded
    CSR against ALS on the dense path, and against the CPU."""
    from repro_torch.kernels.bmf_precision import ops as B1
    train, test, csr_r, csr_c, base, K = data
    cfg = TALS.ALSConfig(K=K, n_iters=10)
    n0 = B1.precision_accum.launches
    kern = TALS.run_als(0, csr_r, csr_c, test.row, test.col,
                        cfg._replace(use_kernel=True),
                        device=cuda_device)[2].cpu()
    assert B1.precision_accum.launches - n0 == 2 * cfg.n_iters
    dense = TALS.run_als(0, csr_r, csr_c, test.row, test.col, cfg,
                         device=cuda_device)[2].cpu()
    assert_rel_close(kern.numpy(), dense.numpy(), RTOL)
    assert _rmse(kern, test) < 0.9 * base


@pytest.mark.cuda
def test_cuda_sgd_graph_matches_cpu(data, cuda_device):
    """The card runs each round's minibatch loop as a CUDA graph replay;
    it must match the CPU's eager loop from the same initial factors."""
    train, test, _, _, _, K = data
    cfg = TSGD.SGDConfig(K=K, n_epochs=4)
    cpu = TSGD.run_sgd(0, train, test.row, test.col, cfg, device="cpu")[2]
    # the same initial factors: a tape of the CPU generator's draws
    U0, V0 = TALS.init_factors(0, train.n_rows, train.n_cols, K, "cpu",
                               scale=1.0)
    tape = TapeNoise([{("init", "U"): U0.numpy(), ("init", "V"): V0.numpy()}],
                     cuda_device)
    gpu = TSGD.run_sgd(tape, train, test.row, test.col, cfg,
                       device=cuda_device)[2].cpu()
    assert_rel_close(gpu.numpy(), cpu.numpy(), SGD_RTOL)
