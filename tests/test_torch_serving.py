"""The port's serving layer (``repro_torch.serving``, ``launch.bmf_serve``)
against the reference and against its own battery.

Against the reference (JAX, CPU, the same numpy inputs): ``_project_pd``,
``_posterior_mean`` and ``_build_store`` fed the reference's slot noise
(1e-5 relative), and ``score_topk`` in both modes, the port's batch
carrying the draws the reference derives from the same ``key_data``
(ids equal, scores 1e-5 relative). ``build_requests`` and the router's
bucket plan must be equal.

The battery ports ``tests/test_serving.py``: top-K parity against a dense
numpy brute force whose tie-break (lowest index wins) is ``lax.top_k``'s,
across k > unseen, all items seen, bitwise-duplicate scores and the
empty-history cold start; fold-in personalization; Thompson selection
frequencies against analytic win probabilities (atol 0.03); mean-mode
determinism; the store round trip for every executor of the port's
registry; the router's rules; and the CLI.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch import serving as SRV
from repro_torch.core import bmf as TB
from repro_torch.core import engine as TENG
from repro_torch.core import pp as TPP
from repro_torch.core.partition import partition
from repro_torch.core.posterior import RowGaussians
from repro_torch.data import synthetic as TSYN
from repro_torch.data.sparse import train_test_split
from repro_torch.launch import bmf_serve as TSERVE
from repro_torch.serving import scoring as SCORE
from repro_torch.serving import store as STORE
from torch_helpers import (assert_rel_close, cuda_device,  # noqa: F401
                           np_tree, one_torch_thread)

pytestmark = [pytest.mark.serving, pytest.mark.usefixtures("one_torch_thread")]

EXECUTOR_NAMES = sorted(TENG.EXECUTORS)
RTOL = 1e-5
# exact power of two: scale/rescale by PREC is bitwise-lossless in f32,
# so direct stores built from means reproduce those means exactly
PREC = float(2 ** 26)


def direct_fields(U_mean, V_mean, n_slots=3, tau=2.0, V_samples=None,
                  U_Lambda=None):
    """numpy fields of a store with posteriors concentrated at the given
    means (Λ = PREC·I unless ``U_Lambda`` overrides the user side) and
    item sample slots that copy V_mean unless ``V_samples`` is given."""
    U_mean = np.asarray(U_mean, np.float32)
    V_mean = np.asarray(V_mean, np.float32)
    (N, K), M = U_mean.shape, V_mean.shape[0]
    eyeK = np.eye(K, dtype=np.float32)
    if U_Lambda is None:
        U = dict(eta=PREC * U_mean,
                 Lambda=np.broadcast_to(PREC * eyeK, (N, K, K)))
    else:
        U_Lambda = np.asarray(U_Lambda, np.float32)
        U = dict(eta=np.einsum("nkl,nl->nk", U_Lambda, U_mean),
                 Lambda=U_Lambda)
    V = dict(eta=PREC * V_mean, Lambda=np.broadcast_to(PREC * eyeK, (M, K, K)))
    if V_samples is None:
        V_samples = np.broadcast_to(V_mean, (n_slots, M, K))
    return dict(U=U, V=V, U_mean=U_mean, V_mean=V_mean,
                V_samples=np.asarray(V_samples, np.float32),
                tau=np.float32(tau))


def direct_store(*args, **kw):
    return CV.posterior_store_from_numpy(direct_fields(*args, **kw),
                                         device="cpu")


def batch_arrays(user_ids, seen=None, L=8, fold=None, F=2, seed=0):
    """Fixed-shape request arrays (numpy) from ragged seen/fold lists, and
    per-request key data as the reference's ``make_batch`` draws it."""
    B = len(user_ids)
    seen = seen or [[] for _ in range(B)]
    fold = fold or [[] for _ in range(B)]
    s_idx = np.zeros((B, L), np.int32)
    s_msk = np.zeros((B, L), np.float32)
    f_idx = np.zeros((B, F), np.int32)
    f_val = np.zeros((B, F), np.float32)
    f_msk = np.zeros((B, F), np.float32)
    for i in range(B):
        ns = len(seen[i])
        s_idx[i, :ns] = seen[i]
        s_msk[i, :ns] = 1.0
        for j, (it, rt) in enumerate(fold[i]):
            f_idx[i, j], f_val[i, j], f_msk[i, j] = it, rt, 1.0
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (B, 2),
                                              dtype=np.uint32)
    return dict(user_ids=np.asarray(user_ids, np.int32), seen_idx=s_idx,
                seen_mask=s_msk, fold_idx=f_idx, fold_val=f_val,
                fold_mask=f_msk), kd


def port_batch(arrays, K, n_slots, seed=0, z=None, slot=None):
    """The port's RequestBatch: Thompson draws from a numpy generator
    unless given."""
    B = len(arrays["user_ids"])
    rng = np.random.default_rng(seed + 1000)
    if z is None:
        z = rng.standard_normal((B, K), dtype=np.float32)
    if slot is None:
        slot = rng.integers(0, n_slots, B)
    return SRV.RequestBatch(
        **{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()},
        z=torch.from_numpy(np.array(z, np.float32)),
        slot=torch.from_numpy(np.array(slot, np.int64)))


def make_batch(store, user_ids, seen=None, L=8, fold=None, F=2, seed=0):
    arrays, _ = batch_arrays(user_ids, seen, L, fold, F, seed)
    return port_batch(arrays, store.K, store.n_slots, seed)


def jax_draws(key_data, K, n_slots):
    """The per-request draws the reference's thompson mode derives from
    ``key_data``: z = normal(fold_in(key, 0), (K,)), slot =
    randint(fold_in(key, 1), (), 0, S)."""
    import jax
    keys = jax.random.wrap_key_data(key_data)
    kz = jax.vmap(jax.random.fold_in, (0, None))(keys, 0)
    ks = jax.vmap(jax.random.fold_in, (0, None))(keys, 1)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (K,)))(kz)
    slot = jax.vmap(lambda kk: jax.random.randint(kk, (), 0, n_slots))(ks)
    return np.asarray(z), np.asarray(slot)


def jax_store(fields):
    import jax.numpy as jnp
    from repro import serving as JSRV
    from repro.core.posterior import RowGaussians as JRG
    a = {k: jnp.asarray(v) for k, v in fields.items()
         if k not in ("U", "V")}
    return JSRV.PosteriorStore(
        U=JRG(**{k: jnp.asarray(v) for k, v in fields["U"].items()}),
        V=JRG(**{k: jnp.asarray(v) for k, v in fields["V"].items()}), **a)


def brute_topk(scores, seen, k):
    """Dense numpy reference: stable sort by (-score, index)."""
    s = np.array(scores, np.float32, copy=True)
    if len(seen):
        s[np.asarray(seen, int)] = -np.inf
    order = np.lexsort((np.arange(len(s)), -s))
    ids = order[:k].astype(np.int32)
    return ids, s[ids]


def raw_scores(store, user_id, batch_like):
    """Full unmasked score vector through the same batch shape (mask
    zeroed, k = M), so parity compares selection semantics bitwise."""
    b = batch_like._replace(
        user_ids=torch.tensor([user_id], dtype=torch.int32),
        seen_mask=torch.zeros_like(batch_like.seen_mask))
    out = SRV.score_topk(store, b, k=store.n_items, mode="mean")
    full = np.empty(store.n_items, np.float32)
    full[out.ids[0].numpy()] = out.scores[0].numpy()
    return full


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _sym_indefinite(rng, n, K):
    A = rng.normal(size=(n, K, K)).astype(np.float32)
    return (A + np.swapaxes(A, -1, -2)) / 2 - 0.5 * np.eye(K, dtype=np.float32)


def test_project_pd_matches_reference():
    import jax.numpy as jnp
    from repro.serving import store as JSTORE
    rng = np.random.default_rng(0)
    lam = _sym_indefinite(rng, 64, 6)
    lam[:4] = np.diag([5.0, -2.0, 1.0, 0.5, 3.0, 1e-9]).astype(np.float32)
    want = np.asarray(JSTORE._project_pd(jnp.asarray(lam)))
    got = STORE._project_pd(torch.from_numpy(lam)).numpy()
    assert_rel_close(got, want, RTOL)
    assert (np.linalg.eigvalsh(got.astype(np.float64)) > 0).all()


def test_posterior_mean_matches_reference():
    import jax.numpy as jnp
    from repro.core.posterior import RowGaussians as JRG
    from repro.serving import store as JSTORE
    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 5, 5)).astype(np.float32)
    lam = A @ np.swapaxes(A, -1, -2) + np.eye(5, dtype=np.float32)
    eta = rng.normal(size=(40, 5)).astype(np.float32)
    want = JSTORE._posterior_mean(JRG(eta=jnp.asarray(eta),
                                      Lambda=jnp.asarray(lam)), 1e-6)
    got = STORE._posterior_mean(RowGaussians(eta=torch.from_numpy(eta),
                                             Lambda=torch.from_numpy(lam)),
                                1e-6)
    assert_rel_close(got.numpy(), np.asarray(want), RTOL)


@pytest.fixture(scope="module")
def ref_built():
    """One store built by the reference's ``_build_store`` from random
    aggregates (some rows indefinite) under random permutations, and the
    same inputs for the port, with the reference's slot noise."""
    import jax
    import jax.numpy as jnp
    from repro.core.posterior import RowGaussians as JRG
    from repro.serving import store as JSTORE
    rng = np.random.default_rng(2)
    N, M, K, S = 30, 25, 4, 3
    side = {}
    for name, n in (("U", N), ("V", M)):
        A = rng.normal(size=(n, K, K)).astype(np.float32)
        lam = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(K, dtype=np.float32)
        lam[::5] = _sym_indefinite(rng, len(lam[::5]), K)
        side[name] = dict(eta=rng.normal(size=(n, K)).astype(np.float32),
                          Lambda=lam)
    row_perm, col_perm = rng.permutation(N), rng.permutation(M)
    key = jax.random.key(9)
    ref = JSTORE._build_store(
        JRG(**{k: jnp.asarray(v) for k, v in side["U"].items()}),
        JRG(**{k: jnp.asarray(v) for k, v in side["V"].items()}),
        jnp.asarray(row_perm, jnp.int32), jnp.asarray(col_perm, jnp.int32),
        jnp.asarray(2.0, jnp.float32), key, n_slots=S, jitter=1e-6)
    z = np.stack([np.asarray(jax.random.normal(kk, (M, K), jnp.float32))
                  for kk in jax.random.split(key, S)])
    port = STORE._build_store(
        CV.row_gaussians_from_numpy(side["U"], "cpu"),
        CV.row_gaussians_from_numpy(side["V"], "cpu"),
        torch.from_numpy(row_perm), torch.from_numpy(col_perm),
        torch.tensor(2.0), torch.from_numpy(z), jitter=1e-6)
    return np_tree(ref._asdict()), port


def test_build_store_matches_reference(ref_built):
    ref, port = ref_built
    got = CV.posterior_store_to_numpy(port)
    for f in ("U_mean", "V_mean", "V_samples", "tau"):
        assert_rel_close(got[f], ref[f], RTOL)
    for s in ("U", "V"):
        np.testing.assert_array_equal(got[s]["eta"], np.asarray(ref[s].eta))
        assert_rel_close(got[s]["Lambda"], np.asarray(ref[s].Lambda), RTOL)


@pytest.mark.parametrize("mode", SCORE.MODES)
def test_score_topk_matches_reference(ref_built, mode):
    """Both packages score the reference's store: a warm user, a masked
    one and a cold start folding two ratings; the port's batch carries
    the draws the reference derives from the same key data."""
    import jax.numpy as jnp
    from repro import serving as JSRV
    ref, _ = ref_built
    fields = {k: ({"eta": v.eta, "Lambda": v.Lambda} if k in ("U", "V")
                  else v) for k, v in ref.items()}
    store = CV.posterior_store_from_numpy(fields, device="cpu")
    arrays, kd = batch_arrays([0, 7, -1, 29], seen=[[1, 2], [], [5], [0]],
                              L=4, fold=[[], [(3, 4.0)], [(5, 5.0),
                                                          (9, 1.0)], []],
                              seed=3)
    z, slot = jax_draws(kd, store.K, store.n_slots)
    out = SRV.score_topk(store, port_batch(arrays, store.K, store.n_slots,
                                           z=z, slot=slot), k=6, mode=mode)
    jb = JSRV.RequestBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                           key_data=jnp.asarray(kd))
    want = JSRV.score_topk(jax_store(fields), jb, k=6, mode=mode)
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(want.valid))
    assert_rel_close(out.scores.numpy(), np.asarray(want.scores), RTOL)


def test_posterior_store_numpy_round_trip(ref_built):
    _, port = ref_built
    back = CV.posterior_store_from_numpy(CV.posterior_store_to_numpy(port),
                                         device="cpu")
    for a, b in zip(CV.to_numpy(back).values(), CV.to_numpy(port).values()):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            np.testing.assert_array_equal(x, y)


def test_build_requests_matches_reference():
    from repro.launch import bmf_serve as JSERVE
    coo, _ = TSYN.generate("mini", seed=0)
    train, _ = train_test_split(coo, 0.1, seed=1)
    got = TSERVE.build_requests(train, 200, 16, seed=4)
    want = JSERVE.build_requests(train, 200, 16, seed=4)
    assert [(r.user_id, list(r.seen)) for r in got] == \
        [(r.user_id, list(r.seen)) for r in want]


def test_router_caps_and_plan():
    """The default ladder coalesces under the reference's plan cap (8),
    into the reference's plan, from a shape-only (meta) store; over-cap
    and mismatched requests raise."""
    from repro.launch.bmf_lint import SERVE_DIMS as d
    from repro.serving import router as JROUTE
    from repro.serving import scoring as JSCORE
    store = STORE.abstract_store(d["n_users"], d["n_items"], d["K"],
                                 d["n_slots"])
    assert store.V_mean.device.type == "meta"
    r = SRV.MicroBatchRouter(store, max_batch=32, max_seen=64, max_fold=8)
    ref = JROUTE.MicroBatchRouter(
        JSCORE.abstract_store(d["n_users"], d["n_items"], d["K"],
                              d["n_slots"]),
        max_batch=32, max_seen=64, max_fold=8)
    assert r.bucket_table == ref.bucket_table
    assert 1 <= len(r.plan_signatures) <= 8
    assert all(s in r.plan_signatures for s in r.bucket_table.values())
    b1 = r.bucket_for(1, 0, 0)
    b2 = r.bucket_for(32, 64, 8)
    assert all(a <= b for a, b in zip(b1, b2))
    with pytest.raises(ValueError, match="exceeds"):
        r.submit(SRV.Request(user_id=0, seen=list(range(65))))
    with pytest.raises(ValueError, match="mismatch"):
        r.submit(SRV.Request(user_id=0, fold_items=[1], fold_ratings=[]))
    with pytest.raises(ValueError, match="unknown scoring mode"):
        SRV.MicroBatchRouter(store, mode="greedy")
    assert SCORE.scoring_budget(d["n_users"], d["n_items"], d["K"],
                                d["batch"], d["n_slots"]) == \
        JSCORE.scoring_budget(d["n_users"], d["n_items"], d["K"],
                              d["batch"], d["n_slots"])


# ---------------------------------------------------------------------------
# top-K parity battery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity_store():
    rng = np.random.default_rng(11)
    N, M, K = 6, 12, 3
    return direct_store(rng.normal(size=(N, K)), rng.normal(size=(M, K)))


def _assert_parity(store, user, seen, k, L=12):
    batch = make_batch(store, [user], seen=[list(seen)], L=L)
    out = SRV.score_topk(store, batch, k=k, mode="mean")
    full = raw_scores(store, user, batch)
    ref_ids, ref_scores = brute_topk(full, seen, k)
    np.testing.assert_array_equal(out.ids[0].numpy(), ref_ids)
    np.testing.assert_array_equal(out.scores[0].numpy(), ref_scores)
    np.testing.assert_array_equal(out.valid[0].numpy(), ref_scores > -np.inf)


def test_parity_unmasked_and_random_seen(parity_store):
    _assert_parity(parity_store, user=0, seen=[], k=5)
    rng = np.random.default_rng(3)
    for case in range(10):
        seen = rng.choice(12, size=rng.integers(0, 9), replace=False)
        _assert_parity(parity_store, user=int(case % 6), seen=seen,
                       k=int(rng.integers(1, 12)))


def test_parity_k_exceeds_unseen(parity_store):
    # 10 of 12 items seen, k=5 > 2 scorable: exactly two valid slots, the
    # -inf tail ordered by index
    seen = list(range(10))
    batch = make_batch(parity_store, [1], seen=[seen], L=12)
    out = SRV.score_topk(parity_store, batch, k=5, mode="mean")
    assert int(out.valid[0].sum()) == 2
    _assert_parity(parity_store, user=1, seen=seen, k=5)


def test_parity_all_items_seen(parity_store):
    seen = list(range(12))
    batch = make_batch(parity_store, [2], seen=[seen], L=12)
    out = SRV.score_topk(parity_store, batch, k=4, mode="mean")
    assert not out.valid.any()
    _assert_parity(parity_store, user=2, seen=seen, k=4)


def test_parity_duplicate_scores_tie_break():
    # items 0..3 are bitwise-identical factor rows => bitwise-equal
    # scores; the winner among ties must be the LOWEST index
    rng = np.random.default_rng(5)
    v = rng.normal(size=(1, 3))
    V = np.concatenate([np.repeat(v, 4, axis=0),
                        rng.normal(size=(4, 3))], axis=0)
    store = direct_store(rng.normal(size=(2, 3)), V)
    _assert_parity(store, user=0, seen=[], k=8, L=8)
    _assert_parity(store, user=1, seen=[0, 2], k=6, L=8)


def test_parity_cold_start_empty_history(parity_store):
    # user_id = -1, nothing seen, nothing folded: identity prior => zero
    # mean => all scores tie at 0.0 and the top-K is [0..k-1], all valid
    batch = make_batch(parity_store, [-1], L=12)
    out = SRV.score_topk(parity_store, batch, k=5, mode="mean")
    np.testing.assert_array_equal(out.ids[0].numpy(), np.arange(5))
    np.testing.assert_array_equal(out.scores[0].numpy(), np.zeros(5))
    assert out.valid.all()
    _assert_parity(parity_store, user=-1, seen=[], k=5)


def test_cold_start_fold_in_personalizes():
    rng = np.random.default_rng(7)
    V = 0.1 * rng.normal(size=(6, 4)).astype(np.float32)
    V[0] = [2.0, 0.0, 0.0, 0.0]
    V[3] = V[0]                       # item 3 duplicates item 0
    store = direct_store(rng.normal(size=(2, 4)), V)
    batch = make_batch(store, [-1], seen=[[0]], L=4, fold=[[(0, 5.0)]], F=2)
    out = SRV.score_topk(store, batch, k=2, mode="mean")
    assert int(out.ids[0, 0]) == 3    # the unseen duplicate wins
    assert out.valid[0].all()


def test_score_topk_rejects_unknown_mode(parity_store):
    batch = make_batch(parity_store, [0], L=4)
    with pytest.raises(ValueError, match="unknown scoring mode"):
        SRV.score_topk(parity_store, batch, k=3, mode="map")


# ---------------------------------------------------------------------------
# Thompson statistics
# ---------------------------------------------------------------------------


def _phi(x):
    return np.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


_erf = np.vectorize(math.erf)


def _Phi(x):
    return 0.5 * (1.0 + _erf(x / math.sqrt(2.0)))


def _thompson_freqs(store, n_draws, chunk=1000, seed=0):
    M = store.n_items
    counts = np.zeros(M)
    for i, lo in enumerate(range(0, n_draws, chunk)):
        B = min(chunk, n_draws - lo)
        batch = make_batch(store, [0] * B, L=2, F=1, seed=seed + i)
        out = SRV.score_topk(store, batch, k=1, mode="thompson")
        counts += np.bincount(out.ids[:, 0].numpy(), minlength=M)
    return counts / n_draws


def test_thompson_frequencies_match_analytic_win_probs():
    """Orthogonal item axes => scores are independent normals with known
    means/sds; per-item top-1 frequencies over 4000 draws must match
    P(i) = ∫ φ_i(x) Π_{j≠i} Φ_j(x) dx."""
    K = 4
    c = np.array([1.0, 1.5, 0.8, 1.2], np.float32)
    V = (np.eye(K) * c[:, None]).astype(np.float32)      # v_i = c_i e_i
    mu = np.array([[0.5, 0.2, 0.9, 0.4]], np.float32)
    prec = np.array([4.0, 2.0, 6.0, 3.0], np.float32)
    store = direct_store(mu, V, U_Lambda=np.diag(prec)[None])
    means = c * mu[0]
    sds = c / np.sqrt(prec)

    x = np.linspace((means - 8 * sds).min(), (means + 8 * sds).max(), 20001)
    pdf = _phi((x[None] - means[:, None]) / sds[:, None]) / sds[:, None]
    cdf = _Phi((x[None] - means[:, None]) / sds[:, None])
    probs = np.empty(K)
    for i in range(K):
        others = np.prod(np.delete(cdf, i, axis=0), axis=0)
        probs[i] = np.trapezoid(pdf[i] * others, x)
    assert abs(probs.sum() - 1.0) < 1e-6

    freqs = _thompson_freqs(store, n_draws=4000, seed=21)
    np.testing.assert_allclose(freqs, probs, atol=0.03)


def test_thompson_frequencies_correlated_pair():
    """Two non-orthogonal items: P(item 0 wins) = Φ((m0 - m1) / sd(s0 -
    s1))."""
    v0 = np.array([1.0, 0.6], np.float32)
    v1 = np.array([0.4, 1.1], np.float32)
    V = np.stack([v0, v1])
    mu = np.array([[0.3, 0.5]], np.float32)
    prec = np.array([3.0, 5.0], np.float32)
    store = direct_store(mu, V, U_Lambda=np.diag(prec)[None])
    d = v0 - v1
    m = float(d @ mu[0])
    sd = float(np.sqrt(d @ np.diag(1.0 / prec) @ d))
    p0 = float(_Phi(np.asarray(m / sd)))

    freqs = _thompson_freqs(store, n_draws=4000, seed=22)
    np.testing.assert_allclose(freqs[0], p0, atol=0.03)


def test_mean_mode_bitwise_deterministic():
    rng = np.random.default_rng(9)
    store = direct_store(rng.normal(size=(5, 4)), rng.normal(size=(9, 4)))
    batch = make_batch(store, [0, 3, -1], seen=[[1], [], [4, 5]], L=4,
                       seed=1)
    out1 = SRV.score_topk(store, batch, k=4, mode="mean")
    out2 = SRV.score_topk(store, batch, k=4, mode="mean")
    # other draws must not matter either: mean mode reads none
    out3 = SRV.score_topk(
        store, batch._replace(z=torch.zeros_like(batch.z),
                              slot=torch.zeros_like(batch.slot)),
        k=4, mode="mean")
    for o in (out2, out3):
        np.testing.assert_array_equal(out1.ids.numpy(), o.ids.numpy())
        np.testing.assert_array_equal(out1.scores.numpy(), o.scores.numpy())


# ---------------------------------------------------------------------------
# store construction: round trip over the executor registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pp_results():
    coo, p = TSYN.generate("mini", seed=13)
    train, test = train_test_split(coo, 0.15, seed=14)
    cfg = TB.BMFConfig(K=p.K, n_samples=5, burnin=1)
    part = partition(train, 3, 3)          # covers all four phase tags
    cache = {}

    def get(name):
        if name not in cache:
            ex = TENG.make_executor(
                name, window=2 if name == "streaming" else None)
            cache[name] = TPP.run_pp(5, part, cfg, test, executor=ex,
                                     device="cpu")
        return cache[name]

    return get


def test_registry_coverage():
    assert set(EXECUTOR_NAMES) == set(TENG.EXECUTORS)


@pytest.mark.parametrize("name", EXECUTOR_NAMES)
def test_store_roundtrip_bitwise(pp_results, name):
    """``from_pp_result`` must equal a store built from posteriors
    gathered in numpy (identity permutation) with the same slot noise,
    bitwise, field by field and in the scores both modes serve."""
    res = pp_results(name)
    store = SRV.PosteriorStore.from_pp_result(res, seed=17, n_slots=2)
    np.testing.assert_array_equal(
        store.U.eta.numpy(), res.U_agg.eta.numpy()[res.row_perm])
    np.testing.assert_array_equal(
        store.V.eta.numpy(), res.V_agg.eta.numpy()[res.col_perm])

    def host(g, perm):
        return RowGaussians(eta=torch.from_numpy(g.eta.numpy()[perm]),
                            Lambda=torch.from_numpy(g.Lambda.numpy()[perm]))

    M, K = store.V_mean.shape
    z = torch.randn((2, M, K), generator=torch.Generator().manual_seed(17))
    ref = STORE._build_store(host(res.U_agg, res.row_perm),
                             host(res.V_agg, res.col_perm),
                             torch.arange(store.n_users),
                             torch.arange(store.n_items),
                             torch.tensor(float(res.tau)), z, jitter=1e-6)
    got, want = CV.to_numpy(store), CV.to_numpy(ref)
    for f in ("U", "V"):
        for part in ("eta", "Lambda"):
            np.testing.assert_array_equal(got[f][part], want[f][part])
    for f in ("U_mean", "V_mean", "V_samples", "tau"):
        np.testing.assert_array_equal(got[f], want[f])

    batch = make_batch(store, [0, 7, -1], seen=[[1, 2], [], [5]], L=4,
                       seed=2)
    for mode in SCORE.MODES:
        out = SRV.score_topk(store, batch, k=5, mode=mode)
        out_ref = SRV.score_topk(ref, batch, k=5, mode=mode)
        np.testing.assert_array_equal(out.ids.numpy(), out_ref.ids.numpy())
        np.testing.assert_array_equal(out.scores.numpy(),
                                      out_ref.scores.numpy())
        assert torch.isfinite(out.scores[out.valid]).all()


def test_store_sanitizes_indefinite_precisions():
    """Divide-away aggregation can leave indefinite per-row precisions;
    the store build must project them PD so every serving Cholesky is
    finite."""
    rng = np.random.default_rng(31)
    K = 4
    Lam = np.stack([np.eye(K, dtype=np.float32) * 3.0,
                    np.diag([5.0, -2.0, 1.0, 0.5]).astype(np.float32),
                    rng.normal(size=(K, K)).astype(np.float32)])
    Lam[2] = (Lam[2] + Lam[2].T) / 2 - 2 * np.eye(K, dtype=np.float32)
    g = RowGaussians(eta=torch.from_numpy(
        rng.normal(size=(3, K)).astype(np.float32)),
        Lambda=torch.from_numpy(Lam))
    z = torch.randn((2, 3, K), generator=torch.Generator().manual_seed(0))
    st = STORE._build_store(g, g, torch.arange(3), torch.arange(3),
                            torch.tensor(2.0), z, jitter=1e-6)
    for side in (st.U, st.V):
        ev = np.linalg.eigvalsh(side.Lambda.numpy())
        assert (ev > 0).all(), ev
    assert torch.isfinite(st.U_mean).all()
    assert torch.isfinite(st.V_samples).all()


def test_from_pp_result_rejects_pre_seam_results(pp_results):
    res = dataclasses.replace(pp_results("serial"), row_perm=None)
    with pytest.raises(ValueError, match="serving export seam"):
        SRV.PosteriorStore.from_pp_result(res)


# ---------------------------------------------------------------------------
# micro-batching router
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def router_store():
    rng = np.random.default_rng(23)
    return direct_store(rng.normal(size=(8, 4)), rng.normal(size=(20, 4)))


def test_router_latency_budget_rule(router_store):
    r = SRV.MicroBatchRouter(router_store, k=3, latency_budget_s=0.01,
                             max_batch=4, max_seen=8, max_fold=2)
    t1 = r.submit(SRV.Request(user_id=1, seen=[2]), now=0.0)
    t2 = r.submit(SRV.Request(user_id=2), now=0.004)
    assert not t1.done and r.poll(now=0.009) == 0      # budget not hit
    assert r.poll(now=0.010) == 2                      # oldest waited 10ms
    assert t1.done and t2.done
    assert t1.latency_s == pytest.approx(0.010)
    assert t2.latency_s == pytest.approx(0.006)
    assert len(r.dispatches) == 1 and r.dispatches[0][1] == 2


def test_router_full_batch_dispatches_immediately(router_store):
    r = SRV.MicroBatchRouter(router_store, k=3, latency_budget_s=10.0,
                             max_batch=3, max_seen=8, max_fold=2)
    ts = [r.submit(SRV.Request(user_id=i), now=0.0) for i in range(3)]
    assert all(t.done for t in ts)                     # no budget wait
    assert r.dispatches[0][1] == 3


def test_router_padding_is_invisible(router_store):
    """A partially-filled bucket (3 real requests padded to 4) must serve
    results bitwise-equal to a hand-built padded batch of that shape."""
    reqs = [SRV.Request(user_id=0, seen=[1, 2]),
            SRV.Request(user_id=5),
            SRV.Request(user_id=-1, fold_items=[3], fold_ratings=[4.0])]
    r = SRV.MicroBatchRouter(router_store, k=4, mode="mean",
                             latency_budget_s=0.0, max_batch=4,
                             max_seen=8, max_fold=2)
    ts = [r.submit(q, now=0.0) for q in reqs]
    r.flush(now=0.0)
    shape = r.dispatches[0][0]
    batch = make_batch(router_store, [0, 5, -1, -1],
                       seen=[[1, 2], [], [], []],
                       fold=[[], [], [(3, 4.0)], []], L=shape[1], F=shape[2])
    ref = SRV.score_topk(router_store, batch, k=4, mode="mean")
    for i, t in enumerate(ts):
        np.testing.assert_array_equal(t.ids, ref.ids[i].numpy())
        np.testing.assert_array_equal(t.scores, ref.scores[i].numpy())
        np.testing.assert_array_equal(t.valid, ref.valid[i].numpy())


def test_router_thompson_end_to_end(router_store):
    r = SRV.MicroBatchRouter(router_store, k=3, mode="thompson",
                             latency_budget_s=0.0, max_batch=2,
                             max_seen=8, max_fold=2, seed=4)
    ts = [r.submit(SRV.Request(user_id=i, seen=[0]), now=0.0)
          for i in range(4)]
    r.flush(now=0.0)
    for t in ts:
        assert t.done and t.valid.all()
        assert 0 not in t.ids                      # seen item masked
        assert (t.ids < router_store.n_items).all()
        assert len(set(t.ids.tolist())) == 3


def test_router_rejects_ids_out_of_range(router_store):
    """Ids index the store on the device, where one out of range is a
    device assert, not the reference's dropped scatter: the router checks
    them on the host."""
    r = SRV.MicroBatchRouter(router_store, k=3, max_batch=4, max_seen=8,
                             max_fold=2)
    for bad in (SRV.Request(user_id=8),
                SRV.Request(user_id=0, seen=[20]),
                SRV.Request(user_id=0, seen=[-1]),
                SRV.Request(user_id=-1, fold_items=[25], fold_ratings=[1.0])):
        with pytest.raises(ValueError, match="outside"):
            r.submit(bad, now=0.0)
    assert not r.dispatches


# ---------------------------------------------------------------------------
# the CLI and the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", SCORE.MODES)
def test_bmf_serve_cli_check(mode, capsys):
    TSERVE.main(["--dataset", "mini", "--device", "cpu", "--check",
                 "--samples", "8", "--requests", "96", "--mode", mode])
    out = capsys.readouterr().out
    assert "served 96 request(s)" in out
    assert "parity check OK: 64 request(s)" in out


def test_bmf_serve_sharded_waits_for_step_10(capsys):
    """``--executor sharded`` (step 10 is ported): trains on the default
    topology and serves, every answer checked against the brute force."""
    TSERVE.main(["--dataset", "mini", "--device", "cpu", "--samples", "4",
                 "--requests", "64", "--executor", "sharded", "--check"])
    out = capsys.readouterr().out
    assert "executor=sharded" in out
    assert "parity check OK: 64 request(s)" in out


@pytest.mark.cuda
def test_cuda_project_pd_in_chunks_matches_cpu(cuda_device):
    """More rows than one batched ``eigh`` call takes on the card
    (``EIGH_ROWS`` per call): the chunked projection against the CPU's."""
    rng = np.random.default_rng(8)
    lam = _sym_indefinite(rng, 3 * STORE.EIGH_ROWS + 5, 10)
    got = STORE._project_pd(torch.from_numpy(lam).to(cuda_device)).cpu()
    want = STORE._project_pd(torch.from_numpy(lam))
    assert_rel_close(got.numpy(), want.numpy(), RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SCORE.MODES)
def test_cuda_warm_scoring_never_syncs(cuda_device, mode):
    """The card's twin of the reference's transfer-guard test: a warm
    router batch (host padding, non-blocking copies) and its scoring call
    run under ``set_sync_debug_mode("error")``, and score what the CPU
    scores."""
    rng = np.random.default_rng(6)
    fields = direct_fields(rng.normal(size=(8, 4)), rng.normal(size=(50, 4)),
                           V_samples=rng.normal(size=(3, 50, 4)))
    cpu = CV.posterior_store_from_numpy(fields, device="cpu")
    gpu = CV.posterior_store_from_numpy(fields, device=cuda_device)
    reqs = [SRV.Request(user_id=0, seen=[3]), SRV.Request(user_id=5),
            SRV.Request(user_id=-1, fold_items=[2], fold_ratings=[5.0])]
    r = SRV.MicroBatchRouter(gpu, k=5, mode=mode, seed=1)
    shape = r.bucket_for(len(reqs), 1, 1)
    r.workers[0].score(r._pad_batch(reqs, shape))          # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = r._pad_batch(reqs, shape)
        out = r.workers[0].score(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = SRV.score_topk(cpu, SRV.RequestBatch(*(t.cpu() for t in batch)),
                          k=5, mode=mode)
    np.testing.assert_array_equal(out.ids.cpu().numpy(), want.ids.numpy())
    assert_rel_close(out.scores.cpu().numpy(), want.scores.numpy(), RTOL)
