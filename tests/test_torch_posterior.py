"""core.posterior of the port against the JAX reference.

Deterministic algebra is held at 1e-5 relative (f32 factorizations and
solves in different orders); draws are compared with the same noise on
both sides: ``sample_rows_noise`` with a shared z, and Wishart /
Normal-Wishart draws replayed from the reference's own jax.random draws.
The port's generator-backed draws are checked by moments, as the
reference's 4000-draw test does.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import posterior as TP
from torch_helpers import assert_rel_close

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    assert_rel_close(got, want, rtol)


def _spd(rng, *shape, K):
    A = rng.normal(size=shape + (K, K)) * 0.4
    return (np.einsum("...ij,...kj->...ik", A, A) + np.eye(K)).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def test_algebra_matches_reference():
    import jax.numpy as jnp
    from repro.core import posterior as JP
    rng = np.random.default_rng(0)
    N, K = 7, 5
    mu = rng.normal(size=(N, K)).astype(np.float32)
    L1, L2 = _spd(rng, N, K=K), _spd(rng, N, K=K)
    a_t, a_j = TP.from_moments(_t(mu), _t(L1)), JP.from_moments(
        jnp.asarray(mu), jnp.asarray(L1))
    _close(a_t.eta, a_j.eta)
    _close(a_t.mean, a_j.mean)
    _close(a_t.cov, a_j.cov)
    b_t = TP.from_moments_cov(_t(mu), _t(L2), ridge=1e-3)
    b_j = JP.from_moments_cov(jnp.asarray(mu), jnp.asarray(L2), ridge=1e-3)
    _close(b_t.eta, b_j.eta)
    _close(b_t.Lambda, b_j.Lambda)
    for ft, fj in ((TP.product, JP.product), (TP.divide, JP.divide)):
        r_t, r_j = ft(a_t, b_t), fj(a_j, b_j)
        _close(r_t.eta, r_j.eta)
        _close(r_t.Lambda, r_j.Lambda)
    _close(TP.scale(a_t, 0.3).Lambda, JP.scale(a_j, 0.3).Lambda)
    p_t = TP.broadcast_prior(_t(mu[0]), _t(L1[0]), 4)
    p_j = JP.broadcast_prior(jnp.asarray(mu[0]), jnp.asarray(L1[0]), 4)
    _close(p_t.eta, p_j.eta)
    _close(p_t.Lambda, p_j.Lambda)
    S = rng.normal(size=(30, N, K)).astype(np.float32)
    s_t, s_j = TP.from_samples(_t(S)), JP.from_samples(jnp.asarray(S))
    _close(s_t.eta, s_j.eta, rtol=1e-4)     # inverse of a sample covariance
    _close(s_t.Lambda, s_j.Lambda, rtol=1e-4)


def test_sample_rows_noise_shared_z():
    import jax.numpy as jnp
    from repro.core import posterior as JP
    rng = np.random.default_rng(1)
    N, K = 9, 6
    eta = rng.normal(size=(N, K)).astype(np.float32)
    Lam = _spd(rng, N, K=K)
    z = rng.normal(size=(N, K)).astype(np.float32)
    x_t = TP.sample_rows_noise(TP.RowGaussians(_t(eta), _t(Lam)), _t(z))
    x_j = JP.sample_rows_noise(JP.RowGaussians(jnp.asarray(eta),
                                               jnp.asarray(Lam)),
                               jnp.asarray(z))
    _close(x_t, x_j)


def test_cholesky_of_indefinite_matrix_is_nan_not_an_error():
    """The health guard relies on NaN, as jnp.linalg.cholesky gives."""
    A = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]])
    L = TP.cholesky(A)
    assert bool(torch.isnan(L[0]).all())
    assert bool(torch.isfinite(L[1]).all())


def _nw_pair(rng, K, N):
    import jax.numpy as jnp
    from repro.core import posterior as JP
    X = rng.normal(0.5, 1.2, (N, K)).astype(np.float32)
    W0 = _spd(rng, K=K)
    mu0 = rng.normal(size=K).astype(np.float32)
    t = TP.NormalWishart(_t(mu0), torch.tensor(2.0), _t(W0),
                         torch.tensor(float(K + 3)))
    j = JP.NormalWishart(jnp.asarray(mu0), jnp.asarray(2.0), jnp.asarray(W0),
                         jnp.asarray(float(K + 3)))
    return t, j, X


def test_nw_posterior_matches_reference():
    import jax.numpy as jnp
    from repro.core import posterior as JP
    rng = np.random.default_rng(2)
    t, j, X = _nw_pair(rng, 4, 60)
    pt, pj = TP.nw_posterior(t, _t(X)), JP.nw_posterior(j, jnp.asarray(X))
    for a, b in zip(pt, pj):
        _close(a, b)
    # batched over a leading block axis
    Xb = np.stack([X, X[::-1] * 0.5])
    pb = TP.nw_posterior(t, _t(Xb))
    _close(pb.W0[0], pj.W0)
    _close(pb.W0[1], JP.nw_posterior(j, jnp.asarray(Xb[1])).W0)


def test_wishart_and_nw_draws_from_reference_tape():
    """Replay the reference's own jax.random draws (split → gamma/normal,
    as sample_wishart / sample_nw make them) into the port's *_noise
    functions: the draws must match the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.core import posterior as JP
    rng = np.random.default_rng(3)
    t, j, X = _nw_pair(rng, 5, 40)
    post_j = JP.nw_posterior(j, jnp.asarray(X))
    post_t = TP.nw_posterior(t, _t(X))
    K = 5
    for seed in range(3):
        key = jax.random.key(seed)
        mu_j, lam_j = JP.sample_nw(key, post_j)
        kw, km = jax.random.split(key)
        kg, kn = jax.random.split(kw)
        df = (post_j.nu0 - jnp.arange(K, dtype=jnp.float32)) / 2.0
        chi2 = np.asarray(2.0 * jax.random.gamma(kg, df, dtype=jnp.float32))
        lower = np.asarray(jax.random.normal(kn, (K, K), jnp.float32))
        z = np.asarray(jax.random.normal(km, (K,), jnp.float32))
        mu_t, lam_t = TP.sample_nw_noise(post_t, _t(chi2), _t(lower), _t(z))
        _close(lam_t, lam_j, rtol=1e-4)   # Bartlett product: two K×K matmuls
        _close(mu_t, mu_j, rtol=1e-4)
        W_t = TP.sample_wishart_noise(post_t.W0, _t(chi2), _t(lower))
        _close(W_t, JP.sample_wishart(kw, post_j.W0, post_j.nu0), rtol=1e-4)


def test_gamma_draws_match_gamma_moments():
    gen = torch.Generator().manual_seed(0)
    for a in (0.5, 1.0, 3.5, 40.0):
        g = TP.standard_gamma(gen, torch.full((20000,), a))
        assert bool(torch.isfinite(g).all())
        assert abs(float(g.mean()) - a) < 0.05 * a
        assert abs(float(g.var()) - a) < 0.1 * a


def test_sample_nw_moments_match_analytic():
    """E[Λ] = ν·W, E[μ] = μ0, Cov(μ) = W⁻¹ / (β(ν−K−1)) from the port's
    own generator, as test_bmf_core.py checks the reference."""
    K = 3
    prior = TP.NormalWishart(
        mu0=torch.tensor([1.0, -2.0, 0.5]), beta0=torch.tensor(2.0),
        W0=torch.tensor([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]]),
        nu0=torch.tensor(float(K + 3)))
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(0.5, 1.2, (60, K)).astype(np.float32))
    post = TP.nw_posterior(prior, X)
    np.testing.assert_allclose(float(post.beta0), 2.0 + 60)
    np.testing.assert_allclose(float(post.nu0), K + 3 + 60)
    gen = torch.Generator().manual_seed(11)
    draws = [TP.sample_nw(gen, post) for _ in range(4000)]
    mus = torch.stack([d[0] for d in draws]).numpy().astype(np.float64)
    lams = torch.stack([d[1] for d in draws]).numpy().astype(np.float64)
    E_lam = float(post.nu0) * post.W0.numpy()
    np.testing.assert_allclose(lams.mean(0), E_lam,
                               atol=0.02 * np.abs(E_lam).max())
    np.testing.assert_allclose(mus.mean(0), post.mu0.numpy(), atol=0.01)
    cov_mu = np.linalg.inv(post.W0.numpy().astype(np.float64)) / (
        float(post.beta0) * (float(post.nu0) - K - 1))
    np.testing.assert_allclose(np.cov(mus.T), cov_mu,
                               atol=0.15 * np.abs(cov_mu).max())


@pytest.mark.parametrize("shape", [(4,), (2, 3)])
def test_chi2_is_addressable(shape):
    """Re-seeding the generator reproduces a draw: the noise seam addresses
    draws by seed, never by position in a stream."""
    df = torch.full(shape, 7.0)
    a = TP.chi2(torch.Generator().manual_seed(5), df)
    b = TP.chi2(torch.Generator().manual_seed(5), df)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
