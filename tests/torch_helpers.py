"""Shared inputs and fixtures of the port's tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages. JAX
and ``repro`` are imported inside the functions that need them, so the
``cuda``-marked legs also run on a machine that has no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's CPU torch ops on one intra-op thread, restoring the
    count after the module. PP chains are thousands of tiny ops: with
    several test workers sharing the cores, each op's parallel region
    waits for threads the scheduler has parked, which made such a module
    ~100× slower than alone (12 fault-battery tests: 564 s in each of 6
    concurrent processes, 7.5 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The GPU for a ``cuda``-marked leg; the leg skips without one (a CUDA
    kernel has no CPU mode to fall back to)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    from repro_torch import resolve_device
    return resolve_device("cuda")


def factor_case(rng, N, M, D, K, empty_rows=(), B=None, scale=1.0):
    """Random padded-CSR factor-step inputs: left-packed ragged occupancy
    (so the padded tail holds whole all-padding tiles), rows in
    ``empty_rows`` with no ratings, PD per-row priors, and noise z.
    Returns numpy arrays, with a leading block axis when ``B`` is set."""
    lead = () if B is None else (B,)
    idx = rng.integers(0, D, lead + (N, M)).astype(np.int32)
    val = (rng.normal(size=lead + (N, M)) * scale).astype(np.float32)
    nnz = rng.integers(0, M + 1, lead + (N,))
    nnz[..., list(empty_rows)] = 0
    mask = (np.arange(M) < nnz[..., None]).astype(np.float32)
    other = rng.normal(size=lead + (D, K)).astype(np.float32)
    pe = (rng.normal(size=lead + (N, K)) * 0.3).astype(np.float32)
    A = rng.normal(size=lead + (N, K, K)) * 0.2
    pL = (np.einsum("...ij,...kj->...ik", A, A)
          + 1.5 * np.eye(K)).astype(np.float32)
    z = rng.normal(size=lead + (N, K)).astype(np.float32)
    return dict(idx=idx, val=val, mask=mask, other=other, pe=pe, pL=pL, z=z)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (round to nearest even) and back, in numpy."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def jax_chain_tape(key, N, D, K, n_samples, shards=None):
    """Replay the reference chain's key schedule into a noise tape for
    ``repro_torch.noise.TapeNoise``: the draws ``repro.core.gibbs.run_gibbs``
    makes from ``key`` for an (N, D, K) chain of ``n_samples`` sweeps.
    ``shards=(S, D_loc)`` also records the 'scatter' V-step's per-shard
    draws normal(fold_in(kv, s), (D_loc, K)) as ("z", sweep, "V", s)
    (``repro.core.distributed._sharded_v_sampler``).

      split(key) -> (k0, key); init_factors(k0): split -> normal (N,K)/(D,K)
      per sweep: split(key, 5) -> key, kh1, kh2, ku, kv
        sample_nw(kh): split -> (kw, km); sample_wishart(kw): split ->
          (kg, kn); chi2 = 2·gamma(kg, (ν−i)/2), ν = K + n; normal(kn, (K,K));
          normal(km, (K,))
        normal(ku, (N, K)), normal(kv, (D, K))

    Every draw depends only on keys and shapes (the χ² degrees of freedom
    only on N and K), so the tape is complete before either chain runs.
    Hyper draws are recorded for both factors whether or not the chain
    resamples them."""
    import jax
    import jax.numpy as jnp
    f32 = jnp.float32
    tape = {}
    k0, key = jax.random.split(key)
    ku, kv = jax.random.split(k0)
    tape[("init", "U")] = np.asarray(jax.random.normal(ku, (N, K), f32))
    tape[("init", "V")] = np.asarray(jax.random.normal(kv, (D, K), f32))
    for i in range(n_samples):
        key, kh1, kh2, ku, kv = jax.random.split(key, 5)
        for f, kh, n in (("U", kh1, N), ("V", kh2, D)):
            kw, km = jax.random.split(kh)
            kg, kn = jax.random.split(kw)
            nu = jnp.asarray(float(K), f32) + n
            df = (nu - jnp.arange(K, dtype=f32)) / 2.0
            tape[("hyper", i, f)] = (
                np.asarray(2.0 * jax.random.gamma(kg, df, dtype=f32)),
                np.asarray(jax.random.normal(kn, (K, K), f32)),
                np.asarray(jax.random.normal(km, (K,), f32)))
        tape[("z", i, "U")] = np.asarray(jax.random.normal(ku, (N, K), f32))
        tape[("z", i, "V")] = np.asarray(jax.random.normal(kv, (D, K), f32))
        for s in range(shards[0] if shards else 0):
            tape[("z", i, "V", s)] = np.asarray(jax.random.normal(
                jax.random.fold_in(kv, s), (shards[1], K), f32))
    return tape


def assert_rel_close(got, want, rtol):
    """Elementwise |got - want| <= rtol·|want| + rtol·max(|want|, 1): the
    port's tolerances are relative to the largest reference value."""
    got, want = np.asarray(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def llm_cfgs(arch, **kw):
    """The reference's and the port's ``smoke_variant`` config of ``arch``
    with the fields ``kw`` replaced, equal field by field."""
    from repro.configs.base import get_config
    from repro_torch.configs import base as TCB
    jcfg = dataclasses.replace(get_config(arch).smoke_variant(), **kw)
    tcfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def np_tree(tree):
    """A JAX pytree as numpy arrays."""
    import jax
    return jax.tree.map(np.asarray, tree)


class KernelCount:
    """Counts the attention and scan kernel wrappers' CPU calls (every
    slot's)."""

    def __init__(self, mp):
        from repro_torch.kernels.flash_attention import ops as FA
        from repro_torch.models import layers as LY
        from repro_torch.models import mamba2 as M2
        from repro_torch.models import rwkv6 as R6
        self.n = {"repro_torch::flash_attention": 0,
                  "repro_torch::flash_attention_bwd": 0,
                  "repro_torch::decode_attention": 0,
                  "repro_torch::ssd_chunk": 0,
                  "repro_torch::wkv6": 0}
        for mod, name, key in (
                (FA, "flash_attention", "repro_torch::flash_attention"),
                (LY, "flash_attention", "repro_torch::flash_attention"),
                (FA, "flash_bwd", "repro_torch::flash_attention_bwd"),
                (LY, "decode_attention", "repro_torch::decode_attention"),
                (M2, "ssd_scan", "repro_torch::ssd_chunk"),
                (R6, "wkv6", "repro_torch::wkv6")):
            mp.setattr(mod, name, self._wrap(getattr(mod, name), key))

    def _wrap(self, fn, key):
        def counted(*a, **k):
            self.n[key] += 1
            return fn(*a, **k)
        return counted
