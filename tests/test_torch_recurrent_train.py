"""Training of the recurrent families in the port (hybrid: zamba2; ssm:
rwkv6) against the JAX reference.

The reference trains them with ``jax.grad`` through its jnp chunked scans,
``repro/models/mamba2.py::ssd_chunked`` and ``rwkv6.py::wkv_chunked``,
each chunk under ``jax.checkpoint``; its Pallas scan kernels are
forward-only. The port's counterparts are ``models.mamba2.ssd_scan_train``
and ``models.rwkv6.wkv_scan_train`` (the kernels' plain chunked versions
with each chunk under a non-reentrant ``torch.utils.checkpoint``), which
the mixers take when autograd records a gradient; L4 and L5 keep serving
prompts that need none.

Inputs are made with numpy from a seed; models start from the reference's
``init_params`` (``convert.llm_params_from_numpy(..., train=True)``), in
f32, at B = 2, S = 256 (two 128-step chunks). The reference runs its plain
attention: S = 256 is below its Pallas attention's 512-position tile.

Tolerances:
- the scans, values and gradients with respect to every input: 1e-5 of
  the largest reference value (``assert_rel_close``). The same f32
  arithmetic, chunk by chunk, in other summation orders (XLA's dots
  against torch's einsums). Under strong decay A_log's gradient takes
  ``STRONG_A_LOG_RTOL``, 1e-4: there the reference itself is 2.4e-5 from
  an f64 evaluation.
- the train steps: ``tests/test_torch_train.py``'s, with its reasons
  (loss and grad norm 1e-5 relative, lr 1e-6, AdamW moments 2e-4 of each
  tensor's largest value, parameters by the flip count).
- the scans against autograd through the step-by-step oracles:
  ``SEQ_GRAD_RTOL``, 2e-4, about 5x the largest gap measured here, 3.7e-5
  (A_log's gradient at S 512: sums over S steps against sums over
  128-step chunks; every other output 7.4e-6 or less).
- the first batch's per-tensor gradients: ``GRAD_RTOL``, 1e-4 of each
  tensor's largest reference value. They sum many cancelling terms over
  S positions and up to 5 layers (``A_log``'s over every step of every
  head); measured at most 1.8e-5 (zamba2's ``A_log``).
- the per-chunk checkpoint on and off, and ``remat_policy`` "full",
  "dots" and none: the same arithmetic recomputed, so bitwise equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.kernels.ssd_chunk import ref as SSDR
from repro_torch.kernels.wkv6 import ref as WKVR
from repro_torch.models import kvcache as TKV
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as R6
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from test_torch_train import (FLIP_FRACTION, MOMENT_RTOL, N_STEPS, TRAIN_KW,
                              _as, _close_to_max, _leaves)
from torch_helpers import assert_rel_close, llm_cfgs, np_tree
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

B, S = 2, 256
SCAN_RTOL = 1e-5
# A_log's gradient under strong decay: one value per head summing
# a_t·∂/∂a_t over every step, whose terms reach ~10x the sum and cancel.
# Measured at B 2, S 256, H 4: the reference's own value sits 2.4e-5 of
# the largest from an f64 evaluation of the same chunked form, the port's
# 1.7e-5, and the two 3.7e-5 apart
STRONG_A_LOG_RTOL = 1e-4
GRAD_RTOL = 1e-4
# the training scans against autograd through the sequential oracles
SEQ_GRAD_RTOL = 2e-4
# id -> (arch, config fields replaced in the smoke variant), as in
# tests/test_torch_recurrent.py: zamba2's smoke variant (2 layers, the
# shared block after each), one with two full groups of 2 and a remainder
# layer, and rwkv6's
VARIANTS = {"zamba2": ("zamba2_7b", {}),
            "zamba2-remainder": ("zamba2_7b", dict(n_layers=5,
                                                    shared_attn_period=2)),
            "rwkv6": ("rwkv6_7b", {})}
PALLAS_ENV = ("REPRO_PALLAS_SSD", "REPRO_PALLAS_WKV", "REPRO_PALLAS_ATTN",
              "REPRO_PALLAS_DECODE_ATTN")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _plain_reference(mp):
    """The reference's plain scans and attention: no Pallas switch set."""
    for name in PALLAS_ENV:
        mp.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# the training scans against jax.grad of the reference's chunked scans
# ---------------------------------------------------------------------------


def ssd_inputs(strong, seed=0, H=4, P=16, N=16, B=B, S=S):
    """(x, dt, A_log, B, C, state0) in the reference's ``ssd_chunked``
    layout, f32, and cotangents for y and the final state. dt is
    softplus(noise − 2) (dt_bias = −2) with A_log = log(linspace(1, 16)),
    as a random layer has; ``strong``: a = −exp(A_log)·dt ≈ −2 per step,
    so exp(L) underflows inside a chunk."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    if strong:
        dt = np.log1p(np.exp(1.0 + normal(B, S, H, scale=0.1)))
        A_log = np.full((H,), np.log(2.0 / np.log1p(np.e)), np.float32)
    else:
        dt = np.log1p(np.exp(normal(B, S, H, scale=0.5) - 2.0))
        A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    args = [normal(B, S, H, P), dt.astype(np.float32), A_log,
            normal(B, S, N), normal(B, S, N), normal(B, H, P, N, scale=0.1)]
    return args, [normal(B, S, H, P), normal(B, H, P, N)]


def wkv_inputs(strong, seed=0, H=4, N=16, B=B, S=S):
    """(r, k, v, logw, u, state0), f32, and cotangents: logw as a random
    layer's decay (−exp(w0 + noise), w0 = −3) or, ``strong``, ≈ −1 per
    step."""
    rng = np.random.default_rng(seed + 1)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    logw = (-1.0 + normal(B, S, H, N, scale=0.1) if strong
            else -np.exp(normal(B, S, H, N) - 3.0).astype(np.float32))
    args = [normal(B, S, H, N), normal(B, S, H, N, scale=0.5),
            normal(B, S, H, N), logw, normal(H, N, scale=0.1),
            normal(B, H, N, N, scale=0.1)]
    return args, [normal(B, S, H, N), normal(B, H, N, N)]


def _reference_vjp(fn, args, cots):
    """((y, state), grads of sum(y·gy) + sum(state·gs) w.r.t. every
    argument) of the reference's scan ``fn``."""
    import jax
    import jax.numpy as jnp
    jargs = [jnp.asarray(a) for a in args]
    out, vjp = jax.vjp(fn, *jargs)
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(t) for t in out], [np.asarray(g) for g in grads]


def _port_vjp(fn, args, cots):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    return ([t.detach().numpy() for t in out],
            [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("scan", ["ssd", "wkv"])
def test_training_scan_matches_reference_grad(scan, strong):
    """y, the final state and the gradients with respect to x, dt, A_log,
    B, C, state0 (ssd) or r, k, v, logw, u, state0 (wkv)."""
    if scan == "ssd":
        from repro.models.mamba2 import ssd_chunked as ref_fn
        args, cots = ssd_inputs(strong)
        port_fn = M2.ssd_scan_train
    else:
        from repro.models.rwkv6 import wkv_chunked as ref_fn
        args, cots = wkv_inputs(strong)
        port_fn = R6.wkv_scan_train
    want_out, want_grads = _reference_vjp(ref_fn, args, cots)
    got_out, got_grads = _port_vjp(port_fn, args, cots)
    rtols = [SCAN_RTOL] * (2 + len(args))
    if scan == "ssd" and strong:
        rtols[2 + 2] = STRONG_A_LOG_RTOL
    for got, want, rtol in zip(got_out + got_grads, want_out + want_grads,
                               rtols):
        assert np.isfinite(got).all()
        assert_rel_close(got, want, rtol)


def _ssd_sequential(x, dt, A_log, B_, C_, state0):
    """The step-by-step oracle in the training scan's arguments."""
    a = -torch.exp(A_log)[None, None, :] * dt
    return SSDR.ssd_sequential(x * dt[..., None], a, B_, C_, state0)


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("scan", ["ssd", "wkv"])
def test_training_scan_matches_sequential_oracle(scan, strong):
    """The training scans against autograd through the step-by-step
    oracles (``ssd_sequential``, ``wkv_sequential``) at the shape of
    ``chip_smoke.py [scan-train-parity]`` (B 1, S 512, the full models'
    head size P = N = 64) with fewer heads (16 and 8 of 112 and 64; a
    gradient sums over steps within its head): values and every input's
    gradient within ``SEQ_GRAD_RTOL`` of the largest oracle value, the
    limit that phase holds the card to."""
    if scan == "ssd":
        args, cots = ssd_inputs(strong, H=16, P=64, N=64, B=1, S=512)
        fns = (M2.ssd_scan_train, _ssd_sequential)
    else:
        args, cots = wkv_inputs(strong, H=8, N=64, B=1, S=512)
        fns = (R6.wkv_scan_train, WKVR.wkv_sequential)
    (got_out, got_grads), (want_out, want_grads) = (
        _port_vjp(fn, args, cots) for fn in fns)
    for got, want in zip(got_out + got_grads, want_out + want_grads):
        assert_rel_close(got, want, SEQ_GRAD_RTOL)


@pytest.mark.parametrize("scan", ["ssd", "wkv"])
def test_chunk_checkpoint_keeps_the_gradients(scan):
    """The kernels' plain chunked scans with and without the per-chunk
    checkpoint: the same values and gradients, bitwise."""
    if scan == "ssd":
        (x, dt, A_log, B_, C_, s0), cots = ssd_inputs(False, seed=3)
        a = -np.exp(A_log)[None, None, :] * dt
        args = [x * dt[..., None], a.astype(np.float32), B_, C_, s0]
        fn = SSDR.ssd_chunked
    else:
        args, cots = wkv_inputs(False, seed=3)
        fn = WKVR.wkv_chunked
    runs = [_port_vjp(lambda *t, r=remat: fn(*t, remat=r), args, cots)
            for remat in (False, True)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the mixers' routing
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, names):
    calls = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, fn=fn, name=name, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_mixer_routes_prompts_by_gradient(arch, monkeypatch):
    """A prompt takes the kernel's wrapper (L4 / L5) under ``no_grad`` and
    when no input needs a gradient, and the training scan when a
    parameter does; one token takes neither."""
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32")
    if cfg.family == "hybrid":
        calls = _spy(monkeypatch, M2, ("ssd_scan", "ssd_scan_train"))
        names = ("ssd_scan", "ssd_scan_train")
    else:
        calls = _spy(monkeypatch, R6, ("wkv6", "wkv_scan_train"))
        names = ("wkv6", "wkv_scan_train")
    tokens = torch.randint(0, cfg.vocab_size, (B, 40),
                           generator=torch.Generator().manual_seed(0))
    for train in (False, True):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                train=train)
        calls.clear()
        with torch.no_grad():
            TM.forward(params, cfg, {"tokens": tokens})
        assert calls == [names[0]] * cfg.n_layers
        calls.clear()
        loss, _ = TST.loss_fn(params, cfg, {"tokens": tokens}, remat=False)
        assert calls == [names[train]] * cfg.n_layers
    calls.clear()
    loss.backward()
    cache = TKV.serve_cache_init(cfg, B, 64, dtype=torch.float32,
                                 device="cpu")
    TM.decode_step(params, cfg, cache, tokens[:, :1])
    assert calls == []


# ---------------------------------------------------------------------------
# the train step against the reference's make_train_step
# ---------------------------------------------------------------------------


def _batches(cfg, n):
    from repro_torch.data import tokens as TTOK
    gen = TTOK.synthetic_token_batches(cfg, B, S, seed=0, device="cpu")
    return [{"tokens": next(gen)["tokens"].numpy()} for _ in range(n)]


def _compiled(fn, *args):
    """``fn`` jitted for ``args`` at XLA's backend optimization level 0:
    that halves the CPU compile time of the reference's nested scans
    (zamba2's train step: 22.4 s to 11.9 s on one core) and moves its
    results by f32 rounding only (its first grad norm 7.2257433 to
    7.2257428)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


class _ReferenceRun:
    """The reference's ``make_train_step`` for N_STEPS steps from its
    ``init_params(key(0))``, plain scans and attention; ``mu1`` keeps the
    AdamW first moment after the first step."""

    def __init__(self, variant, microbatches):
        import jax
        import jax.numpy as jnp
        from repro.configs.base import TrainConfig
        from repro.models import model as JM
        from repro.models import steps as JST
        from repro.optim import adamw as JA
        arch, kw = VARIANTS[variant]
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", **kw)
        self.tcfg = TCB.TrainConfig(microbatches=microbatches, **TRAIN_KW)
        jtcfg = TrainConfig(**dataclasses.asdict(self.tcfg))
        tree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree0 = np_tree(tree)
        self.batches = _batches(self.cfg, N_STEPS)
        opt = JA.init(tree)
        self.metrics = []
        with pytest.MonkeyPatch.context() as mp:
            _plain_reference(mp)
            batches = [_as(b, jnp.asarray) for b in self.batches]
            step = _compiled(JST.make_train_step(self.jcfg, jtcfg), tree,
                             opt, batches[0])
            for batch in batches:
                tree, opt, m = step(tree, opt, batch)
                self.metrics.append({k: float(v) for k, v in m.items()})
                if len(self.metrics) == 1:
                    self.mu1 = np_tree(opt.mu)
        self.tree = np_tree(tree)
        self.opt = np_tree(opt._asdict())


_RUNS = {}


def reference_run(variant, microbatches):
    key = (variant, microbatches)
    if key not in _RUNS:
        _RUNS[key] = _ReferenceRun(variant, microbatches)
    return _RUNS[key]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_reference(variant):
    """The first batch's loss (remat on, as trained) and every parameter's
    gradient against the reference's first train step: its loss, and its
    gradients from the first AdamW moment, mu_1 = (1 − β1)·g·min(1,
    clip / |g|) (its gradient before clipping, as ``loss_fn`` gives it);
    every parameter, the mixers' f32 ones included, gets a gradient."""
    ref = reference_run(variant, 1)
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu", train=True)
    loss, _ = TST.loss_fn(params, ref.cfg,
                          _as(ref.batches[0], torch.from_numpy))
    loss.backward()
    first = ref.metrics[0]
    np.testing.assert_allclose(float(loss.detach()), first["loss"],
                               rtol=1e-5)
    named = dict(params.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got = CV._llm_tree({n: p.grad for n, p in named.items()})
    scale = (1.0 - ref.tcfg.beta1) * min(
        1.0, ref.tcfg.grad_clip / max(first["grad_norm"], 1e-9))
    got_leaves, want_leaves = _leaves(got), [
        (path, mu / scale) for path, mu in _leaves(ref.mu1)]
    assert len(got_leaves) == len(want_leaves)
    for (path, want), (gpath, g) in zip(want_leaves, got_leaves):
        assert path == gpath
        _close_to_max(g, want, GRAD_RTOL, path)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_reference(variant, microbatches):
    ref = reference_run(variant, microbatches)
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu", train=True)
    opt = TA.init(dict(params.named_parameters()))
    step = TST.make_train_step(ref.cfg, ref.tcfg)
    metrics = []
    for batch in ref.batches:
        params, opt, m = step(params, opt, _as(batch, torch.from_numpy))
        metrics.append({k: float(v) for k, v in m.items()})
    for got, want in zip(metrics, ref.metrics):
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)
    assert opt.step == int(ref.opt["step"]) == N_STEPS

    lr_sum = sum(m["lr"] for m in ref.metrics)
    n_flip = n_all = 0
    for (path, want), (_, got) in zip(_leaves(ref.tree),
                                      _leaves(CV.llm_params_to_numpy(params))):
        d = np.abs(got - want)
        assert float(d.max()) <= 2 * lr_sum + 1e-6, path
        n_flip += int((d > 1e-6 + 1e-3 * lr_sum).sum())
        n_all += d.size
    assert n_flip <= FLIP_FRACTION * n_all, (n_flip, n_all)
    got_opt = CV.adamw_state_to_numpy(opt, params)
    for name in ("mu", "nu"):
        for (path, want), (_, got) in zip(_leaves(ref.opt[name]),
                                          _leaves(got_opt[name])):
            _close_to_max(got, want, MOMENT_RTOL, (name, path))


@pytest.mark.parametrize("variant", ["zamba2-remainder", "rwkv6"])
def test_remat_policies_give_the_same_gradients(variant):
    """``remat`` off, "full" and "dots": the per-chunk checkpoints nested
    inside the block's (selective, for "dots") recompute the same
    arithmetic, so the gradients are bitwise equal."""
    arch, kw = VARIANTS[variant]
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32", **kw)
    tokens = torch.from_numpy(_batches(cfg, 1)[0]["tokens"])
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                train=True)
        loss, _ = TST.loss_fn(params, cfg, {"tokens": tokens}, remat=remat,
                              remat_policy=policy)
        loss.backward()
        grads.append({n: p.grad for n, p in params.named_parameters()})
    for other in grads[1:]:
        for n, g in grads[0].items():
            assert torch.equal(other[n], g), n
