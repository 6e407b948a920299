"""The hybrid and ssm families' sharded steps and the int8 cache's
sharded decode (``models.sharded``, through ``steps.make_sharded_*``) on
CPU slots against the reference's UNSHARDED steps and the port's.

Zamba2-7B's smoke variant with 3 layers in groups of 2 (a full group, the
shared block, then a remainder group: both branches of
``hybrid_groups``) trains and serves on the (2, 4) mesh and serves on
(4, 2), RWKV6-7B's on (2, 4), both in f32. On (2, 4) a slot holds 4 of zamba2's 16 SSD heads
and 2 of rwkv6's 8 WKV heads, and the decode cache splits zamba2's
``conv_B`` / ``conv_C`` histories (N 16) and rwkv6's token shifts (d 256)
over 'model', so the decode gathers them. Both packages start from the
same seeded weights (the port's ``init_params`` on a torch generator
seeded 0, through ``convert.llm_params_to_numpy`` and back) and see the
same seeded numpy inputs: 2 train steps of B = 8, S = 64 in 2
microbatches, and a 24-token prompt into a 40-slot f32 cache, then 4
decode steps. The reference runs its plain chunked scans (no Pallas),
jitted at XLA's backend optimization level 0, in two spawned processes
beside the port's runs (zamba2's train step alone takes ~8 s to compile,
the rest as long).

Tolerances, as ``tests/test_torch_sharded_families.py`` holds the other
families: loss and grad norm 1e-5 relative against the port's unsharded
step at both steps and against the reference's first step; the
parameters and moments after the last step against the port's unsharded
step; logits 1e-4 of the largest reference value, against the reference
and against the port's unsharded serve, and the final recurrent states
1e-4 of their largest value against the port's. A rerun is bitwise the
same. A per-slot norm (Mamba2's gated norm over the slot's d_inner
columns, RWKV6's ``ln_out`` over its d columns, with no psum) moves the
logits far past that limit.

The int8 cache: Qwen3-4B's smoke variant with 2 KV heads (which
'model' = 4 does not divide: the cache splits the head dim) decodes 16
tokens of 8 sequences from the empty int8 cache on (2, 4), against the
reference's int8 ``decode_step`` and the port's unsharded one. The
K/V the two sides quantize differ by f32 rounding (the row-parallel
products add their partials in another order), and an entry within that
rounding of a .5 boundary rounds to the other int8 value: the port's own
unsharded decode sits one such entry away from the reference's here. So
the entries must be equal but for at most 1e-3 of them, none off by more
than one; the scales within 1e-5 relative (the unsharded port sits 1.1e-6
from the reference's); the logits 1e-4 of the largest reference value at
every (sequence, step) whose cache entries so far are equal, and 1e-3
where an entry was rounded the other way (one quantum of one key moved a
logit by 2.5e-4 of the largest in the first run).

The dry run's plans on the debug mesh (zamba2's and rwkv6's prefill on
(2, 4), the int8 decode) launch and exchange what the CPU runs do:
launches per slot the run's over the slots, collectives group 0's.
"""
import concurrent.futures
import dataclasses
import multiprocessing
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.core.topology import record_collectives
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as TMESH
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharded as SH
from repro_torch.models import steps as TST
from repro_torch.models.kvcache import serve_cache_init
from repro_torch.optim import adamw as TA
from repro_torch.sharding import partitioning as TP
from torch_helpers import (KernelCount, assert_rel_close, llm_cfgs,
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# variant -> (arch, config fields replaced)
VARIANTS = {"zamba2": ("zamba2_7b", {"n_layers": 3, "shared_attn_period": 2}),
            "rwkv6": ("rwkv6_7b", {}),
            "qwen3_int8": ("qwen3_4b", {"n_kv_heads": 2})}
TRAIN_CASES = [("zamba2", (2, 4)), ("rwkv6", (2, 4))]
SERVE_CASES = TRAIN_CASES + [("zamba2", (4, 2))]
B, S, N_STEPS, MICRO = 8, 64, 2, 2
PROMPT, MAX_LEN, N_DECODE = 24, 40, 4
INT8_DIMS, INT8_STEPS = (2, 4), 16
# the int8 decode steps the dry run plans (the CPU run's first ones)
PLANNED_STEPS = 4
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
METRICS = ("loss", "grad_norm")
# as tests/test_torch_sharded_families.py
MOMENT_RTOL, FLIP_FRACTION = 2e-4, 2e-4
# the int8 limits (module docstring)
INT8_FLIPS, SCALE_RTOL, FLIPPED_LOGIT_TOL = 1e-3, 1e-5, 1e-3


def _mesh(dims):
    return TMESH.Mesh(dims, ("data", "model"), ("cpu",))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compiled(fn, *args):
    """``fn`` jitted for ``args`` at XLA's backend optimization level 0,
    as ``tests/test_torch_sharded_families.py`` compiles the reference."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def _jax_reference(part, jcfg, tcfg, tree0, batch):
    """From the numpy weights ``tree0``, the reference's ``part``:
    "train", its first train step's metrics; "serve", the logits of its
    prefill and N_DECODE decode steps (f32 cache); "int8", the int8
    cache after INT8_STEPS decode steps from the empty one (numpy) and
    their logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.models import model as JM
    from repro.models import steps as JST
    from repro.models.kvcache import serve_cache_init as jinit
    from repro.optim import adamw as JA
    tree = jax.tree.map(jnp.asarray, tree0)
    tok = jnp.asarray(batch["tokens"])
    if part == "int8":
        cache = jinit(jcfg, B, INT8_STEPS, dtype=jnp.float32, kv_quant=True)
        dstep = _compiled(lambda p, c, x: JM.decode_step(p, jcfg, c, x), tree,
                          cache, tok[:, :1])
        out = []
        for i in range(INT8_STEPS):
            logits, cache = dstep(tree, cache, tok[:, i:i + 1])
            out.append(np.asarray(logits))
        return jax.tree.map(np.asarray, cache), out
    if part == "train":
        opt = JA.init(tree)
        step = JST.make_train_step(jcfg, TrainConfig(
            **dict(dataclasses.asdict(tcfg), remat=False)))
        jb = {"tokens": tok}
        metrics = _compiled(lambda p, o, b: step(p, o, b)[2], tree, opt,
                            jb)(tree, opt, jb)
        return {k: float(v) for k, v in metrics.items()}
    cache = jinit(jcfg, B, MAX_LEN, dtype=jnp.float32)
    prompt = {"tokens": tok[:, :PROMPT]}
    logits, cache = _compiled(lambda p, b, c: JM.prefill(p, jcfg, b, c),
                              tree, prompt, cache)(tree, prompt, cache)
    out = [np.asarray(logits)]
    dstep = _compiled(lambda p, c, x: JM.decode_step(p, jcfg, c, x), tree,
                      cache, tok[:, :1])
    for i in range(PROMPT, PROMPT + N_DECODE):
        logits, cache = dstep(tree, cache, tok[:, i:i + 1])
        out.append(np.asarray(logits))
    return out


class _Reference:
    """A variant's weights and inputs, the reference's unsharded steps
    (compiled and run in ``pool``'s processes, beside the port's runs),
    and the port's unsharded train steps."""

    def __init__(self, variant, pool):
        arch, kw = VARIANTS[variant]
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", **kw)
        self.tcfg = TCB.TrainConfig(microbatches=MICRO, **TRAIN_KW)
        self.tree0 = CV.llm_params_to_numpy(TM.init_params(
            self.cfg, torch.Generator().manual_seed(0), "cpu", train=True))
        rng = np.random.default_rng(0)
        self.batches = [{"tokens": rng.integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)}
            for _ in range(N_STEPS)]
        self.jax = {part: pool.submit(_jax_reference, part, self.jcfg,
                                      self.tcfg, self.tree0, self.batches[0])
                    for part in (("int8",) if variant == "qwen3_int8"
                                 else ("train", "serve"))}
        self._port = None

    @property
    def port_run(self):
        """The port's unsharded train steps: (metrics of each step, the
        parameters and AdamW state after the last)."""
        if self._port is None:
            params = self.port_params(train=True)
            popt = TA.init(dict(params.named_parameters()))
            pstep = TST.make_train_step(self.cfg, self.tcfg)
            metrics = []
            for b in self.batches:
                params, popt, m = pstep(params, popt, _torch(b))
                metrics.append({k: float(v) for k, v in m.items()})
            self._port = (metrics, params, popt)
        return self._port

    @property
    def metrics(self):
        return self.jax["train"].result()

    @property
    def logits(self):
        return self.jax["serve"].result()

    def port_params(self, train):
        return CV.llm_params_from_numpy(self.tree0, self.cfg, "cpu",
                                        train=train)


_REFS = {}


def _one_xla_thread():
    """A reference process runs XLA's CPU computations on one thread, so
    that the two leave the cores to the port's runs beside them."""
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_cpu_multi_thread_eigen=false").strip()


@pytest.fixture(scope="module", autouse=True)
def _references():
    """Every variant's reference, started with the module in two spawned
    processes (zamba2's train step in one, the rest in the other); every
    result is read before they end."""
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"),
            initializer=_one_xla_thread) as pool:
        for v in VARIANTS:
            _REFS[v] = _Reference(v, pool)
        yield
        for ref in _REFS.values():
            for f in ref.jax.values():
                f.result()
    _REFS.clear()


def reference(variant):
    return _REFS[variant]


class _Run(NamedTuple):
    """A sharded training run: the parameters, moments and metrics after
    each step (gathered), and the first step's kernel launches (every
    slot's) and group 0's collectives."""
    params: list
    opt: list
    metrics: list
    launches: dict
    calls: list


_TRAINED = {}


def _train(ref, dims, n_steps=N_STEPS, cached=True):
    key = (ref.cfg.name, dims)
    if cached and key in _TRAINED:
        return _TRAINED[key]
    mesh = _mesh(dims)
    params = ref.port_params(train=True)
    opt = TA.init(dict(params.named_parameters()))
    pspecs = TP.param_specs(params, ref.cfg, mesh)
    ospecs = TP.opt_specs(opt, params, ref.cfg, mesh)
    p, o = TP.place(params, pspecs, mesh), TP.place(opt, ospecs, mesh)
    step = TST.make_sharded_train_step(ref.cfg, ref.tcfg, mesh)
    run = _Run([], [], [], {}, [])
    for i, b in enumerate(ref.batches[:n_steps]):
        with pytest.MonkeyPatch.context() as mp, \
                record_collectives() as calls:
            count = KernelCount(mp) if i == 0 else None
            p, o, m = step(p, o, _torch(b))
        if count is not None:
            run.launches.update(count.n)
            run.calls.extend(c for c in calls if c.group == 0)
        run.metrics.append({k: float(v) for k, v in m.items()})
        run.params.append(TP.gather(p, pspecs, mesh))
        run.opt.append(TP.gather(o, ospecs, mesh))
    if cached:
        _TRAINED[key] = run
    return run


class _Served(NamedTuple):
    """A sharded prefill and decode: the logits of each step, the slots'
    caches gathered, the prefill's launches and group 0's collectives."""
    logits: list
    cache: dict
    launches: dict
    calls: list


_SERVED = {}


def _serve(ref, dims, cached=True):
    key = (ref.cfg.name, dims)
    if cached and key in _SERVED:
        return _SERVED[key]
    mesh = _mesh(dims)
    params = ref.port_params(train=False)
    p = TP.place(params, TP.param_specs(params, ref.cfg, mesh), mesh)
    shape = TCB.InputShape("prompt", MAX_LEN, B, "prefill")
    prefill = TST.make_sharded_prefill_step(ref.cfg, shape, mesh)
    serve = TST.make_sharded_serve_step(ref.cfg, mesh)
    tok = torch.from_numpy(ref.batches[0]["tokens"])
    with pytest.MonkeyPatch.context() as mp, record_collectives() as calls:
        count = KernelCount(mp)
        logits, cache = prefill(p, {"tokens": tok[:, :PROMPT]})
    out = [logits]
    for i in range(PROMPT, PROMPT + N_DECODE):
        logits, cache = serve(p, cache, tok[:, i:i + 1])
        out.append(logits)
    whole = TP.gather(cache, TP.cache_specs(
        serve_cache_init(ref.cfg, B, MAX_LEN, device="meta"), ref.cfg, None,
        mesh), mesh)
    run = _Served(out, whole, dict(count.n),
                  [c for c in calls if c.group == 0])
    if cached:
        _SERVED[key] = run
    return run


def _port_serve(ref):
    """The port's unsharded prefill and N_DECODE decode steps (f32
    cache): (logits of each step, the cache)."""
    params = ref.port_params(train=False)
    cache = serve_cache_init(ref.cfg, B, MAX_LEN, dtype=torch.float32,
                             device="cpu")
    tok = torch.from_numpy(ref.batches[0]["tokens"])
    logits, cache = TM.prefill(params, ref.cfg, {"tokens": tok[:, :PROMPT]},
                               cache)
    out = [logits]
    for i in range(PROMPT, PROMPT + N_DECODE):
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       tok[:, i:i + 1])
        out.append(logits)
    return out, cache


def test_layouts_are_the_intended_ones():
    """On (2, 4) zamba2's mixers split their SSD heads (4 of 16 a slot)
    and its cache splits the B / C histories, which every slot needs
    whole; rwkv6's time-mix splits its WKV heads (2 of 8) and its cache
    the token shifts; the int8 variant's cache splits the head dim. A
    'model' axis that divides the columns but not the heads raises."""
    def lm(variant, dims):
        arch, kw = VARIANTS[variant]
        cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(), **kw)
        return SH.ShardedLM(cfg, TMESH.Mesh(dims, ("data", "model")))
    z = lm("zamba2", (2, 4))
    assert z.mixer_split and z.bc_split and z.q_split and z.kv_split
    assert z.pspecs["blocks.0.mixer.w_B"] == (None, None)
    assert z.pspecs["blocks.0.mixer.A_log"] == ("model",)
    r = lm("rwkv6", (2, 4))
    assert r.time_split and r.ffn_split and r.shift_split and r.hd == 0
    assert r.pspecs["blocks.0.att.ln_out.scale"] == (None,)
    q = lm("qwen3_int8", (2, 4))
    q.set_cache_spec(B, INT8_STEPS)
    assert q.kv_cols and not q.kv_split and q.cache_spec[4] == "model"
    for variant, M in (("zamba2", 32), ("rwkv6", 16)):
        with pytest.raises(NotImplementedError, match="part of a head"):
            lm(variant, (1, M))


def test_reruns_are_bitwise():
    """rwkv6's first train step on (2, 4) and zamba2's prefill and decode
    again: every parameter, moment, metric and logit bitwise equal
    (collectives add in slot order)."""
    ref = reference("rwkv6")
    a = _train(ref, (2, 4))
    b = _train(ref, (2, 4), n_steps=1, cached=False)
    assert a.metrics[0] == b.metrics[0]
    for (n, x), (_, y) in zip(a.params[0].named_parameters(),
                              b.params[0].named_parameters()):
        assert torch.equal(x, y), n
    for n in a.opt[0].mu:
        assert torch.equal(a.opt[0].mu[n], b.opt[0].mu[n])
        assert torch.equal(a.opt[0].nu[n], b.opt[0].nu[n])
    assert a.launches == b.launches and a.calls == b.calls
    zref = reference("zamba2")
    la, lb = _serve(zref, (2, 4)), _serve(zref, (2, 4), cached=False)
    for x, y in zip(la.logits, lb.logits):
        assert torch.equal(x, y)


def _per_slot_norm(mesh, parts, scales, n, eps):
    """The wrong norm: each slot's columns normed alone (no psum)."""
    return mesh.map(lambda s, t: TL.rmsnorm(scales[s], t, eps), parts)


@pytest.mark.parametrize("variant", ["zamba2", "rwkv6"])
def test_per_slot_norm_is_caught(variant, monkeypatch):
    """Mamba2's gated norm and RWKV6's ``ln_out`` span the split
    dimension: normed per slot, the prompt's logits move from the psummed
    norm's (which ``test_sharded_prefill_and_decode_match`` holds within
    1e-4 of the reference's) by at least 100 x that limit."""
    ref = reference(variant)
    want = _serve(ref, (2, 4)).logits[0].numpy()
    monkeypatch.setattr(SH, "rmsnorm_over_model", _per_slot_norm)
    got = _serve(ref, (2, 4), cached=False).logits[0].numpy()
    gap = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert gap > 100 * 1e-4, gap


def _int8_decode(ref, sharded):
    """INT8_STEPS decode steps from the empty int8 cache, sharded on
    INT8_DIMS or unsharded: (logits of each step, the whole cache, the
    sharded run's launches and group 0's collectives over its first
    PLANNED_STEPS steps)."""
    params = ref.port_params(train=False)
    tok = torch.from_numpy(ref.batches[0]["tokens"])
    out = []
    if not sharded:
        cache = serve_cache_init(ref.cfg, B, INT8_STEPS, dtype=torch.float32,
                                 device="cpu", kv_quant=True)
        for i in range(INT8_STEPS):
            logits, cache = TM.decode_step(params, ref.cfg, cache,
                                           tok[:, i:i + 1])
            out.append(logits.numpy())
        return out, cache, None, None
    mesh = _mesh(INT8_DIMS)
    p = TP.place(params, TP.param_specs(params, ref.cfg, mesh), mesh)
    cache = SH.ShardedLM(ref.cfg, mesh).cache_init(
        B, INT8_STEPS, device="cpu", dtype=torch.float32, kv_quant=True)
    serve = TST.make_sharded_serve_step(ref.cfg, mesh)
    with pytest.MonkeyPatch.context() as mp, record_collectives() as calls:
        count = KernelCount(mp)
        for i in range(INT8_STEPS):
            if i == PLANNED_STEPS:
                planned = list(calls)
            logits, cache = serve(p, cache, tok[:, i:i + 1])
            out.append(logits.numpy())
    whole = TP.gather(cache, TP.cache_specs(serve_cache_init(
        ref.cfg, B, INT8_STEPS, device="meta", kv_quant=True), ref.cfg, None,
        mesh), mesh)
    return out, whole, count.n, [c for c in planned if c.group == 0]


def _hold_int8(logits, cache, want_logits, want_cache):
    """The int8 limits (module docstring) of one run against another's
    logits and cache (numpy or torch)."""
    a, w = cache["attn"], want_cache["attn"]
    np.testing.assert_array_equal(np.asarray(a["kv_pos"]),
                                  np.asarray(w["kv_pos"]))
    agree = np.ones((B, INT8_STEPS), dtype=bool)       # (sequence, step)
    for n in ("k", "v"):
        g, x = (np.asarray(t).astype(np.int32) for t in (a[n], w[n]))
        assert np.abs(g - x).max() <= 1, n
        assert (g != x).sum() <= INT8_FLIPS * g.size, (n, (g != x).sum())
        # slot i holds step i's token (the cache is as long as the run)
        agree &= np.cumprod(~(g != x).any(axis=(0, 3, 4)), axis=1
                            ).astype(bool)
        gs, xs = (np.asarray(t) for t in (a[n + "_scale"], w[n + "_scale"]))
        np.testing.assert_allclose(gs, xs, rtol=SCALE_RTOL, atol=0)
    assert int((np.asarray(a["k"]) != 0).sum()) > 0.9 * np.asarray(
        a["k"]).size
    for i, (g, x) in enumerate(zip(logits, want_logits)):
        x = np.asarray(x)
        gap = (np.abs(np.asarray(g) - x).max(axis=(1, 2))
               / max(np.abs(x).max(), 1.0))
        assert (gap[agree[:, i]] <= 1e-4).all(), (i, gap)
        assert (gap <= FLIPPED_LOGIT_TOL).all(), (i, gap)
    return agree


def test_plans_match_the_cpu_runs():
    """The debug mesh's plans on meta of zamba2's and rwkv6's prefill on
    (2, 4) (the CPU runs' 24-token prompt, into a cache of its length
    where theirs has 40 slots: no collective depends on it) and of the
    int8 decode's first PLANNED_STEPS steps: launches per slot the CPU
    run's over the 8 slots (the int8 decode launches none), collectives
    group 0's, kind by kind and part by part."""
    mesh = TMESH.Mesh((2, 4), ("data", "model"))
    q = reference("qwen3_int8")
    _, _, launches, calls = _int8_decode(q, True)
    runs = [(ref.cfg, TCB.InputShape("p", PROMPT, B, "prefill"), "prefill",
             {}, _serve(ref, (2, 4))) for ref in (reference("zamba2"),
                                                  reference("rwkv6"))]
    for cfg, shape, kind, kw, run_launches, run_calls in [
            (cfg, shape, kind, kw, run.launches, run.calls)
            for cfg, shape, kind, kw, run in runs] + [
            (q.cfg, TCB.InputShape("d", INT8_STEPS, B, "decode"), "decode",
             dict(n_steps=PLANNED_STEPS, kv_quant=True), launches,
             calls)]:
        plan = DRY.plan(cfg, shape, mesh, kind, **kw)
        assert all(v % mesh.size == 0 for v in run_launches.values())
        assert plan["kernel_launches"] == {
            k: v // mesh.size for k, v in run_launches.items() if v}, kind
        assert ([(c.op, c.shapes, c.dtypes) for c in plan["_calls"]]
                == [(c.op, c.shapes, c.dtypes) for c in run_calls]), kind
        assert run_calls, kind


@pytest.mark.parametrize("variant,dims", TRAIN_CASES)
def test_sharded_train_steps_match(variant, dims):
    ref = reference(variant)
    run = _train(ref, dims)
    port_metrics, port_params, port_opt = ref.port_run
    assert run.opt[-1].step == N_STEPS
    for i, got in enumerate(run.metrics):
        want = port_metrics[i]
        assert set(got) == set(want)
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=(i, k))
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    lr_sum = sum(m["lr"] for m in port_metrics)
    n_flip = n_all = 0
    got = dict(run.params[-1].named_parameters())
    for n, w in port_params.named_parameters():
        d = (got[n] - w).detach().abs()
        assert float(d.max()) <= 2 * lr_sum + 1e-6, n
        n_flip += int((d > 1e-6 + 1e-3 * lr_sum).sum())
        n_all += d.numel()
    assert n_flip <= FLIP_FRACTION * n_all, (n_flip, n_all)
    for name in ("mu", "nu"):
        n_off = 0
        for n, w in getattr(port_opt, name).items():
            g = getattr(run.opt[-1], name)[n]
            n_off += int(((g - w).abs() > MOMENT_RTOL * float(
                w.abs().max())).sum())
        assert n_off <= FLIP_FRACTION * n_all, (name, n_off, n_all)
    first = ref.metrics
    for k in METRICS:
        np.testing.assert_allclose(run.metrics[0][k], first[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("variant,dims", SERVE_CASES)
def test_sharded_prefill_and_decode_match(variant, dims):
    """The sharded prompt and decode logits against the reference's and
    the port's unsharded ones; the final states (and the shared block's
    ring) against the port's; the prompt's scans one L4 / L5 launch per
    layer and slot."""
    ref = reference(variant)
    run = _serve(ref, dims)
    want, cache = _port_serve(ref)
    assert len(run.logits) == len(ref.logits) == N_DECODE + 1
    for g, w, u in zip(run.logits, ref.logits, want):
        assert g.shape == w.shape
        assert_rel_close(g.numpy(), w, 1e-4)
        assert_rel_close(g.numpy(), u.numpy(), 1e-4)
    assert run.cache["pos"] == cache["pos"] == PROMPT + N_DECODE
    names = (("mamba", "conv_x"), ("mamba", "conv_B"), ("mamba", "conv_C"),
             ("mamba", "ssm"), ("attn", "k"), ("attn", "v"))
    if ref.cfg.family == "ssm":
        names = (("wkv",), ("shift_att",), ("shift_ffn",))
    for path in names:
        g, w = run.cache, cache
        for n in path:
            g, w = g[n], w[n]
        assert g.shape == w.shape, path
        assert_rel_close(g.numpy(), w.numpy(), 1e-4)
    if ref.cfg.family == "hybrid":
        assert torch.equal(run.cache["attn"]["kv_pos"],
                           cache["attn"]["kv_pos"])
    n = dims[0] * dims[1]
    hybrid = ref.cfg.family == "hybrid"
    scan = "repro_torch::ssd_chunk" if hybrid else "repro_torch::wkv6"
    assert run.launches[scan] == ref.cfg.n_layers * n
    assert run.launches["repro_torch::flash_attention"] == (
        ref.cfg.n_layers // ref.cfg.shared_attn_period * n if hybrid else 0)


def test_int8_sharded_decode_matches():
    """The int8 cache's sharded decode (hd split on (2, 4)) against the
    reference's int8 decode and the port's unsharded one, under the int8
    limits; it launches no kernel, as unsharded."""
    ref = reference("qwen3_int8")
    got, cache, launches, _ = _int8_decode(ref, True)
    want_cache, want = ref.jax["int8"].result()
    agree = _hold_int8(got, cache, want, want_cache)
    assert agree.mean() > 0.5
    u_logits, u_cache, _, _ = _int8_decode(ref, False)
    _hold_int8(got, cache, [t for t in u_logits], u_cache)
    assert not any(launches.values())
    assert cache["attn"]["k"].dtype == torch.int8
