"""The vlm, moe and audio families' sharded steps (``models.sharded``,
through ``steps.make_sharded_*``) on CPU slots against the reference's
UNSHARDED steps and the port's.

InternVL2-1B, Granite-MoE-1B and Whisper-medium smoke variants in f32
run on the (2, 4) mesh, Granite also on (4, 2): its 4 experts are
expert-parallel on both (1 and 2 per model slot). A Granite variant with
6 experts, which 'model' = 4 does not divide, takes the FSDP branch on
(2, 4): ``w_gate`` / ``w_up`` (E, 'data', 'model'), ``w_down`` (E,
'model', 'data'), gathered over 'data' in every layer. InternVL2's 2 KV
heads of 32 on the (2, 4) mesh gather their K/V columns to whole heads
and split the cache by head dim, now behind 8 image positions.

Both packages start from the same seeded weights (the port's
``init_params`` on a torch generator seeded 0, as the reference's
layout through ``convert.llm_params_to_numpy``, and back through
``convert.llm_params_from_numpy``) and see the same seeded numpy
inputs: 2 train steps of B = 8, S = 64 in 2 microbatches (plus 8 image
embeddings or 16 audio frames a row), and a 24-token prompt into a
40-slot f32 cache, then 4 decode steps. The reference runs its plain
attention (no Pallas), jitted at XLA's backend optimization level 0,
and trains without remat (the same values); the port trains with it.

Tolerances: loss, grad norm and ``moe_aux`` 1e-5 relative against the
port's unsharded step at both steps and against the reference's first
step (``moe_dropped`` too: it counts kept pairs, so it is exact up to
f32 rounding); the parameters and moments after the last step against
the port's unsharded step, and the logits 1e-4 of the largest reference
value, as ``tests/test_torch_sharded_steps.py`` holds them. A rerun is
bitwise the same. In bf16, the FSDP branch reduce-scatters its expert
gradients over 'data' in f32.
The aux loss enters once: the sharded gradient of every layer's
``router`` is the unsharded one (1e-5 of its largest value), where an
aux counted once per model slot would move it by 3 × the aux term's own
gradient, which the test shows is far above that limit.
"""
import concurrent.futures
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.core.topology import record_collectives
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from repro_torch.models.sharded import ShardedLM
from repro_torch.optim import adamw as TA
from repro_torch.sharding import partitioning as TP
from torch_helpers import (KernelCount, assert_rel_close, llm_cfgs,
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# variant -> (arch, config fields replaced)
VARIANTS = {"internvl2": ("internvl2_1b", {}),
            "granite": ("granite_moe_1b_a400m", {}),
            "granite_e6": ("granite_moe_1b_a400m", {"n_experts": 6}),
            "whisper": ("whisper_medium", {})}
CASES = [("internvl2", (2, 4)), ("granite", (2, 4)), ("granite", (4, 2)),
         ("granite_e6", (2, 4)), ("whisper", (2, 4))]
B, S, N_STEPS, MICRO = 8, 64, 2, 2
PROMPT, MAX_LEN, N_DECODE = 24, 40, 4
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
METRICS = ("loss", "grad_norm", "moe_aux", "moe_dropped")
# the parameters and moments after the last step against the port's
# unsharded step, as tests/test_torch_sharded_steps.py holds them: every
# parameter within 2 × the summed lr, at most FLIP_FRACTION of the entries
# off by more than 1e-3 of it (an AdamW update of a near-zero gradient
# can turn on f32 rounding), and of each moment at most FLIP_FRACTION off
# by more than MOMENT_RTOL of its largest value
MOMENT_RTOL, FLIP_FRACTION = 2e-4, 2e-4


def _mesh(dims):
    return TMESH.Mesh(dims, ("data", "model"), ("cpu",))


def _inputs(cfg):
    """The train batches (numpy) of a variant; batch 0's first PROMPT +
    N_DECODE tokens are the serve prompt and decode tokens."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
        if cfg.family == "vlm":
            b["image_embeds"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["audio_embeds"] = rng.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompt(batch):
    return {k: (v[:, :PROMPT] if k == "tokens" else v)
            for k, v in batch.items()}


def _compiled(fn, *args):
    """``fn`` jitted for ``args`` at XLA's backend optimization level 0,
    as ``tests/test_torch_recurrent_train.py`` compiles the reference: a
    shorter CPU compile, results moved by f32 rounding only."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def _jax_reference(jcfg, tcfg, tree0, batch):
    """The reference's first train step's metrics and the logits of its
    prefill and N_DECODE decode steps, from the numpy weights ``tree0``
    and inputs ``batch``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.models import model as JM
    from repro.models import steps as JST
    from repro.models.kvcache import serve_cache_init
    from repro.optim import adamw as JA
    tree = jax.tree.map(jnp.asarray, tree0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = JA.init(tree)
    step = JST.make_train_step(jcfg, TrainConfig(
        **dict(dataclasses.asdict(tcfg), remat=False)))
    metrics = _compiled(lambda p, o, b: step(p, o, b)[2], tree, opt, jb)(
        tree, opt, jb)
    metrics = {k: float(v) for k, v in metrics.items()}
    cache = serve_cache_init(jcfg, B, MAX_LEN, dtype=jnp.float32)
    prompt = _prompt(jb)
    logits, cache = _compiled(lambda p, b, c: JM.prefill(p, jcfg, b, c),
                              tree, prompt, cache)(tree, prompt, cache)
    out = [np.asarray(logits)]
    tok = jb["tokens"]
    dstep = _compiled(lambda p, c, x: JM.decode_step(p, jcfg, c, x), tree,
                      cache, tok[:, :1])
    for i in range(PROMPT, PROMPT + N_DECODE):
        logits, cache = dstep(tree, cache, tok[:, i:i + 1])
        out.append(np.asarray(logits))
    return metrics, out


class _Reference:
    """A variant's weights and inputs, the reference's unsharded first
    train step, prefill and decode steps (compiled and run on ``pool``'s
    thread, so that the variants' XLA compiles overlap the port's runs),
    and the port's unsharded train steps."""

    def __init__(self, variant, pool):
        arch, kw = VARIANTS[variant]
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", **kw)
        self.tcfg = TCB.TrainConfig(microbatches=MICRO, **TRAIN_KW)
        self.tree0 = CV.llm_params_to_numpy(TM.init_params(
            self.cfg, torch.Generator().manual_seed(0), "cpu", train=True))
        self.batches = _inputs(self.cfg)
        self.jax = pool.submit(_jax_reference, self.jcfg, self.tcfg,
                               self.tree0, self.batches[0])
        self._port = None

    @property
    def port_metrics(self):
        """The port's unsharded train steps' metrics."""
        return self.port_run[0]

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
        return self.jax.result()[0]

    @property
    def logits(self):
        return self.jax.result()[1]

    def port_params(self, train):
        return CV.llm_params_from_numpy(self.tree0, self.cfg, "cpu",
                                        train=train)


_REFS = {}


@pytest.fixture(scope="module", autouse=True)
def _references():
    """Every variant's reference, started with the module on one thread
    (JAX's tracing holds the interpreter lock, so more threads would not
    overlap each other); every result is read before the thread ends."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        for v in VARIANTS:
            _REFS[v] = _Reference(v, pool)
        yield
        for ref in _REFS.values():
            ref.jax.result()
    _REFS.clear()


def reference(variant):
    return _REFS[variant]


_TRAINED = {}


class _Run(NamedTuple):
    """A sharded training run: the parameters, moments and metrics after
    each step (gathered), and the first step's kernel launches (every
    slot's) and group 0's collectives."""
    params: list
    opt: list
    metrics: list
    launches: dict
    calls: list


def _train(ref, dims, n_steps=N_STEPS, cached=True):
    key = (ref.cfg.name, ref.cfg.n_experts, dims)
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


def _sharded_grads(cfg, tcfg, mesh, params, batch):
    """The whole f32 gradients of one sharded train step from ``params``
    on ``batch``, gathered before its update (``grads_out``)."""
    opt = TA.init(dict(params.named_parameters()))
    p = TP.place(params, TP.param_specs(params, cfg, mesh), mesh)
    o = TP.place(opt, TP.opt_specs(opt, params, cfg, mesh), mesh)
    grads = {}
    TST.make_sharded_train_step(cfg, tcfg, mesh)(p, o, batch,
                                                 grads_out=grads)
    return grads


def _serve(ref, dims):
    mesh = _mesh(dims)
    params = ref.port_params(train=False)
    p = TP.place(params, TP.param_specs(params, ref.cfg, mesh), mesh)
    shape = TCB.InputShape("prompt", MAX_LEN, B, "prefill")
    prefill = TST.make_sharded_prefill_step(ref.cfg, shape, mesh)
    serve = TST.make_sharded_serve_step(ref.cfg, mesh)
    b = _torch(ref.batches[0])
    logits, cache = prefill(p, _prompt(b))
    out = [logits]
    for i in range(PROMPT, PROMPT + N_DECODE):
        logits, cache = serve(p, cache, b["tokens"][:, i:i + 1])
        out.append(logits)
    return out, cache


def test_branches_are_the_intended_ones():
    """Granite's 4 experts are expert-parallel on both meshes, 6 take
    the FSDP branch on (2, 4); InternVL2's 2 KV heads split the cache by
    head dim on (2, 4); whisper's b_out stays replicated."""
    def lm(variant, dims):
        arch, kw = VARIANTS[variant]
        cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(), **kw)
        return ShardedLM(cfg, TMESH.Mesh(dims, ("data", "model")))
    for dims in ((2, 4), (4, 2)):
        g = lm("granite", dims)
        assert g.expert_split and not g.expert_fsdp and not g.fsdp
    f = lm("granite_e6", (2, 4))
    assert not f.expert_split and f.expert_fsdp and f.mlp_split
    assert f.fsdp == {f"blocks.{i}.mlp.{n}" for i in range(2)
                      for n in ("w_gate", "w_up", "w_down")}
    assert f.pspecs["blocks.0.mlp.w_gate"] == (None, "data", "model")
    assert f.pspecs["blocks.0.mlp.w_down"] == (None, "model", "data")
    v = lm("internvl2", (2, 4))
    v.set_cache_spec(B, MAX_LEN)
    assert v.kv_cols and not v.kv_split and v.cache_spec[4] == "model"
    w = lm("whisper", (2, 4))
    assert w.mlp_split and w.pspecs["blocks.0.mlp.b_out"] == (None,)
    assert w.pspecs["blocks.0.mlp.b_in"] == ("model",)
    assert w.pspecs["blocks.0.cross_attn.wo"] == ("model", None)


@pytest.mark.parametrize("variant,dims", CASES)
def test_sharded_train_steps_match(variant, dims):
    ref = reference(variant)
    run = _train(ref, dims)
    metrics = run.metrics
    assert run.opt[-1].step == N_STEPS
    for i, got in enumerate(metrics):
        want = ref.port_metrics[i]
        assert set(got) == set(want)
        assert ("moe_aux" in got) == ref.cfg.is_moe
        for k in METRICS:
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=(i, k))
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    _, port_params, port_opt = ref.port_run
    lr_sum = sum(m["lr"] for m in ref.port_metrics)
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
    assert set(metrics[0]) == set(first)
    for k in METRICS:
        if k in first:
            np.testing.assert_allclose(metrics[0][k], first[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("variant,dims", CASES)
def test_sharded_prefill_and_decode_match_reference(variant, dims):
    ref = reference(variant)
    got, cache = _serve(ref, dims)
    assert len(got) == len(ref.logits) == N_DECODE + 1
    for g, w in zip(got, ref.logits):
        assert g.shape == w.shape
        assert_rel_close(g.numpy(), w, 1e-4)
    cfg = ref.cfg
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    assert all(c["pos"] == n_img + PROMPT + N_DECODE
               for c in cache.values())
    hd = cfg.resolved_head_dim
    kv = ((cfg.n_kv_heads, hd // dims[1]) if cfg.n_kv_heads % dims[1]
          else (cfg.n_kv_heads // dims[1], hd))
    c0 = cache[(0, 0)]
    assert tuple(c0["attn"]["k"].shape) == (cfg.n_layers, B // dims[0],
                                            MAX_LEN) + kv
    if cfg.is_encdec:
        F_ = cfg.n_audio_frames
        assert tuple(c0["cross_k"].shape) == (cfg.n_layers, B // dims[0],
                                              F_) + kv
        assert torch.equal(c0["cross_pos"], torch.arange(F_,
                                                         dtype=torch.int32))


def test_reruns_are_bitwise():
    """The same train step (the FSDP branch) and serve steps (whisper)
    again: every parameter, moment, metric and logit bitwise equal
    (collectives add in slot order)."""
    ref = reference("granite_e6")
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
    wref = reference("whisper")
    la, _ = _serve(wref, (2, 4))
    lb, _ = _serve(wref, (2, 4))
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_moe_aux_enters_the_loss_once():
    """The sharded gradient of each layer's router is the unsharded one:
    the aux loss's data fractions are averaged before the product and the
    term reaches the loss through one model slot per data row. Counted
    once per model slot (4), the router's gradient would be off by 3 ×
    0.01 × the aux term's own gradient, far past the limit."""
    ref = reference("granite")
    cfg, tcfg = ref.cfg, ref.tcfg
    batch = _torch(ref.batches[0])
    params = ref.port_params(train=True)
    rows = B // MICRO
    routers = {n: p for n, p in params.named_parameters()
               if n.endswith("mlp.router")}
    aux_grads = dict.fromkeys(routers, 0.0)
    for i in range(MICRO):
        chunk = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss, metrics = TST.loss_fn(params, cfg, chunk)
        g = torch.autograd.grad(0.01 * metrics["moe_aux"] / MICRO,
                                list(routers.values()), retain_graph=True)
        for n, gi in zip(routers, g):
            aux_grads[n] = aux_grads[n] + gi
        (loss / MICRO).backward()
    want = {n: p.grad for n, p in routers.items()}
    got = _sharded_grads(cfg, tcfg, _mesh((2, 4)), params, batch)
    assert len(want) == cfg.n_layers
    for n, w in want.items():
        scale = float(w.abs().max())
        assert float((got[n] - w).abs().max()) <= 1e-5 * scale, n
        assert 3 * float(aux_grads[n].abs().max()) > 100 * 1e-5 * scale, n


def test_fsdp_expert_gradients_reduce_in_f32():
    """The FSDP branch in bf16 (the published dtype) on (2, 4), one
    microbatch of batch 0: the expert weights are gathered over 'data' as
    their f32 master shards and cast after, so the gather's transpose
    reduce-scatters their gradients in f32, as ``_reduce`` sums every
    other parameter's (a bf16 gather would add the data slots' partials
    in bf16). Their gradients are held to the unsharded bf16 step's: the
    two differ by the bf16 rounding of their forwards (~0.05 relative
    here, beside ~0.18 between either and the f32 gradients), so the
    limits are 0.1 from the unsharded ones and at most 1.5 × the
    unsharded step's distance from the f32 gradients, and the
    reduce-scatters' dtype is what tells the f32 sum from a bf16 one."""
    ref = reference("granite_e6")
    cfg = dataclasses.replace(ref.cfg, dtype="bfloat16")
    tcfg = dataclasses.replace(ref.tcfg, microbatches=1)
    batch = _torch(ref.batches[0])
    params = ref.port_params(train=True)
    want = {}
    for c in (cfg, ref.cfg):
        TST.loss_fn(params, c, batch)[0].backward()
        want[c.dtype] = {n: p.grad for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
    mesh = _mesh((2, 4))
    with record_collectives() as calls:
        got = _sharded_grads(cfg, tcfg, mesh, params, batch)
    lm, mlp = ShardedLM(cfg, mesh), params.blocks[0].mlp
    shapes = {TP.shard_shape(mesh, tuple(
        None if e == "data" else e for e in lm.pspecs[f"blocks.0.mlp.{n}"]),
        tuple(getattr(mlp, n).shape)) for n in ("w_gate", "w_up", "w_down")}
    scatters = [c for c in calls if c.op == "psum_scatter"
                and c.shapes[0] in shapes]
    # each layer's three expert weights, gathered once by each of the 2
    # data rows' 4 model groups in the remat recompute
    assert len(scatters) == 3 * cfg.n_layers * mesh.axis_size("model")
    assert all(set(c.dtypes) == {"float32"} for c in scatters)
    experts = [n for n in got if n.rsplit(".", 1)[-1] in
               ("w_gate", "w_up", "w_down")]
    assert len(experts) == 3 * cfg.n_layers

    def dist(a, b):
        return (sum(float((a[n] - b[n]).square().sum()) for n in experts)
                / sum(float(b[n].square().sum()) for n in experts)) ** 0.5

    assert dist(got, want["bfloat16"]) <= 0.1
    assert dist(got, want["float32"]) <= 1.5 * dist(want["bfloat16"],
                                                     want["float32"])


def test_fsdp_plan_gathers_experts_over_data():
    """The dry run's plan of the FSDP variant's train step on (2, 4):
    every layer's three expert weights all-gathered over 'data' (in the
    forward and in its remat recompute, each microbatch), and its
    launches and collectives per slot the CPU run's (launches over the 8
    slots, collectives group 0's)."""
    ref = reference("granite_e6")
    cfg, tcfg = ref.cfg, ref.tcfg
    shape = TCB.InputShape("t", S, B, "train")
    plan = DRY.plan(cfg, shape, TMESH.Mesh((2, 4), ("data", "model")),
                    "train", tcfg)
    lm = ShardedLM(cfg, TMESH.Mesh((2, 4), ("data", "model")))
    mlp = lm.meta_params.blocks[0].mlp
    shards = {TP.shard_shape(lm.mesh, lm.pspecs[f"blocks.0.mlp.{n}"],
                             tuple(getattr(mlp, n).shape))
              for n in ("w_gate", "w_up", "w_down")}
    gathers = [c for c in plan["_calls"] if c.op == "all_gather"
               and len(c.shapes) == 2 and c.shapes[0] in shards]
    assert len(gathers) == 3 * cfg.n_layers * 2 * MICRO
    assert plan["collectives"]["n_all-gather"] >= len(gathers)
    run = _train(ref, (2, 4))
    n = 8
    assert all(v % n == 0 for v in run.launches.values())
    assert plan["kernel_launches"] == {k: v // n for k, v in
                                       run.launches.items() if v}
    assert ([(c.op, c.shapes, c.dtypes) for c in plan["_calls"]]
            == [(c.op, c.shapes, c.dtypes) for c in run.calls])


def test_int8_sharded_decode_matches():
    """The sharded decode of granite-moe's int8 cache (its 4 KV heads
    split over 'model' = 2, and with them the scales) from the empty
    cache, 8 steps, against the port's unsharded int8 decode: every
    logit 1e-4 of the largest unsharded one where the two caches' int8
    entries agree so far, 1e-3 where one was rounded the other way
    (``tests/test_torch_sharded_recurrent.py``'s int8 limits), at most
    1e-3 of the entries off by one and none by more, the scales within
    1e-5 relative; and no kernel launched."""
    from repro_torch.models.kvcache import serve_cache_init
    cfg = dataclasses.replace(
        TCB.get_config("granite_moe_1b_a400m").smoke_variant(),
        dtype="float32")
    n_tok = 8
    mesh = TMESH.Mesh((2, 2), ("data", "model"), ("cpu",))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = TP.place(params, TP.param_specs(params, cfg, mesh), mesh)
    cache = ShardedLM(cfg, mesh).cache_init(4, n_tok, device="cpu",
                                            dtype=torch.float32,
                                            kv_quant=True)
    want = serve_cache_init(cfg, 4, n_tok, dtype=torch.float32, device="cpu",
                            kv_quant=True)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, n_tok)).astype(np.int32))
    serve = TST.make_sharded_serve_step(cfg, mesh)
    got, ref = [], []
    with pytest.MonkeyPatch.context() as mp:
        count = KernelCount(mp)
        for i in range(n_tok):
            lg, cache = serve(p, cache, tok[:, i:i + 1])
            got.append(lg)
            lw, want = TM.decode_step(params, cfg, want, tok[:, i:i + 1])
            ref.append(lw)
    assert not any(count.n.values())
    whole = TP.gather(cache, TP.cache_specs(want, cfg, None, mesh), mesh)
    a, w = whole["attn"], want["attn"]
    assert tuple(cache[(0, 0)]["attn"]["k_scale"].shape) == (
        cfg.n_layers, 2, n_tok, cfg.n_kv_heads // 2)
    assert torch.equal(a["kv_pos"], w["kv_pos"])
    agree = torch.ones((4, n_tok), dtype=torch.bool)
    for n in ("k", "v"):
        d = (a[n].int() - w[n].int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()
        agree &= torch.cumprod((d == 0).all(dim=4).all(dim=3).all(dim=0),
                               dim=1).bool()
        torch.testing.assert_close(a[n + "_scale"], w[n + "_scale"],
                                   rtol=1e-5, atol=0)
    for i, (g, x) in enumerate(zip(got, ref)):
        gap = (g - x).abs().amax(dim=(1, 2)) / max(float(x.abs().max()), 1.0)
        assert bool((gap[agree[:, i]] <= 1e-4).all()), (i, gap)
        assert bool((gap <= 1e-3).all()), (i, gap)


@pytest.mark.parametrize("experts", [False, True])
def test_mm_f32_rounds_once(experts):
    """The row-parallel partial product in bf16 (a (…, k) @ w (k, n), or
    per expert (e, n, k) @ (e, k, n') as the FSDP branch's ``w_down``):
    its forward is the f32 product of the exact f32 copies, its backward
    the bf16 one of ``a @ w``, which the unsharded model runs."""
    from repro_torch.models.sharded import mm_f32
    g = torch.Generator().manual_seed(0)
    shapes = ((3, 5, 16), (3, 16, 8)) if experts else ((2, 5, 16), (16, 8))
    a, w = (torch.randn(s, generator=g).to(torch.bfloat16).requires_grad_()
            for s in shapes)
    out = mm_f32(a, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.detach().float() @ w.detach().float())
    gout = torch.randn(out.shape, generator=g)
    ga, gw = torch.autograd.grad(out, (a, w), gout)
    a2, w2 = (t.detach().clone().requires_grad_() for t in (a, w))
    want = torch.autograd.grad(a2 @ w2, (a2, w2), gout.to(torch.bfloat16))
    assert ga.dtype == gw.dtype == torch.bfloat16
    assert torch.equal(ga, want[0]) and torch.equal(gw, want[1])
