"""The dense family's sharded steps (``models.sharded``, through
``steps.make_sharded_*``) on CPU slots against the reference's UNSHARDED
steps.

Llama-3-8B, Qwen3-4B and ChatGLM3-6B smoke variants in f32 (ChatGLM3's
has 2 KV heads of 32: on the (2, 4) mesh its K/V columns are gathered to
whole heads and its cache is split by head dim) run on the (4, 2) and
(2, 4) meshes, both packages starting from the reference's
``init_params(key(0))`` (``convert.llm_params_from_numpy``) and seeing the
same tokens: 3 train steps of B = 8, S = 128 in 2 microbatches (the
1,024 tokens a step of ``tests/test_torch_train.py`` takes), and a
28-token prompt into a 40-slot f32 cache, then 4 decode steps. The
reference runs its plain attention (no Pallas), jitted, and trains
without remat (the same values, a third of the compile time); the port
trains with it.

Tolerances: loss and grad norm 1e-5 relative at every step, against the
reference and against the port's unsharded step. Parameters and moments
after 3 steps against the port's unsharded step under
``tests/test_torch_train.py``'s limits (every element within 2 · lr_sum,
all but 2e-4 of them within 1e-6 + 1e-3 · lr_sum; moments 2e-4 of the
tensor's largest value, for all but 2e-4 of the elements: the moments
follow the gradients at the flipped parameters), which holds the
unsharded step to the reference; against the reference itself every element within 2 · lr_sum
and no more elements past 1e-6 + 1e-3 · lr_sum than the unsharded step
has (or 2e-4 of them). AdamW's rounding flips (an element whose gradient
is at rounding level moves by up to 2 · lr either way) set that count
at these sizes: at B = 8, S = 32 the unsharded port had 4,876 of
ChatGLM3's 1,246,464 elements past it and its third loss 1.02e-5 from
the reference's, the sharded step 4,954 and the same loss; at S = 128,
24 and 25; Qwen3's unsharded step 391 of 1,312,128 at S = 128, its
sharded step 154. Logits 1e-4 of the largest reference value, as
``tests/test_torch_llm.py``. A rerun is bitwise the same.

One subprocess runs the reference's own sharded train step (GSPMD, on 8
faked host devices with ``AxisType.Auto`` axes, a (4, 2) mesh): its loss
must be the unsharded reference's (1e-5), so the oracle holds; it also
prints GSPMD's collective kinds, which are not Megatron's (it all-gathers
weights where the port reduces activations), so the port's are only
required to exist.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.core.topology import record_collectives
from repro_torch.launch import mesh as TMESH
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from repro_torch.sharding import partitioning as TP
from torch_helpers import (assert_rel_close, llm_cfgs, np_tree,
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3_8b", "qwen3_4b", "chatglm3_6b"]
MESHES = [(4, 2), (2, 4)]
B, S, N_STEPS, MICRO = 8, 128, 3, 2
PROMPT, MAX_LEN, N_DECODE = 32, 40, 4
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
MOMENT_RTOL, FLIP_FRACTION = 2e-4, 2e-4

GSPMD = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.base import TrainConfig, get_config
    from repro.models import model as JM, steps as JST
    from repro.optim import adamw as JA
    from repro.roofline import analysis as ROOF
    from repro.sharding import partitioning as PART
    B, S = %d, %d
    cfg = dataclasses.replace(get_config("llama3_8b").smoke_variant(),
                              dtype="float32")
    tcfg = TrainConfig(microbatches=%d, **%r)
    tree = JM.init_params(jax.random.key(0), cfg)
    opt = JA.init(tree)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": jnp.asarray(tok.astype(np.int32))}
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    with jax.set_mesh(mesh):
        shard = (named(PART.param_specs(tree, cfg, mesh)),
                 named(PART.opt_specs(opt, tree, cfg, mesh)),
                 named(PART.batch_specs(batch, cfg, None, mesh)))
        step = jax.jit(JST.make_train_step(cfg, tcfg), in_shardings=shard,
                       out_shardings=(shard[0], shard[1], None))
        compiled = step.lower(tree, opt, batch).compile()
        _, _, m = compiled(tree, opt, batch)
    print(json.dumps({"loss": float(m["loss"]),
                      "collectives": ROOF.collective_bytes(
                          compiled.as_text())}))
""") % (B, S, MICRO, TRAIN_KW)


@pytest.fixture(scope="module", autouse=True)
def _gspmd_proc():
    """The reference's sharded step, started with the module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", GSPMD], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _batches(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for _ in range(N_STEPS)]


class _Reference:
    """The reference's unsharded train steps, prefill and decode steps."""

    def __init__(self, arch):
        import jax
        import jax.numpy as jnp
        from repro.configs.base import TrainConfig
        from repro.models import model as JM
        from repro.models import steps as JST
        from repro.models.kvcache import serve_cache_init
        from repro.optim import adamw as JA
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32")
        self.tcfg = TCB.TrainConfig(microbatches=MICRO, **TRAIN_KW)
        tree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree0 = np_tree(tree)
        self.batches = _batches(self.cfg)
        step = jax.jit(JST.make_train_step(self.jcfg, TrainConfig(
            **dict(dataclasses.asdict(self.tcfg), remat=False))))
        t, opt, self.metrics = tree, JA.init(tree), []
        for b in self.batches:
            t, opt, m = step(t, opt, {"tokens": jnp.asarray(b)})
            self.metrics.append({k: float(v) for k, v in m.items()})
        self.tree, self.opt = np_tree(t), np_tree(opt._asdict())
        params = CV.llm_params_from_numpy(self.tree0, self.cfg, "cpu",
                                          train=True)
        popt = TA.init(dict(params.named_parameters()))
        pstep = TST.make_train_step(self.cfg, self.tcfg)
        self.port_metrics = []
        for b in self.batches:
            params, popt, m = pstep(params, popt,
                                    {"tokens": torch.from_numpy(b)})
            self.port_metrics.append({k: float(v) for k, v in m.items()})
        self.port_params, self.port_opt = params, popt
        lr_sum = sum(m["lr"] for m in self.metrics)
        self.port_flips = sum(
            int((np.abs(g - w) > 1e-6 + 1e-3 * lr_sum).sum())
            for (_, w), (_, g) in zip(
                _leaves(self.tree),
                _leaves(CV.llm_params_to_numpy(params))))
        toks = jnp.asarray(self.batches[0])
        cache = serve_cache_init(self.jcfg, B, MAX_LEN, dtype=jnp.float32)
        logits, cache = jax.jit(JM.prefill, static_argnums=(1,))(
            tree, self.jcfg, {"tokens": toks[:, :PROMPT - N_DECODE]}, cache)
        self.logits = [np.asarray(logits)]
        dstep = jax.jit(lambda p, c, x: JM.decode_step(p, self.jcfg, c, x))
        for i in range(PROMPT - N_DECODE, PROMPT):
            logits, cache = dstep(tree, cache, toks[:, i:i + 1])
            self.logits.append(np.asarray(logits))


_REFS = {}


def reference(arch):
    if arch not in _REFS:
        _REFS[arch] = _Reference(arch)
    return _REFS[arch]


_TRAINED = {}


def _train(ref, dims, cached=True):
    key = (ref.cfg.name, dims)
    if cached and key in _TRAINED:
        return _TRAINED[key]
    _TRAINED[key] = _train_run(ref, dims)
    return _TRAINED[key]


def _train_run(ref, dims):
    mesh = TMESH.Mesh(dims, ("data", "model"), ("cpu",))
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu", train=True)
    opt = TA.init(dict(params.named_parameters()))
    pspecs = TP.param_specs(params, ref.cfg, mesh)
    ospecs = TP.opt_specs(opt, params, ref.cfg, mesh)
    p, o = TP.place(params, pspecs, mesh), TP.place(opt, ospecs, mesh)
    step = TST.make_sharded_train_step(ref.cfg, ref.tcfg, mesh)
    metrics = []
    with record_collectives() as calls:
        for b in ref.batches:
            p, o, m = step(p, o, {"tokens": torch.from_numpy(b)})
            metrics.append({k: float(v) for k, v in m.items()})
    return (TP.gather(p, pspecs, mesh), TP.gather(o, ospecs, mesh), metrics,
            calls)


def _serve(ref, dims):
    mesh = TMESH.Mesh(dims, ("data", "model"), ("cpu",))
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu")
    p = TP.place(params, TP.param_specs(params, ref.cfg, mesh), mesh)
    shape = TCB.InputShape("prompt", MAX_LEN, B, "prefill")
    prefill = TST.make_sharded_prefill_step(ref.cfg, shape, mesh)
    serve = TST.make_sharded_serve_step(ref.cfg, mesh)
    toks = torch.from_numpy(ref.batches[0])
    logits, cache = prefill(p, {"tokens": toks[:, :PROMPT - N_DECODE]})
    out = [logits]
    for i in range(PROMPT - N_DECODE, PROMPT):
        logits, cache = serve(p, cache, toks[:, i:i + 1])
        out.append(logits)
    return out, cache


def _leaves(tree):
    import jax
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_reference(arch, dims):
    ref = reference(arch)
    params, opt, metrics, calls = _train(ref, dims)
    for i, got in enumerate(metrics):
        for want in (ref.metrics[i], ref.port_metrics[i]):
            assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
            for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5),
                            ("lr", 1e-6)):
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           err_msg=(i, k))
    assert len(calls) > 0
    assert opt.step == int(ref.opt["step"]) == N_STEPS
    lr_sum = sum(m["lr"] for m in ref.metrics)
    got = CV.llm_params_to_numpy(params)
    port = CV.llm_params_to_numpy(ref.port_params)
    flips = {}
    for name, want in (("port", port), ("reference", ref.tree)):
        n_flip = n_all = 0
        for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
            d = np.abs(g - w)
            assert float(d.max()) <= 2 * lr_sum + 1e-6, (name, path)
            n_flip += int((d > 1e-6 + 1e-3 * lr_sum).sum())
            n_all += d.size
        flips[name] = n_flip
    assert flips["port"] <= FLIP_FRACTION * n_all, (flips, n_all)
    assert flips["reference"] <= max(FLIP_FRACTION * n_all,
                                     ref.port_flips), (flips, n_all)
    got_opt = CV.adamw_state_to_numpy(opt, params)
    port_opt = CV.adamw_state_to_numpy(ref.port_opt, ref.port_params)
    for name in ("mu", "nu"):
        n_off = n_all = 0
        for (path, want), (_, g) in zip(_leaves(port_opt[name]),
                                        _leaves(got_opt[name])):
            n_off += int((np.abs(g - want) > MOMENT_RTOL * float(
                np.abs(want).max())).sum())
            n_all += want.size
        assert n_off <= FLIP_FRACTION * n_all, (name, n_off, n_all)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(arch, dims):
    ref = reference(arch)
    got, cache = _serve(ref, dims)
    assert len(got) == len(ref.logits) == N_DECODE + 1
    for g, w in zip(got, ref.logits):
        assert g.shape == w.shape
        assert_rel_close(g.numpy(), w, 1e-4)
    mesh = TMESH.Mesh(dims, ("data", "model"))
    assert all(c["pos"] == PROMPT for c in cache.values())
    split = "hd" if ref.cfg.n_kv_heads % dims[1] else "heads"
    k = cache[(0, 0)]["attn"]["k"]
    want = (ref.cfg.n_layers, B // dims[0], MAX_LEN) + (
        (ref.cfg.n_kv_heads, 32 // dims[1]) if split == "hd" else
        (ref.cfg.n_kv_heads // dims[1], 32))
    assert tuple(k.shape) == want and mesh.size == 8


def test_reruns_are_bitwise():
    """The same train steps and serve steps twice: every parameter,
    moment and logit bitwise equal (collectives add in slot order)."""
    ref = reference("chatglm3_6b")
    a, oa, ma, _ = _train(ref, (2, 4))
    b, ob, mb, _ = _train(ref, (2, 4), cached=False)
    assert ma == mb
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    for n in oa.mu:
        assert torch.equal(oa.mu[n], ob.mu[n])
        assert torch.equal(oa.nu[n], ob.nu[n])
    la, _ = _serve(ref, (4, 2))
    lb, _ = _serve(ref, (4, 2))
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "zamba2_7b",
                                  "rwkv6_7b", "whisper_medium",
                                  "internvl2_1b"])
def test_other_families_raise(arch):
    """Every family builds its sharded step factories (this file runs the
    dense family's, ``tests/test_torch_sharded_families.py`` the vlm, moe
    and audio families' and ``tests/test_torch_sharded_recurrent.py`` the
    hybrid and ssm families' and the int8 decode). The sharded prefill
    takes no cache, so it cannot fill an int8 one (as unsharded: only
    decode fills one), though the int8 cache builds; an int8 cache for a
    family that has none raises."""
    from repro_torch.models.kvcache import QUANT_FAMILIES
    from repro_torch.models.sharded import ShardedLM
    cfg = TCB.get_config(arch).smoke_variant()
    mesh = TMESH.Mesh((2, 2), ("data", "model"), ("cpu",))
    shape = TCB.InputShape("p", 16, 2, "prefill")
    TST.make_sharded_train_step(cfg, TCB.TrainConfig(), mesh)
    TST.make_sharded_serve_step(cfg, mesh)
    prefill = TST.make_sharded_prefill_step(cfg, shape, mesh)
    lm = ShardedLM(cfg, mesh)
    if cfg.family not in QUANT_FAMILIES:
        with pytest.raises(NotImplementedError, match="no int8 cache"):
            lm.cache_init(2, 16, device="cpu", kv_quant=True)
        return
    cache = lm.cache_init(2, 16, device="cpu", kv_quant=True)
    assert cache[(0, 0)]["attn"]["k"].dtype == torch.int8
    assert list(inspect.signature(prefill).parameters) == ["params",
                                                           "batch"]
    with pytest.raises(TypeError):
        prefill(None, {"tokens": torch.zeros((2, 16), dtype=torch.int32)},
                cache)


def test_gspmd_oracle_holds(_gspmd_proc):
    """The reference's own sharded step (GSPMD, 4 x 2 Auto mesh) gives
    the unsharded reference's loss; its collective kinds are printed."""
    out, err = _gspmd_proc.communicate(timeout=600)
    assert _gspmd_proc.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    ref = reference("llama3_8b")
    np.testing.assert_allclose(rec["loss"], ref.metrics[0]["loss"],
                               rtol=1e-5)
    kinds = {k: v for k, v in rec["collectives"].items()
             if k.startswith("n_") and v}
    print("GSPMD collectives (4 x 2, llama3 smoke train step):", kinds)
    assert kinds
