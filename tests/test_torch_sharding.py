"""The port's placement layer (``sharding/``, ``launch/mesh``,
``launch/dryrun``) against the reference's ``repro.sharding``.

Spec trees are compared path by path on meshes without devices (the
reference's ``AbstractMesh``, the port's ``Mesh(shape, axes)``) at the
full configs of all ten architectures: a port parameter's spec is the
reference's spec of its stacked (L, …) array without the L entry. The
reference's ``constrain`` is run under ``use_abstract_mesh`` with
``with_sharding_constraint`` patched in this test to capture the spec it
would pass. Placement is checked against ``NamedSharding.shard_shape``
and by a bitwise round trip. The dry run plans one slot's program on
``meta``: its launches and collectives must be one slot's share of a
CPU run of the same step on every slot.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import base as TCB
from repro_torch.core.topology import record_collectives
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from repro_torch.sharding import constraints as TC
from repro_torch.sharding import partitioning as TP
from torch_helpers import KernelCount, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
DECODE_SHAPES = ("decode_32k", "long_500k")
BATCH_SHAPES = ("train_4k", "prefill_32k")


def _meshes():
    from jax.sharding import AbstractMesh
    return [(AbstractMesh(shape, axes), TMESH.Mesh(shape, axes))
            for shape, axes in MESHES]


def _flat(tree):
    """The reference's spec tree as {path: spec tuple}."""
    import jax
    from jax.sharding import PartitionSpec as P
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_port_flat(v, path))
        else:
            out[path] = v
    return out


def _by_ref_path(port_specs, cfg):
    """The port's per-parameter specs by the reference's path, each
    layer's spec checked equal to layer 0's (one rule per stack)."""
    out = {}
    for name, spec in port_specs.items():
        path, stacked = TP.ref_path(name)
        if path in out:
            assert out[path] == spec, name
        out[path] = spec
    return out


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch):
    from repro.configs.base import get_config
    from repro.models import steps as JST
    from repro.sharding import partitioning as JP
    jcfg, cfg = get_config(arch), TCB.get_config(arch)
    jparams, jopt = JST.params_specs(jcfg), JST.opt_specs(jcfg)
    params = TST.params_specs(cfg)
    opt = TA.init(dict(params.named_parameters()))
    stacked = {TP.ref_path(n)[0]: TP.ref_path(n)[1]
               for n, _ in params.named_parameters()}
    for amesh, mesh in _meshes():
        want = _flat(JP.param_specs(jparams, jcfg, amesh))
        got = _by_ref_path(TP.param_specs(params, cfg, mesh), cfg)
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == (spec[1:] if stacked[path] else spec), \
                (mesh, path)
        wopt = JP.opt_specs(jopt, jparams, jcfg, amesh)
        gopt = TP.opt_specs(opt, params, cfg, mesh)
        assert gopt.step == tuple(wopt.step) == ()
        for field in ("mu", "nu"):
            w = _flat(getattr(wopt, field))
            g = _by_ref_path(getattr(gopt, field), cfg)
            for path, spec in w.items():
                assert g[path] == (spec[1:] if stacked[path] else spec), \
                    (mesh, field, path)


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_batch_cache_and_logits_specs_match_reference(arch):
    """``batch_specs`` on every train and prefill shape, ``cache_specs``
    on the decode shapes (bf16, and the int8 cache of the families that
    have one), ``logits_spec``; the port's extra cache leaf
    ``cross_pos`` is replicated."""
    from repro.configs.base import INPUT_SHAPES, get_config
    from repro.models import steps as JST
    from repro.sharding import partitioning as JP
    jcfg, cfg = get_config(arch), TCB.get_config(arch)
    for amesh, mesh in _meshes():
        for name in BATCH_SHAPES:
            jshape, shape = INPUT_SHAPES[name], TCB.INPUT_SHAPES[name]
            want = _flat(JP.batch_specs(JST.batch_specs(jcfg, jshape), jcfg,
                                        jshape, amesh))
            got = TP.batch_specs(TST.batch_specs(cfg, shape), cfg, shape,
                                 mesh)
            assert got == want, (mesh, name)
        for name in DECODE_SHAPES:
            jshape, shape = INPUT_SHAPES[name], TCB.INPUT_SHAPES[name]
            if not TCB.shape_supported(cfg, shape)[0]:
                continue
            win = TST.long_context_window(cfg, shape)
            pairs = [(JST.cache_specs, TST.cache_specs)]
            if cfg.family in ("dense", "moe", "vlm"):
                pairs.append((JST.cache_specs_quant, TST.cache_specs_quant))
            for jfn, tfn in pairs:
                want = _flat(JP.cache_specs(jfn(jcfg, jshape,
                                                window_override=win),
                                            jcfg, jshape, amesh))
                got = _port_flat(TP.cache_specs(
                    tfn(cfg, shape, window_override=win), cfg, shape, mesh))
                assert set(want) <= set(got)
                for path, spec in want.items():
                    assert got[path] == spec, (mesh, name, path)
                extra = set(got) - set(want)
                assert extra <= {"cross_pos"}
                for path in extra:
                    assert got[path] == (None,)
        for vocab in (cfg.padded_vocab_size, 1000, 7):
            assert TP.logits_spec(mesh, vocab) == tuple(
                JP.logits_spec(amesh, vocab))


CONSTRAIN_CASES = [
    ((32, 8, 6), (("pod", "data"), None, "model")),
    ((32, 8, 6), ("data", None, "model")),
    ((30, 8, 6), (("pod", "data"), None, "model")),
    ((32, 7, 3), ("data", "model", "model")),
    ((48, 4, 16, 32), (("data",), None, "model", None)),
    ((4, 4, 2, 32), ("data", None, "model", None)),
    ((8,), ("pod",)),
    ((8, 8), (None, None)),
    ((64, 16), (("data", "model"), None)),
]


def test_constrain_filters_as_the_reference():
    """Missing axes, tuple axes, non-divisible dims: the port's
    ``constraint_spec`` (and a ``Sharded`` value's placement after
    ``constrain``) equals the spec the reference would hand
    ``with_sharding_constraint``; ``batch_axes`` too. With no mesh both
    are no-ops, and a plain tensor passes as it is."""
    import jax
    import jax.numpy as jnp
    from repro.sharding import constraints as JC
    x = torch.zeros(4, 3)
    assert TC.constrain(x, "data", None) is x
    assert TC.batch_axes() is None and TC.constraint_spec((4,), "data") \
        is None
    assert JC.batch_axes() is None
    caught = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "with_sharding_constraint",
                   lambda v, s: (caught.append(tuple(s)), v)[1])
        for amesh, mesh in _meshes():
            with jax.sharding.use_abstract_mesh(amesh), TC.use_mesh(mesh):
                assert TC.batch_axes() == JC.batch_axes()
                assert TC.constrain(x, "data", None) is x
                for shape, axes in CONSTRAIN_CASES:
                    JC.constrain(jax.ShapeDtypeStruct(shape, jnp.float32),
                                 *axes)
                    assert TC.constraint_spec(shape, *axes) == caught[-1], \
                        (mesh, shape, axes)


def test_constrain_moves_a_sharded_value():
    """On CPU slots: columns split over 'model' gathered where the
    constraint drops the axis, cut where it adds one, the values whole."""
    mesh = TMESH.Mesh((2, 2), ("data", "model"), ("cpu",))
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    spec = ("data", None, "model")
    x = TP.Sharded(mesh, spec, tuple(full.shape),
                   TP.place(full, spec, mesh))
    with TC.use_mesh(mesh), record_collectives() as calls:
        y = TC.constrain(x, "data", "model", None)
    assert y.spec == ("data", "model", None)
    assert [c.op for c in calls] == ["all_gather"] * 2   # one per data row
    assert torch.equal(TP.gather(y.parts, y.spec, mesh), full)


def _placement_cases():
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              n_kv_heads=2)
    train = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           train=True)
    serve = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, train, serve


def test_place_shard_shapes_and_round_trip():
    """Every slot's shard has ``NamedSharding(mesh, spec).shard_shape``'s
    shape (reference and port), and ``gather(place(x))`` is ``x`` bitwise:
    f32 and bf16 parameters, AdamW state, a batch and a serving cache."""
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    cfg, train, serve = _placement_cases()
    shape = TCB.InputShape("t", 64, 8, "decode")
    rng = np.random.default_rng(0)
    for dims, axes in MESHES[2:]:
        mesh = TMESH.Mesh(dims, axes, ("cpu",))
        amesh = AbstractMesh(dims, axes)
        for params in (train, serve):
            specs = TP.param_specs(params, cfg, mesh)
            placed = TP.place(params, specs, mesh)
            named = dict(params.named_parameters())
            for s in mesh.slots:
                for n, p in placed[s].named_parameters():
                    want = NamedSharding(amesh, P(*specs[n])).shard_shape(
                        named[n].shape)
                    assert tuple(p.shape) == want == TP.NamedSharding(
                        mesh, specs[n]).shard_shape(named[n].shape)
                    assert p.dtype == named[n].dtype
                    assert p.requires_grad == named[n].requires_grad
            back = TP.gather(placed, specs, mesh)
            for (n, a), (_, b) in zip(back.named_parameters(),
                                      params.named_parameters()):
                assert torch.equal(a, b), n
        opt = TA.init(dict(train.named_parameters()))
        opt.mu["table"].normal_(generator=torch.Generator().manual_seed(1))
        ospecs = TP.opt_specs(opt, train, cfg, mesh)
        back = TP.gather(TP.place(opt, ospecs, mesh), ospecs, mesh)
        assert back.step == opt.step
        for n in opt.mu:
            assert torch.equal(back.mu[n], opt.mu[n])
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, 500, (8, 16)).astype(np.int32))}
        bspecs = TP.batch_specs(batch, cfg, shape, mesh)
        back = TP.gather(TP.place(batch, bspecs, mesh), bspecs, mesh)
        assert torch.equal(back["tokens"], batch["tokens"])
        cache = TST.cache_specs(cfg, shape)
        cache = {"pos": 3, "attn": {
            n: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
            .to(t.dtype) for n, t in cache["attn"].items()}}
        cspecs = TP.cache_specs(cache, cfg, shape, mesh)
        back = TP.gather(TP.place(cache, cspecs, mesh), cspecs, mesh)
        assert back["pos"] == 3
        for n, t in cache["attn"].items():
            assert torch.equal(back["attn"][n], t), n


def test_mesh_collectives_and_their_transposes():
    """On 2 x 2 CPU slots: all-gather, psum (slot order, bitwise on a
    rerun), reduce-scatter, each recorded once per group; under autograd
    each member gets its own result and the backward pass runs and
    records the transposed collective."""
    mesh = TMESH.Mesh((2, 2), ("data", "model"), ("cpu",))
    assert mesh.slots == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.coord((1, 1), ("data", "model")) == 3
    gen = torch.Generator().manual_seed(0)
    parts = {s: torch.randn(3, 4, generator=gen) for s in mesh.slots}
    with record_collectives() as calls:
        ag = mesh.all_gather(parts, "model", dim=1)
        ps = mesh.psum(parts, "data")
        rs = mesh.psum_scatter(parts, ("data", "model"), dim=1)
    assert [(c.op, c.group) for c in calls] == [
        ("all_gather", 0), ("all_gather", 2), ("psum", 0), ("psum", 1),
        ("psum_scatter", 0)]
    assert torch.equal(ag[(1, 0)], torch.cat([parts[(1, 0)],
                                              parts[(1, 1)]], 1))
    want = parts[(0, 1)] + parts[(1, 1)]
    assert torch.equal(ps[(0, 1)], want) and torch.equal(ps[(1, 1)], want)
    total = parts[(0, 0)] + parts[(0, 1)]
    total = total + parts[(1, 0)] + parts[(1, 1)]
    assert torch.equal(rs[(1, 0)], total[:, 2:3])
    assert torch.equal(mesh.psum(parts, "data")[(0, 0)], ps[(0, 0)])

    leaves = {s: p.clone().requires_grad_() for s, p in parts.items()}
    with record_collectives() as calls:
        out = mesh.psum(mesh.all_gather(leaves, "model", dim=1), "data")
        assert out[(0, 0)] is not out[(1, 0)]
        sum((i + 1) * out[s].sum() for i, s in enumerate(mesh.slots)
            ).backward()
    assert [c.op for c in calls] == ["all_gather"] * 2 + ["psum"] * 4 + [
        "psum_scatter"] * 2
    # d/d leaf: its model group's gathered copies feed both data rows'
    # psums; member weights (1 + 3) and (2 + 4) summed over the row
    for s, p in leaves.items():
        assert torch.equal(p.grad, torch.full_like(p, 10.0)), s
    assert len(mesh.groups("model")) == 2


def test_meshes_need_a_gpu():
    """No fall-back: the LLM meshes' default devices are the card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="GPU"):
        TMESH.make_debug_mesh()
    with pytest.raises(RuntimeError, match="GPU"):
        TMESH.make_production_mesh(multi_pod=True)
    mesh = TMESH.make_debug_mesh(2, 2, devices="cpu")
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

SMOKE_SHAPES = {"train": TCB.InputShape("t", 32, 8, "train"),
                "prefill": TCB.InputShape("p", 40, 8, "prefill"),
                "decode": TCB.InputShape("d", 40, 8, "decode")}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dims", [(4, 2), (2, 4)])
def test_plan_is_one_slot_of_the_cpu_run(kind, dims):
    """The meta plan of one slot (chatglm3's smoke model: Hkv 2, so on
    (2, 4) its K/V columns are gathered and its cache is split by head
    dim) launches each kernel 1/slots of the CPU run's launches, and
    records the collectives the CPU run records for group 0, kind by kind
    and part by part."""
    cfg = dataclasses.replace(TCB.get_config("chatglm3_6b").smoke_variant(),
                              dtype="float32")
    shape = SMOKE_SHAPES[kind]
    tcfg = TCB.TrainConfig(microbatches=2)
    plan = DRY.plan(cfg, shape, TMESH.Mesh(dims, ("data", "model")), kind,
                    tcfg)
    mesh = TMESH.Mesh(dims, ("data", "model"), ("cpu",))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (8, 1 if kind == "decode" else shape.seq_len)
    ).astype(np.int32))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            train=kind == "train")
    placed = TP.place(params, TP.param_specs(params, cfg, mesh), mesh)
    with pytest.MonkeyPatch.context() as mp:
        count = KernelCount(mp)
        if kind == "train":
            opt = TA.init(dict(params.named_parameters()))
            o = TP.place(opt, TP.opt_specs(opt, params, cfg, mesh), mesh)
            step = TST.make_sharded_train_step(cfg, tcfg, mesh)
            with record_collectives() as calls:
                step(placed, o, {"tokens": tok})
        elif kind == "prefill":
            step = TST.make_sharded_prefill_step(cfg, shape, mesh)
            with record_collectives() as calls:
                step(placed, {"tokens": tok})
        else:
            from repro_torch.models.sharded import ShardedLM
            cache = ShardedLM(cfg, mesh).cache_init(8, shape.seq_len)
            step = TST.make_sharded_serve_step(cfg, mesh)
            with record_collectives() as calls:
                step(placed, cache, tok)
    counted = {k: v // mesh.size for k, v in count.n.items() if v}
    assert all(v % mesh.size == 0 for v in count.n.values())
    assert plan["kernel_launches"] == counted
    mine = [(c.op, c.shapes, c.dtypes) for c in calls if c.group == 0]
    planned = [(c.op, c.shapes, c.dtypes) for c in plan["_calls"]]
    assert planned == mine and len(mine) > 0
    assert plan["collectives"] == DRY.ROOF.collective_bytes(
        [c for c in calls if c.group == 0])
    assert plan["memory"]["peak_bytes"] > 0


def test_dryrun_cli_writes_its_json(tmp_path, capsys):
    """qwen3-4b's decode_32k on the 16 x 16 mesh planned on meta (nothing
    allocated), rwkv6's decode_32k on both meshes, granite-moe's
    long_500k with the int8 cache (``--kv-quant``: its 8,192-slot window,
    a cheaper plan than decode_32k's 32,768 slots), whisper's long_500k
    skipped; records land under ``--out``, replaced by key."""
    out = tmp_path / "dry.json"
    assert DRY.main(["--arch", "qwen3_4b", "--shape", "decode_32k",
                     "--out", str(out)]) == 0
    assert DRY.main(["--arch", "rwkv6_7b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(out)]) == 0
    assert DRY.main(["--arch", "whisper_medium", "--shape", "long_500k",
                     "--out", str(out)]) == 0
    assert DRY.main(["--arch", "granite_moe_1b_a400m", "--shape",
                     "long_500k", "--out", str(out), "--kv-quant", "--tag",
                     "q"]) == 0
    recs = {(r["arch"], r["shape"], r["mesh"], r.get("tag", "")): r
            for r in json.loads(out.read_text())}
    assert len(recs) == 5
    ok = recs[("qwen3_4b", "decode_32k", "single", "")]
    assert ok["status"] == "ok" and ok["n_chips"] == 256
    assert ok["kernel_launches"] == {"repro_torch::decode_attention": 36}
    # qwen3's 8 KV heads on 16 model slots: the cache splits hd, so each
    # layer gathers its K and V over 'model'
    assert ok["collectives"]["n_all-gather"] >= 2 * 36
    assert ok["memory"]["fits_80gb"]
    for key in ("roofline", "model_flops_per_chip", "useful_flops_ratio",
                "tokens_per_step", "params", "active_params"):
        assert key in ok
    for m, n_chips in (("single", 256), ("multi", 512)):
        rec = recs[("rwkv6_7b", "decode_32k", m, "")]
        assert rec["status"] == "ok" and rec["n_chips"] == n_chips
        # no attention; its token shifts gathered over 'model' per layer
        assert rec["kernel_launches"] == {}
        assert rec["collectives"]["n_all-gather"] >= 2 * 32
    assert recs[("whisper_medium", "long_500k", "single", "")][
        "status"] == "skipped"
    q = recs[("granite_moe_1b_a400m", "long_500k", "single", "q")]
    assert q["status"] == "ok" and q["kv_quant"] and q["swa_variant"]
    # the int8 cache is read by the plain flash_attend: no kernel; its 8
    # KV heads on 16 model slots split hd, so its int8 K / V are gathered
    # over 'model' like bf16 ones
    assert q["kernel_launches"] == {}
    assert q["collectives"]["n_all-gather"] >= 2 * 24
    assert "-> " in capsys.readouterr().out


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_every_family_runs_sharded(arch):
    """Every config's smoke variant (f32) runs the three sharded steps on
    a (2, 2) CPU mesh: one train step of 4 x 32 tokens in 2 microbatches,
    whose loss is the port's unsharded loss within 1e-5 relative, a
    16-token prompt and one decode step, with finite logits of the
    vocabulary's width and every slot's cache at position 17 (a vlm
    prompt's image positions counted)."""
    from repro_torch.data.tokens import synthetic_token_batches
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32")
    mesh = TMESH.Mesh((2, 2), ("data", "model"), ("cpu",))
    batch = next(synthetic_token_batches(cfg, 4, 32, seed=0, device="cpu"))
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            train=True)
    rows = 2
    with torch.no_grad():
        want = sum(float(TST.loss_fn(params, cfg, {
            k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})[0])
            for i in range(2)) / 2
    opt = TA.init(dict(params.named_parameters()))
    p = TP.place(params, TP.param_specs(params, cfg, mesh), mesh)
    o = TP.place(opt, TP.opt_specs(opt, params, cfg, mesh), mesh)
    _, _, m = TST.make_sharded_train_step(
        cfg, TCB.TrainConfig(microbatches=2), mesh)(p, o, batch)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5)
    serve = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed = TP.place(serve, TP.param_specs(serve, cfg, mesh), mesh)
    prompt = {k: (v[:, :16] if k == "tokens" else v)
              for k, v in batch.items()}
    _, cache = TST.make_sharded_prefill_step(
        cfg, TCB.InputShape("p", 48, 4, "prefill"), mesh)(placed, prompt)
    logits, cache = TST.make_sharded_serve_step(cfg, mesh)(
        placed, cache, batch["tokens"][:, 16:17])
    assert tuple(logits.shape) == (4, 1, cfg.padded_vocab_size)
    assert bool(torch.isfinite(logits).all())
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    assert all(c["pos"] == n_img + 17 for c in cache.values())
