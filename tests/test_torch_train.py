"""The LLM training path of the port (loss, AdamW, schedules, the train
step with microbatches and remat, parameter and optimizer-state
conversion, the training CLI) against the JAX reference.

The models are the ``smoke_variant`` of Qwen3-4B (GQA, qk-norm, padded
vocabulary), Llama-3-8B, Granite-MoE (the loss adds 0.01 × ``moe_aux``;
the metrics carry ``moe_aux`` and ``moe_dropped``) and InternVL2 (8 image
positions before the text, which give no loss) in f32 with
``n_kv_heads=2``, B = 2, S = 512,
both packages starting from the reference's ``init_params`` (carried with
``convert.llm_params_from_numpy(..., train=True)``) and seeing the same
tokens. The reference runs its Pallas flash-attention forward and backward
kernels in interpret mode (``REPRO_PALLAS_ATTN=1``); the port runs the
plain versions of L1 and L2 (CPU tensors) through its autograd Function.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.data import tokens as TTOK
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedules as TS
from torch_helpers import assert_rel_close, llm_cfgs, np_tree

ARCHS = ["qwen3_4b", "llama3_8b", "granite_moe_1b_a400m", "internvl2_1b"]
B, S, N_STEPS = 2, 512, 3
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)

# Tolerances of the train-step comparison (3 steps, f32):
# - loss and grad norm: relative 1e-5. The same f32 arithmetic through two
#   layers, summed in other orders (XLA's dots and the Pallas kernels'
#   tiles against torch's matmuls and the plain whole-row softmax);
#   measured <= 3.6e-7 (loss) and 1.3e-6 (grad norm).
# - lr: relative 1e-6; the same f32 formula.
# - AdamW moments mu and nu: per tensor, 2e-4 of the tensor's largest
#   |value|. They follow the gradients, which go through the attention
#   backward; 2e-4 is the reference's own tolerance for its Pallas backward
#   against its oracle (``tests/test_flash_attention.py``). Measured:
#   <= 7.2e-5 (Llama wk, whose gradient sums many cancelling terms).
# - parameters: AdamW normalizes each element's update, lr · m̂ / √v̂, so an
#   element whose gradient is small against its rounding error moves
#   differently however closely the gradients agree as tensors; a gradient
#   at rounding level can even flip sign, 2 · lr per step. So: every
#   element within 2 · lr_sum (lr_sum: the lrs of the 3 steps), and all
#   but FLIP_FRACTION of the elements within 1e-6 + 1e-3 · lr_sum (their
#   updates agree to 0.1%). Such elements are counted, not hidden by a
#   looser bound. Measured: at most 84 of 1,246,464 (6.7e-5), mostly
#   embedding rows, the largest 0.34 · lr_sum.
MOMENT_RTOL = 2e-4
FLIP_FRACTION = 2e-4


def _batches(cfg, n, seed=0):
    """``n`` numpy batches of S positions: tokens and, for a vlm config,
    the bf16 image embeddings as f32, the text then S - n_image_tokens
    long (the reference's Pallas attention differentiates only whole
    tiles of 512 positions)."""
    seq = S - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    gen = TTOK.synthetic_token_batches(cfg, B, seq, seed=seed, device="cpu")
    return [{k: v.float().numpy() if k == "image_embeds" else v.numpy()
             for k, v in next(gen).items()} for _ in range(n)]


def _tokens(cfg, n, seed=0):
    return [b["tokens"] for b in _batches(cfg, n, seed)]


def _as(batch, conv):
    return {k: conv(v) for k, v in batch.items()}


class _ReferenceRun:
    """The reference's ``make_train_step`` for N_STEPS steps from its
    ``init_params(key(0))``, Pallas attention in interpret mode."""

    def __init__(self, arch, microbatches):
        import jax
        import jax.numpy as jnp
        from repro.configs.base import TrainConfig
        from repro.models import model as JM
        from repro.models import steps as JST
        from repro.optim import adamw as JA
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", n_kv_heads=2)
        self.tcfg = TCB.TrainConfig(microbatches=microbatches, **TRAIN_KW)
        jtcfg = TrainConfig(**dataclasses.asdict(self.tcfg))
        tree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree0 = np_tree(tree)
        self.batches = _batches(self.cfg, N_STEPS)
        opt = JA.init(tree)
        self.metrics = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS_ATTN", "1")
            step = jax.jit(JST.make_train_step(self.jcfg, jtcfg))
            for batch in self.batches:
                tree, opt, m = step(tree, opt, _as(batch, jnp.asarray))
                self.metrics.append({k: float(v) for k, v in m.items()})
        self.tree = np_tree(tree)
        self.opt = np_tree(opt._asdict())


_RUNS = {}


def reference_run(arch, microbatches):
    key = (arch, microbatches)
    if key not in _RUNS:
        _RUNS[key] = _ReferenceRun(arch, microbatches)
    return _RUNS[key]


def _leaves(tree):
    import jax
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _close_to_max(got, want, rtol, what=""):
    """|got - want| <= rtol · max |want|, elementwise."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=str(what))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    """Random logits with a padded vocabulary at −1e9 and a partial mask;
    also an all-zero mask (the denominator clamps at 1)."""
    import jax.numpy as jnp
    from repro.models.steps import cross_entropy as jce
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 7, 300)) * 3).astype(np.float32)
    logits[..., 256:] = -1e9
    labels = rng.integers(0, 256, (2, 7)).astype(np.int32)
    for mask in ((rng.random((2, 7)) > 0.3).astype(np.float32),
                 np.zeros((2, 7), np.float32)):
        got = TST.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
        want = jce(jnp.asarray(logits), jnp.asarray(labels),
                   jnp.asarray(mask))
        assert_rel_close(got.numpy(), np.asarray(want), 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    """The loss of the first batch from the same weights, f32, no remat
    (the reference's Pallas attention forward in interpret mode)."""
    import jax.numpy as jnp
    from repro.models.steps import loss_fn as jloss
    ref = reference_run(arch, 1)
    import jax
    from repro.models import model as JM
    tree = JM.init_params(jax.random.key(0), ref.jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS_ATTN", "1")
        want, wmetrics = jloss(tree, ref.jcfg,
                               _as(ref.batches[0], jnp.asarray), remat=False)
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu", train=True)
    got, metrics = TST.loss_fn(params, ref.cfg,
                               _as(ref.batches[0], torch.from_numpy),
                               remat=False)
    assert metrics["loss"] is got
    assert_rel_close(got.detach().numpy(), np.asarray(want), 1e-5)
    assert set(metrics) == set(wmetrics)
    for k in wmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(wmetrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------


def _opt_case(seed=1):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 2.0, 0.1)]
    return params, grads


def test_global_norm_and_clip_match_reference():
    import jax.numpy as jnp
    from repro.optim import adamw as JA
    _, grads = _opt_case()
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        assert_rel_close(TA.global_norm(tg.values()).numpy(),
                         np.asarray(JA.global_norm(jg)), 1e-6)
        want, wnorm = JA.clip_by_global_norm(jg, 1.0)
        got, norm = TA.clip_by_global_norm(tg, 1.0)
        assert_rel_close(norm.numpy(), np.asarray(wnorm), 1e-6)
        for k in g:
            assert_rel_close(got[k].numpy(), np.asarray(want[k]), 1e-6)


def test_adamw_apply_matches_reference():
    """Three updates from the same state with the same gradients and lr;
    the f32 arithmetic runs in the same order: 1e-6."""
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.optim import adamw as JA
    p0, grads = _opt_case()
    tcfg = TCB.TrainConfig()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = JA.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = TA.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        jp, jstate = JA.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                              jstate, TrainConfig(), jnp.float32(lr))
        tstate = TA.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          tstate, tcfg, torch.tensor(lr))
        assert tstate.step == int(jstate.step) == i + 1
        for k in p0:
            assert_rel_close(tp[k].numpy(), np.asarray(jp[k]), 1e-6)
            _close_to_max(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]),
                          1e-6)
            _close_to_max(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]),
                          1e-6)


@pytest.mark.parametrize("name", ["warmup_cosine", "constant", "rsqrt"])
def test_schedules_match_reference(name):
    """Every step of a 40-step schedule with a 7-step warmup, and steps
    past the end: the same f32 formula, 1e-6."""
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.optim import schedules as JS
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=40)
    jfn = getattr(JS, name)(TrainConfig(**kw))
    tfn = getattr(TS, name)(TCB.TrainConfig(**kw))
    for step in range(0, 45):
        got = tfn(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jfn(jnp.int32(step))),
                                   rtol=1e-6, atol=0, err_msg=str(step))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _port_run(ref, **tcfg_kw):
    params = CV.llm_params_from_numpy(ref.tree0, ref.cfg, "cpu", train=True)
    opt = TA.init(dict(params.named_parameters()))
    tcfg = dataclasses.replace(ref.tcfg, **tcfg_kw)
    step = TST.make_train_step(ref.cfg, tcfg)
    metrics = []
    for batch in ref.batches:
        params, opt, m = step(params, opt, _as(batch, torch.from_numpy))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, microbatches):
    ref = reference_run(arch, microbatches)
    params, opt, metrics = _port_run(ref)
    aux = {"moe_aux", "moe_dropped"} if ref.cfg.is_moe else set()
    for got, want in zip(metrics, ref.metrics):
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"} | aux
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)
        for k in aux:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert opt.step == int(ref.opt["step"]) == N_STEPS

    lr_sum = sum(m["lr"] for m in ref.metrics)
    got_tree = CV.llm_params_to_numpy(params)
    n_flip = n_all = 0
    for (path, want), (_, got) in zip(_leaves(ref.tree), _leaves(got_tree)):
        d = np.abs(got - want)
        out = d > 1e-6 + 1e-3 * lr_sum
        assert float(d.max()) <= 2 * lr_sum + 1e-6, path
        n_flip += int(out.sum())
        n_all += d.size
    assert n_flip <= FLIP_FRACTION * n_all, (n_flip, n_all)

    got_opt = CV.adamw_state_to_numpy(opt, params)
    for name in ("mu", "nu"):
        for (path, want), (_, got) in zip(_leaves(ref.opt[name]),
                                          _leaves(got_opt[name])):
            _close_to_max(got, want, MOMENT_RTOL, (name, path))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """``remat`` on (either policy) and off: the same forward arithmetic is
    recomputed, so the gradients are equal (1e-6 for summation-order
    noise; in practice bitwise)."""
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              dtype="float32", n_kv_heads=2)
    tokens = torch.from_numpy(_tokens(cfg, 1)[0][:, :96])
    grads = []
    for remat in (False, True):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                train=True)
        loss, _ = TST.loss_fn(params, cfg, {"tokens": tokens}, remat=remat,
                              remat_policy=policy)
        loss.backward()
        grads.append({n: p.grad.numpy() for n, p in
                      params.named_parameters()})
    for n in grads[0]:
        assert_rel_close(grads[1][n], grads[0][n], 1e-6)


def test_remat_policy_rejects_unknown_names():
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            train=True)
    with pytest.raises(ValueError):
        TM.forward(params, cfg, {"tokens": torch.zeros((1, 8),
                                                       dtype=torch.int32)},
                   remat_policy="offload")


# ---------------------------------------------------------------------------
# storage, conversion, CLI
# ---------------------------------------------------------------------------


def test_train_storage_is_f32_with_gradient():
    """``train=True`` keeps every parameter f32 with a gradient and draws
    the same numbers as the bf16 serving storage."""
    cfg = dataclasses.replace(TCB.get_config("qwen3_4b").smoke_variant(),
                              n_kv_heads=2)
    train = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           train=True)
    serve = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (n, p), (_, s) in zip(train.named_parameters(),
                              serve.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert not s.requires_grad
        assert torch.equal(p.to(s.dtype), s), n


def test_f32_params_and_adamw_state_round_trip():
    """The reference's f32 parameters and AdamW state (after one step)
    cross to the port and back unchanged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.models import model as JM
    from repro.optim import adamw as JA
    jcfg, cfg = llm_cfgs("qwen3_4b", n_kv_heads=2)
    tree = JM.init_params(jax.random.key(1), jcfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), tree)
    _, state = JA.apply(tree, grads, JA.init(tree), TrainConfig(), 1e-3)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.parameters())
    opt = CV.adamw_state_from_numpy(np_tree(state._asdict()), params)
    assert opt.step == 1
    assert list(opt.mu) == [n for n, _ in params.named_parameters()]
    back = {"params": CV.llm_params_to_numpy(params),
            **CV.adamw_state_to_numpy(opt, params)}
    want = {"params": np_tree(tree), **np_tree(state._asdict())}
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, w in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, w)


def test_train_cli_runs_on_cpu(capsys):
    from repro_torch.launch import train as TRAIN
    losses = TRAIN.main(["--arch", "llama3_8b", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "64", "--log-every", "1",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.count("step ") == 3 and "-> " in out
