"""Per-architecture smoke tests of the port, the counterpart of
``tests/test_arch_smoke.py``.

Each architecture of the zoo runs as its ``smoke_variant`` (2 layers,
d_model <= 256, <= 4 experts; whisper 2 + 2 layers over 16 stub frames)
on the CPU in its own dtype (bf16), at B = 2, S = 64:
- one forward pass: finite f32 logits of shape (B, S, vocab);
- one AdamW train step with remat: a finite positive loss, some parameter
  moved, every parameter finite, ``step == 1``;
- two decode steps from a fresh cache: finite logits, ``pos`` advancing.
Inputs are made with numpy from a seed. The hybrid and ssm families'
first-step losses are also held against the reference's ``loss_fn`` from
the same weights, in f32 (1e-5 relative, as the train tests hold a loss).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from repro_torch.optim import adamw as TA
from torch_helpers import llm_cfgs, np_tree
from torch_helpers import one_torch_thread  # noqa: F401 (fixture)

B, S = 2, 64
TCFG = TCB.TrainConfig(total_steps=10, warmup_steps=2, remat=True)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _batch(cfg, seed=1):
    """numpy tokens (a vlm batch: S − n_image_tokens of them after its
    image embeddings) and a frontend stub's embeddings, as torch
    tensors; the embeddings in bf16, as the reference's test draws
    them."""
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, n_text)).astype(np.int32))}
    stub = {"vlm": ("image_embeds", cfg.n_image_tokens),
            "audio": ("audio_embeds", cfg.n_audio_frames)}.get(cfg.family)
    if stub:
        emb = rng.normal(size=(B, stub[1], cfg.d_model)).astype(np.float32)
        batch[stub[0]] = torch.from_numpy(emb).to(torch.bfloat16)
    return batch


def _model(arch):
    cfg = TCB.get_config(arch).smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            train=True)
    return cfg, params


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_forward_shapes_and_finite(arch):
    cfg, params = _model(arch)
    with torch.no_grad():
        logits, _ = TM.forward(params, cfg, _batch(cfg), remat=False)
    assert cfg.padded_vocab_size == cfg.vocab_size
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), arch


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_train_step(arch):
    cfg, params = _model(arch)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = TA.init(dict(params.named_parameters()))
    params, opt, metrics = TST.make_train_step(cfg, TCFG)(params, opt,
                                                          _batch(cfg))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0.0, arch
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in params.named_parameters())
    assert moved > 0.0, f"{arch}: no parameter moved"
    assert all(bool(torch.isfinite(p).all()) for p in params.parameters())
    assert opt.step == 1


@pytest.mark.parametrize("arch", TCB.ARCH_IDS)
def test_decode_step(arch):
    cfg, params = _model(arch)
    cache = TKV.serve_cache_init(cfg, B, 128, device="cpu")
    step = TST.make_serve_step(cfg)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    logits, cache = step(params, cache, tok)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch
    assert int(cache["pos"]) == 1
    logits2, cache = step(params, cache, tok)
    assert int(cache["pos"]) == 2
    assert bool(torch.isfinite(logits2).all())


@pytest.mark.parametrize("arch", TCB.RECURRENT_IDS)
def test_recurrent_first_step_loss_matches_reference(arch):
    """The first train step's loss (remat, the training scans) from the
    reference's ``init_params`` against its ``loss_fn``, f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models import steps as JST
    jcfg, cfg = llm_cfgs(arch, dtype="float32")
    tree = JM.init_params(jax.random.key(0), jcfg)
    batch = _batch(cfg)
    want, _ = jax.jit(lambda t, b: JST.loss_fn(t, jcfg, b))(
        tree, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu", train=True)
    opt = TA.init(dict(params.named_parameters()))
    _, _, metrics = TST.make_train_step(cfg, TCFG)(params, opt, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=1e-5)
