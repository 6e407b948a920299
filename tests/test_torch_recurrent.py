"""The recurrent serving paths of the port (hybrid: zamba2, Mamba2 layers
with a weight-shared attention block; ssm: rwkv6) against the JAX
reference.

Parameters come from the reference's ``init_params`` and are carried
across with ``convert.llm_params_from_numpy``; tokens are numpy-seeded.
The models are ``smoke_variant``s in f32: zamba2's (2 layers, a shared
block after each), zamba2's with ``n_layers=5, shared_attn_period=2``
(two full groups and a remainder layer: 3 ring layers allocated, 2 used)
and rwkv6's. One prompt of 200 tokens into a ``seq_len`` of 64, so the
hybrid ring (64 slots, the shared block's window) is shorter than the
prompt, then 4 decode steps. The reference runs once with its plain
chunked scans and attention, and once with its Pallas kernels in
interpret mode (``REPRO_PALLAS_SSD`` / ``REPRO_PALLAS_WKV``, and
``REPRO_PALLAS_ATTN`` / ``REPRO_PALLAS_DECODE_ATTN`` for the shared
block). The port runs its kernels' plain versions (CPU tensors).

Tolerances, relative to the largest reference value (``assert_rel_close``):
- f32: 1e-4, as for the dense family. Both sides run the same f32
  arithmetic; sums are taken in other orders (XLA's dots and scans, the
  Pallas kernels, torch's matmuls and einsums).
- bf16 (``test_bf16_steps_match_reference``): 5e-2 of the largest logit,
  as for the dense family: every matmul output is rounded to bf16 by both
  sides after sums in other orders, so single roundings differ by one
  bf16 step.
- the card against the CPU, both the port in f32
  (``test_cuda_serve_matches_cpu``): 1e-3. Two independent f32 paths
  (cuBLAS against the CPU's BLAS, the kernels' 64-step chunks against the
  plain versions' 128-step chunks) through up to 5 random layers and 200
  recurrent steps; measured on the H100: all but one of 5,120 logits
  within 1e-4, the worst 4.7e-4 off (zamba2 with a remainder group).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert as CV
from repro_torch.configs import base as TCB
from repro_torch.data import tokens as TTOK
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import steps as TST
from torch_helpers import assert_rel_close, cuda_device  # noqa: F401
from torch_helpers import llm_cfgs, np_tree

# id -> (arch, config fields replaced in the smoke variant)
VARIANTS = {"zamba2": ("zamba2_7b", {}),
            "zamba2-remainder": ("zamba2_7b", dict(n_layers=5,
                                                    shared_attn_period=2)),
            "rwkv6": ("rwkv6_7b", {})}
B, S_PROMPT, SEQ_LEN, N_DECODE = 2, 200, 64, 4
RTOL = 1e-4
CUDA_RTOL = 1e-3
PALLAS_ENV = ("REPRO_PALLAS_SSD", "REPRO_PALLAS_WKV", "REPRO_PALLAS_ATTN",
              "REPRO_PALLAS_DECODE_ATTN")


def _tokens(cfg, seq, seed=0):
    return next(TTOK.synthetic_token_batches(cfg, B, seq, seed=seed,
                                             device="cpu"))["tokens"].numpy()


class _Reference:
    """One reference serve run per (variant, pallas): params, forward,
    prefill and decode steps."""

    def __init__(self, variant, pallas):
        import jax
        import jax.numpy as jnp
        from repro.models import model as JM
        from repro.models.kvcache import serve_cache_init
        arch, kw = VARIANTS[variant]
        self.jcfg, self.cfg = llm_cfgs(arch, dtype="float32", **kw)
        jtree = JM.init_params(jax.random.key(0), self.jcfg)
        self.tree = np_tree(jtree)
        self.tokens = _tokens(self.cfg, S_PROMPT + N_DECODE)
        toks = jnp.asarray(self.tokens)
        from repro.kernels.ssd_chunk import ops as JSSD
        from repro.kernels.wkv6 import ops as JWKV
        traced = []

        def spy(fn):
            def wrapped(*a, **k):
                traced.append(fn.__name__)
                return fn(*a, **k)
            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            for name in PALLAS_ENV:
                if pallas:
                    mp.setenv(name, "1")
                else:
                    mp.delenv(name, raising=False)
            mp.setattr(JSSD, "ssd_chunk_padded", spy(JSSD.ssd_chunk_padded))
            mp.setattr(JWKV, "wkv_chunk_padded", spy(JWKV.wkv_chunk_padded))
            self.forward = np.asarray(JM.forward(
                jtree, self.jcfg, {"tokens": toks}, remat=False)[0])
            cache = serve_cache_init(self.jcfg, B, SEQ_LEN, dtype=jnp.float32)
            # a fresh function per run, so that no trace of the other
            # setting of the switches is reused
            logits, cache = jax.jit(
                lambda p, b, c: JM.prefill(p, self.jcfg, b, c))(
                jtree, {"tokens": toks[:, :S_PROMPT]}, cache)
            self.prefill_logits = np.asarray(logits)
            self.prefill_cache = np_tree(cache)
            step = jax.jit(lambda p, c, t: JM.decode_step(p, self.jcfg, c, t))
            self.decode_logits = []
            for i in range(S_PROMPT, S_PROMPT + N_DECODE):
                logits, cache = step(jtree, cache, toks[:, i:i + 1])
                self.decode_logits.append(np.asarray(logits))
            self.decode_cache = np_tree(cache)
        # the switch reaches the Pallas kernel (traced in forward and
        # prefill), or nothing traces it
        assert bool(traced) == pallas, traced

    def port(self):
        params = CV.llm_params_from_numpy(self.tree, self.cfg, "cpu")
        cache = TKV.serve_cache_init(self.cfg, B, SEQ_LEN,
                                     dtype=torch.float32, device="cpu")
        return params, cache


_REFS = {}


def reference(variant, pallas):
    key = (variant, pallas)
    if key not in _REFS:
        _REFS[key] = _Reference(variant, pallas)
    return _REFS[key]


def _assert_cache(cfg, cache, want, rtol=RTOL):
    """The port's cache against the reference's: every recurrent state,
    and the ring layers the reference keeps (the port allocates one more
    when a remainder group has no shared block, and leaves it empty)."""
    assert cache["pos"] == int(want["pos"])
    if cfg.family == "ssm":
        for n in ("wkv", "shift_att", "shift_ffn"):
            assert_rel_close(cache[n].float().numpy(), want[n], rtol)
        return
    for n, t in cache["mamba"].items():
        assert_rel_close(t.float().numpy(), want["mamba"][n], rtol)
    n_used = cfg.n_layers // cfg.shared_attn_period
    assert want["attn"]["k"].shape[0] == n_used
    np.testing.assert_array_equal(cache["attn"]["kv_pos"][:n_used].numpy(),
                                  want["attn"]["kv_pos"])
    for n in ("k", "v"):
        assert_rel_close(cache["attn"][n][:n_used].float().numpy(),
                         want["attn"][n], rtol)
    assert bool((cache["attn"]["kv_pos"][n_used:] == -1).all())
    assert not bool(cache["attn"]["k"][n_used:].any())


CASES = [(v, p) for v in VARIANTS for p in (False, True)]
IDS = [f"{v}-{'pallas' if p else 'plain'}" for v, p in CASES]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    from repro.configs.base import get_config
    for arch in TCB.RECURRENT_IDS:
        jc, tc = get_config(arch), TCB.get_config(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert (dataclasses.asdict(tc.smoke_variant())
                == dataclasses.asdict(jc.smoke_variant()))
    assert TCB.get_config("zamba2-7b").resolved_head_dim == 112


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference (f32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,pallas", CASES, ids=IDS)
def test_forward_matches_reference(variant, pallas):
    ref = reference(variant, pallas)
    params, _ = ref.port()
    logits, aux = TM.forward(params, ref.cfg,
                             {"tokens": torch.from_numpy(ref.tokens)})
    assert aux == {} and logits.dtype == torch.float32
    assert_rel_close(logits.numpy(), ref.forward, RTOL)


@pytest.mark.parametrize("variant,pallas", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(variant, pallas):
    ref = reference(variant, pallas)
    params, cache = ref.port()
    toks = torch.from_numpy(ref.tokens)
    logits, cache = TM.prefill(params, ref.cfg,
                               {"tokens": toks[:, :S_PROMPT]}, cache)
    assert logits.shape == (B, 1, ref.cfg.padded_vocab_size)
    assert_rel_close(logits.numpy(), ref.prefill_logits, RTOL)
    _assert_cache(ref.cfg, cache, ref.prefill_cache)
    for i, want in enumerate(ref.decode_logits):
        logits, cache = TM.decode_step(params, ref.cfg, cache,
                                       toks[:, S_PROMPT + i:S_PROMPT + i + 1])
        assert_rel_close(logits.numpy(), want, RTOL)
    _assert_cache(ref.cfg, cache, ref.decode_cache)
    if ref.cfg.family == "ssm":
        # no window: teacher-forced decode equals the full forward
        assert_rel_close(logits[:, 0].numpy(), ref.forward[:, -1], RTOL)


# ---------------------------------------------------------------------------
# the port's own consistency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_matches_stepwise_decode(variant):
    """Counterpart of tests/test_prefill_decode.py, with an 80-token prompt
    past the 64-slot ring: feeding the prompt one token at a time through
    decode_step gives prefill's last logits and its state."""
    arch, kw = VARIANTS[variant]
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32", **kw)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 80, seed=1))
    cache_a = TKV.serve_cache_init(cfg, B, SEQ_LEN, dtype=torch.float32,
                                   device="cpu")
    logits_a, cache_a = TM.prefill(params, cfg, {"tokens": toks}, cache_a)
    cache_b = TKV.serve_cache_init(cfg, B, SEQ_LEN, dtype=torch.float32,
                                   device="cpu")
    for i in range(80):
        logits_b, cache_b = TM.decode_step(params, cfg, cache_b,
                                           toks[:, i:i + 1])
    assert_rel_close(logits_a.numpy(), logits_b.numpy(), 2e-4)
    assert cache_a["pos"] == cache_b["pos"] == 80
    flat_a = {k: v for k, v in _flat(cache_a)}
    for key, t in _flat(cache_b):
        assert_rel_close(flat_a[key].float().numpy(), t.float().numpy(),
                         2e-4)


def _flat(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", TCB.RECURRENT_IDS)
def test_serving_state_size_is_independent_of_seq_len(arch):
    """Counterpart of tests/test_long_context.py's recurrent case: the
    state for a 512k-token context has the shapes of the state for 4,096
    tokens; only the hybrid ring is capped (at 4,096 slots)."""
    cfg = TCB.get_config(arch).smoke_variant()
    c1 = dict(_flat(TKV.serve_cache_init(cfg, 2, 4096, device="cpu")))
    c2 = dict(_flat(TKV.serve_cache_init(cfg, 2, 1 << 19, device="cpu")))
    assert c1.keys() == c2.keys()
    for key, t in c2.items():
        assert t.shape == c1[key].shape, key
        if key.startswith("attn/"):
            assert t.shape[2 if t.dim() > 2 else 1] == 4096, key


def test_other_families_still_raise():
    cfg = dataclasses.replace(TCB.get_config("rwkv6_7b").smoke_variant(),
                              family="speech-to-speech")
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError):
        TKV.serve_cache_init(cfg, 1, 8, device="cpu")
    # the recurrent families train: f32 master parameters with gradient
    params = TM.init_params(TCB.get_config("zamba2_7b").smoke_variant(),
                            torch.Generator(), "cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.parameters())


@pytest.mark.parametrize("variant", ["zamba2-remainder", "rwkv6"])
def test_bf16_steps_match_reference(variant):
    """The serving steps as a user calls them: bf16 weights and
    activations, the default bf16 cache made by ``make_prefill_step``,
    then ``make_serve_step``; against the reference's steps (plain
    scans)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import InputShape
    from repro.models import model as JM
    from repro.models import steps as JST
    arch, kw = VARIANTS[variant]
    jcfg, cfg = llm_cfgs(arch, **kw)
    tree = JM.init_params(jax.random.key(0), jcfg)
    params = CV.llm_params_from_numpy(np_tree(tree), cfg, "cpu")
    toks = _tokens(cfg, 42)
    jt = jnp.asarray(toks)
    want, jcache = jax.jit(JST.make_prefill_step(
        jcfg, InputShape("serve", SEQ_LEN, B, "prefill")))(
        tree, {"tokens": jt[:, :40]})
    serve = jax.jit(JST.make_serve_step(jcfg))
    want_steps = []
    for i in (40, 41):
        lg, jcache = serve(tree, jcache, jt[:, i:i + 1])
        want_steps.append(np.asarray(lg))
    t = torch.from_numpy(toks)
    got, cache = TST.make_prefill_step(
        cfg, TCB.InputShape("serve", SEQ_LEN, B, "prefill"))(
        params, {"tokens": t[:, :40]})
    assert_rel_close(got.numpy(), np.asarray(want), 5e-2)
    serve_t = TST.make_serve_step(cfg)
    for i, w in zip((40, 41), want_steps):
        got, cache = serve_t(params, cache, t[:, i:i + 1])
        assert_rel_close(got.numpy(), w, 5e-2)
    assert cache["pos"] == 42


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_serve_matches_cpu(variant, cuda_device):
    """The serve path on the card (kernels L4 or L5, and L1/L3 for the
    shared block) against the same f32 model on the CPU (plain versions),
    with exact launch counts."""
    from repro_torch.kernels.decode_attention import ops as L3
    from repro_torch.kernels.flash_attention import ops as L1
    from repro_torch.kernels.ssd_chunk import ops as L4
    from repro_torch.kernels.wkv6 import ops as L5
    arch, kw = VARIANTS[variant]
    cfg = dataclasses.replace(TCB.get_config(arch).smoke_variant(),
                              dtype="float32", **kw)
    toks = torch.from_numpy(_tokens(cfg, S_PROMPT + N_DECODE, seed=2))
    outs = {}
    for dev in ("cpu", cuda_device):
        params = TM.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
        params = params.to(dev)
        t = toks.to(dev)
        counts = [f.launches for f in (L1.flash_attention,
                                       L3.decode_attention, L4.ssd_scan,
                                       L5.wkv6)]
        logits, cache = TST.make_prefill_step(
            cfg, TCB.InputShape("serve", SEQ_LEN, B, "prefill"))(
            params, {"tokens": t[:, :S_PROMPT]})
        seq = [logits]
        for i in range(S_PROMPT, S_PROMPT + N_DECODE):
            logits, cache = TST.make_serve_step(cfg)(params, cache,
                                                     t[:, i:i + 1])
            seq.append(logits)
        outs[str(dev)] = torch.cat(seq, dim=1).cpu().numpy()
        counts = [f.launches - c for f, c in zip(
            (L1.flash_attention, L3.decode_attention, L4.ssd_scan, L5.wkv6),
            counts)]
    n_attn = (cfg.n_layers // cfg.shared_attn_period
              if cfg.family == "hybrid" else 0)
    assert counts == [n_attn, n_attn * N_DECODE,
                      cfg.n_layers if cfg.family == "hybrid" else 0,
                      cfg.n_layers if cfg.family == "ssm" else 0]
    assert_rel_close(outs[str(cuda_device)], outs["cpu"], CUDA_RTOL)
