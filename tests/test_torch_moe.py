"""The moe family's MLP (``repro_torch.models.moe``) against the JAX
reference's ``moe_apply``, and the index dispatch against the one-hot
einsums it replaces.

The same numpy parameters and inputs go to both packages, in f32. Every
branch of the grouping is covered: decode (S0 = 1, the batch in groups of
16, 8, 4, 2 or 1, dropless), a prompt of 1,024 tokens (two groups of
512) and one of 100 (one group per sequence); a capacity factor of 0.5
that drops tokens; duplicated router columns, so that ties keep more than
K experts (``moe_dropped`` then goes negative, as in the reference); and
Granite's routing (E = 32, K = 8) at a small width.

Tolerances:
- values: 1e-5 relative to the largest reference value. The same f32
  arithmetic, summed in other orders (XLA's einsums, over every one-hot
  slot, against torch's bmm and an index_add over the kept slots);
  measured <= 1e-6. The routing itself is the same: the kept set is
  decided on probabilities that differ by f32 rounding only, and the
  inputs are drawn so that no two are that close except by construction
  (the tie case, where both sides compute equal columns exactly).
- gradients of a scalar of (y, aux): 1e-4 relative to each gradient's
  largest entry, the limit the port's other autograd comparisons use;
  measured <= 5.2e-7.
- the bf16 index path against the one-hot einsums in torch: 2^-7 of the
  largest value. Both round the same f32 sums to bf16 once, summed in
  another order, so an output may land one bf16 step away.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as TCB
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from torch_helpers import assert_rel_close

RTOL, GRAD_RTOL = 1e-5, 1e-4


def _cfgs(arch="granite_moe_1b_a400m", **kw):
    """Reference and port configs: the smoke variant (E = 4, K = 2) at a
    small width, f32, with ``kw`` replaced."""
    from repro.configs.base import get_config
    kw = dict(dict(d_model=32, d_ff=48, dtype="float32"), **kw)
    jc = dataclasses.replace(get_config(arch).smoke_variant(), **kw)
    tc = dataclasses.replace(TCB.get_config(arch).smoke_variant(), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(cfg, seed=0, tie=0):
    """numpy ``moe_init``-shaped parameters; ``tie`` > 1 copies router
    column 0 into columns 1 … tie - 1."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, E)) * 0.5,
         "w_gate": rng.normal(size=(E, d, f)) / d ** 0.5,
         "w_up": rng.normal(size=(E, d, f)) / d ** 0.5,
         "w_down": rng.normal(size=(E, f, d)) / f ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    for c in range(1, tie):
        p["router"][:, c] = p["router"][:, 0]
    return p


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _reference(p, jcfg, x):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    fn = jax.jit(lambda jp, jx: JMOE.moe_apply(jp, jcfg, jx))
    y, aux = fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


def _port(p, cfg, x):
    y, aux = TMOE.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            cfg, torch.from_numpy(x))
    return y.numpy(), {k: float(v) for k, v in aux.items()}


def _assert_same(p, jcfg, cfg, x):
    want, waux = _reference(p, jcfg, x)
    got, gaux = _port(p, cfg, x)
    assert got.shape == x.shape
    assert_rel_close(got, want, RTOL)
    assert set(gaux) == set(waux) == {"moe_aux", "moe_dropped"}
    for k in waux:
        np.testing.assert_allclose(gaux[k], waux[k], rtol=RTOL, atol=RTOL,
                                   err_msg=k)
    return gaux


@pytest.mark.parametrize("B,S0", [(1, 1), (2, 1), (6, 1), (8, 1), (16, 1),
                                  (2, 1024), (3, 100)],
                         ids=["decode-b1", "decode-b2", "decode-b6",
                              "decode-b8", "decode-b16", "groups-512",
                              "one-group"])
def test_moe_apply_matches_reference(B, S0):
    jcfg, cfg = _cfgs()
    G, S, C = TMOE.groups_and_capacity(cfg, B, S0)
    assert G * S == B * S0
    if S0 == 1:
        assert S == C and B % S == 0     # dropless groups of the batch
    elif S0 == 1024:
        assert (G, S) == (2 * B, 512)
    else:
        assert (G, S) == (B, S0)
    aux = _assert_same(_params(cfg), jcfg, cfg, _x(B, S0, cfg.d_model))
    if S0 == 1:
        assert aux["moe_dropped"] == 0.0


def test_drops_match_reference():
    """cf = 0.5: C = 25 slots per expert for 100 tokens x K = 2 over 4
    experts, so tokens overflow and are dropped; the same ones."""
    jcfg, cfg = _cfgs(moe_capacity_factor=0.5)
    assert TMOE.groups_and_capacity(cfg, 2, 100)[2] == 25
    aux = _assert_same(_params(cfg), jcfg, cfg, _x(2, 100, cfg.d_model))
    assert aux["moe_dropped"] > 0.05


def test_ties_keep_more_than_k_experts():
    """Router columns 0-2 equal: whenever they reach the K-th largest
    probability all three are kept (K = 2), in both packages."""
    jcfg, cfg = _cfgs(moe_capacity_factor=10.0)
    p = _params(cfg, tie=3)
    x = _x(2, 100, cfg.d_model)
    _, mask, weights = TMOE.route(torch.from_numpy(p["router"]),
                                  torch.from_numpy(x), cfg.experts_per_token)
    over = int((mask.sum(-1) > cfg.experts_per_token).sum())
    assert over > 0
    torch.testing.assert_close(weights.sum(-1), torch.ones(2, 100))
    aux = _assert_same(p, jcfg, cfg, x)
    assert aux["moe_dropped"] < 0     # kept > K counts against the drop


def test_granite_routing_matches_reference():
    """Granite's router: 32 experts, 8 per token, at d = 64; one group per
    sequence and, for decode, dropless groups of the batch."""
    jcfg, cfg = _cfgs(d_model=64, d_ff=32, n_experts=32, experts_per_token=8)
    p = _params(cfg, seed=2)
    for B, S0 in ((2, 200), (8, 1)):
        _assert_same(p, jcfg, cfg, _x(B, S0, 64, seed=3))


@pytest.mark.parametrize("B,S0,cf", [(2, 100, 0.5), (4, 1, 1.25),
                                     (1, 1024, 1.25)],
                         ids=["drops", "decode", "groups-512"])
def test_gradients_match_reference(B, S0, cf):
    """d/d(params, x) of sum(y · r) + 0.5 · moe_aux against
    ``jax.grad`` of the same scalar."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    jcfg, cfg = _cfgs(moe_capacity_factor=cf)
    p = _params(cfg)
    x = _x(B, S0, cfg.d_model)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jscalar(jp, jx):
        y, aux = JMOE.moe_apply(jp, jcfg, jx)
        return jnp.sum(y * r) + 0.5 * aux["moe_aux"]

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_p, want_x = jax.jit(jax.grad(jscalar, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMOE.moe_apply(tp, cfg, tx)
    ((y * torch.from_numpy(r)).sum() + 0.5 * aux["moe_aux"]).backward()
    for k in p:
        want = np.asarray(want_p[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=k)
    want = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


def _one_hot_oracle(p, cfg, x):
    """The reference's one-hot (G, S, E, C) dispatch and combine einsums,
    in torch, on the port's routing."""
    B, S0, d = x.shape
    G, S, C = TMOE.groups_and_capacity(cfg, B, S0)
    xg = x.reshape(G, S, d)
    _, mask, weights = TMOE.route(p["router"], xg, cfg.experts_per_token)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (pos < C)
    slot = torch.nn.functional.one_hot(
        torch.where(keep, pos, 0).long(), C).to(x.dtype)
    dispatch = slot * keep[..., None].to(x.dtype)
    combine = dispatch * weights[..., None].to(x.dtype)
    ein = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = (torch.nn.functional.silu(
        torch.einsum("egcd,edf->egcf", ein, p["w_gate"]).float()).to(x.dtype)
        * torch.einsum("egcd,edf->egcf", ein, p["w_up"]))
    out = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    return torch.einsum("gsec,egcd->gsd", combine.float(),
                        out.float()).to(x.dtype).reshape(B, S0, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_dispatch_equals_one_hot_einsums(dtype):
    """Drops and ties at once (cf = 0.5, three equal router columns)."""
    _, cfg = _cfgs(moe_capacity_factor=0.5)
    p = {k: torch.from_numpy(v).to(dtype)
         for k, v in _params(cfg, tie=3).items()}
    x = torch.from_numpy(_x(2, 100, cfg.d_model)).to(dtype)
    got, _ = TMOE.moe_apply(p, cfg, x)
    want = _one_hot_oracle(p, cfg, x)
    assert got.dtype == dtype
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert_rel_close(got.float().numpy(), want.float().numpy(), rtol)


def test_expert_init_scales_by_their_fan_in():
    """``init_params`` draws a stacked (E, d_in, d_out) expert tensor with
    scale 1/sqrt(d_in), as the reference's per-expert ``_dense_init`` does
    (not 1/sqrt(E)), and the router with 0.02."""
    cfg = TCB.get_config("granite_moe_1b_a400m").smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            train=True)
    mlp = params.blocks[0].mlp
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert mlp.w_gate.shape == (E, d, f) and mlp.w_down.shape == (E, f, d)
    for w, want in ((mlp.w_gate, d ** -0.5), (mlp.w_up, d ** -0.5),
                    (mlp.w_down, f ** -0.5), (mlp.router, 0.02)):
        assert abs(float(w.detach().std()) / want - 1.0) < 0.05
