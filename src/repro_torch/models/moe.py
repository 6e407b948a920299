"""Mixture-of-experts MLP of the moe family (port of
``repro/models/moe.py``): a softmax router over E experts, top-K routing,
capacity per dispatch group, SwiGLU experts, a Switch-style load-balance
aux loss.

The routed function is the reference's, term for term:
- the router logits are formed in x's dtype, then softmaxed in f32; an
  expert is kept where its probability is >= the token's K-th largest,
  so a tie keeps more than K experts (``route``);
- tokens are dispatched in groups with a capacity of C slots per expert
  and group (``groups_and_capacity``): one token's worth of the batch at a
  time in decode (dropless: C = the group size), 512-token groups for a
  long prompt whose length is a multiple of 512, else one group per
  sequence. A token takes slot ``pos`` of its expert, its rank among the
  group's tokens routed there; it is dropped where ``pos >= C`` and then
  passes only through the residual;
- the experts' SiLU is taken in f32 and cast back; the combine weights
  are the normalized kept probabilities, cast to x's dtype.

Where the reference contracts one-hot (G, S, E, C) dispatch and combine
tensors with einsums, the port moves rows by index: each kept (token,
expert) pair's slot is scattered into a slot -> token map, the experts'
input (E, G·C, d) is gathered from it with ``index_select`` (empty slots
read a zero row, as the one-hot contraction gives them zeros), and the
weighted outputs are added back per token with ``index_add`` in f32 and
cast once, as the einsum accumulates (the gather's backward likewise sums
a token's gradients in f32: ``_GatherRows``). On the card ``index_add``
adds by atomics, so the order of a token's K terms, and with it the last
f32 bit, can change from run to run. The kept set, C and the drops are
the reference's, so the result is the same function; at Granite's serve
prefill (8 x 4,000 tokens, one group per sequence, C = 1,250) the
one-hot form would take 1.28e9 entries per tensor and 5.2 TFLOP per layer
against the experts' 1.0. The index maps are built without a host sync.
The expert products stay ``torch.bmm``, as the reference leaves its
einsums to XLA: there is no Pallas kernel in this layer.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig

GROUP_SIZE = 512  # tokens per dispatch group of a long prompt
PARAM_NAMES = ("router", "w_gate", "w_up", "w_down")


def groups_and_capacity(cfg: ArchConfig, B: int,
                        S0: int) -> Tuple[int, int, int]:
    """(G, S, C): the (B, S0) tokens as G dispatch groups of S tokens,
    each expert taking at most C tokens of a group (the reference's
    ``moe_apply`` at ``cfg.moe_capacity_factor``, with Python's
    ``int(x + 0.5)`` rounding)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    cf = cfg.moe_capacity_factor
    if S0 == 1:
        # decode: groups of the batch, dropless (C = the group's size)
        gs = next((c for c in (16, 8, 4, 2) if B % c == 0), 1)
        G, S, C = B // gs, gs, gs
    elif S0 % GROUP_SIZE == 0 and S0 > GROUP_SIZE:
        G, S = B * (S0 // GROUP_SIZE), GROUP_SIZE
        C = max(1, int(GROUP_SIZE * K * cf / E + 0.5))
    else:
        G, S = B, S0
        C = max(1, int(S0 * K * cf / E + 0.5))
    return G, S, min(C, S * K)


def route(router, x, k: int):
    """x: (..., d) -> (probs f32, mask, weights f32), each (..., E): the
    softmax of the router logits (formed in x's dtype), the experts whose
    probability is >= the K-th largest (ties keep them all), and the kept
    probabilities normalized to sum to 1."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    mask = probs >= thresh
    w = torch.where(mask, probs, torch.zeros_like(probs))
    return probs, mask, w / w.sum(-1, keepdim=True).clamp_min(1e-9)


def capacity_keep(mask, C: int):
    """mask (G, S, E) -> (pos, keep): each routed token's slot in its
    expert's buffer of its group (its rank among the group's tokens routed
    there) and whether the slot is below the capacity C."""
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    return pos, mask & (pos < C)


def moe_apply(params: Mapping[str, torch.Tensor], cfg: ArchConfig, x
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S0, d) -> (y (B, S0, d), {"moe_aux", "moe_dropped"}).
    ``params``: ``router`` (d, E), ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d). Differentiable."""
    B, S0, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    G, S, C = groups_and_capacity(cfg, B, S0)
    dev, dtype = x.device, x.dtype
    xg = x.reshape(G, S, d)
    probs, mask, weights = route(params["router"], xg, K)   # (G, S, E)

    pos, keep = capacity_keep(mask, C)

    # the (token, expert) pair in each of the E·G·C slots; pairs not kept
    # go to one extra slot that nothing reads, empty slots keep T·E, which
    # stands for a zero token row and a zero weight
    T, n_slots = G * S, E * G * C
    slot = (torch.arange(E, device=dev) * (G * C)
            + torch.arange(G, device=dev)[:, None, None] * C + pos)
    slot = torch.where(keep, slot, n_slots)
    pair = torch.full((n_slots + 1,), T * E, dtype=torch.long, device=dev)
    pair.scatter_(0, slot.reshape(-1),
                  torch.arange(T * E, device=dev))
    pair = pair[:n_slots]
    token = pair // E                                        # T = empty

    rows = torch.cat([x.reshape(T, d), x.new_zeros((1, d))])
    expert_in = _GatherRows.apply(rows, token).view(E, G * C, d)
    h_g = torch.bmm(expert_in, params["w_gate"].to(dtype))
    h_u = torch.bmm(expert_in, params["w_up"].to(dtype))
    h = F.silu(h_g.float()).to(dtype) * h_u
    expert_out = torch.bmm(h, params["w_down"].to(dtype))  # (E, G·C, d)

    w_slot = torch.cat([weights.to(dtype).reshape(-1),
                        weights.new_zeros(1, dtype=dtype)]).index_select(
                            0, pair)
    contrib = expert_out.reshape(n_slots, d).float() * w_slot.float()[:, None]
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=dev).index_add(
        0, token, contrib)[:T].to(dtype)

    # Switch-style load-balance aux loss
    frac_tokens = mask.float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_probs).sum()
    dropped = 1.0 - (keep.sum(-1) / K).mean()
    return y.reshape(B, S0, d), {"moe_aux": aux, "moe_dropped": dropped}


class _GatherRows(torch.autograd.Function):
    """``rows.index_select(0, index)`` whose backward sums each row's
    gradients (one per expert slot it went to) in f32 and casts once, as
    the reference's dispatch einsum accumulates; autograd's own backward
    would add them in the rows' dtype, rounding at every add in bf16."""

    @staticmethod
    def forward(ctx, rows, index):
        ctx.save_for_backward(index)
        ctx.n_rows = rows.shape[0]
        return rows.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        acc = torch.zeros((ctx.n_rows, grad.shape[1]), dtype=torch.float32,
                          device=grad.device)
        return acc.index_add_(0, index, grad.float()).to(grad.dtype), None


class MoE(nn.Module):
    """The moe family's MLP: ``router`` (d, E) and the stacked experts
    ``w_gate``, ``w_up`` (E, d, f) and ``w_down`` (E, f, d). Returns
    (y, aux) like ``moe_apply``."""

    def __init__(self, cfg: ArchConfig, router, w_gate, w_up, w_down):
        super().__init__()
        self.cfg = cfg
        self.router, self.w_gate, self.w_up, self.w_down = (
            nn.Parameter(router), nn.Parameter(w_gate), nn.Parameter(w_up),
            nn.Parameter(w_down))

    def forward(self, x):
        return moe_apply({n: getattr(self, n) for n in PARAM_NAMES},
                         self.cfg, x)
