"""Plain PyTorch versions of kernel L5: the RWKV6 WKV recurrence.

    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ S_{t-1} + (r_t ⊙ u ⊙ k_t)·v_t

``wkv_sequential`` is the step-by-step recurrence, the port of the
oracle ``repro/kernels/wkv6/ref.py``; ``wkv_chunked`` is the chunked form
of ``repro/models/rwkv6.py::wkv_chunked`` with its mid-chunk stabilizer
c = L_C/2, the CPU path of ``ops.wkv6``, the kernel's oracle on the
card and, with ``remat``, the ssm family's training scan
(``models/rwkv6.py``). Both are differentiable by autograd.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 128


def wkv_sequential(r, k, v, logw, u, state0):
    """r, k, v, logw: (B, S, H, N); u: (H, N); state0: (B, H, N, N).
    Returns y (B, S, H, N), state, both f32."""
    S_ = state0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        y = (torch.einsum("bhn,bhnm->bhm", rt, S_)
             + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S_ = (torch.exp(logw[:, t])[..., None] * S_
              + kt[..., :, None] * vt[..., None, :])
        ys.append(y)
    return torch.stack(ys, dim=1), S_


def wkv_chunk_step(state, rb, kb, vb, wb, u, mask):
    """One chunk of ``wkv_chunked`` (the reference's ``chunk_step``): with
    L = cumsum(logw) over the chunk and c = L_C/2, y_t = (r_t e^{L_{t-1}})·S
    + Σ_{j<t} [(r_t e^{L_{t-1}-c})·(k_j e^{c-L_j})] v_j + (r_t·u·k_t) v_t
    and S' = e^{L_C} S + Σ_j (k_j e^{L_C-L_j}) v_jᵀ; ``mask`` is the
    strict (C, C) lower triangle. Returns (y (B, C, H, N), S')."""
    L = torch.cumsum(wb, dim=1)                           # (B, C, H, N)
    Lm1 = L - wb
    y = torch.einsum("bchn,bhnm->bchm", rb * torch.exp(Lm1), state)
    c = L[:, -1:] * 0.5
    A = torch.einsum("bchn,bjhn->bhcj", rb * torch.exp(Lm1 - c),
                     kb * torch.exp(c - L))
    A = torch.where(mask, A, 0.0)
    y = y + torch.einsum("bhcj,bjhm->bchm", A, vb)
    y = y + torch.einsum("bchn,bchn->bch", rb * u, kb)[..., None] * vb
    LC = L[:, -1]                                         # (B, H, N)
    state = (torch.exp(LC)[..., None] * state
             + torch.einsum("bjhn,bjhm->bhnm",
                            kb * torch.exp(LC[:, None] - L), vb))
    return y, state


def wkv_chunked(r, k, v, logw, u, state0, chunk: int = CHUNK,
                remat: bool = False):
    """The chunk-parallel form over chunks of ``chunk`` steps (S % chunk
    == 0), shapes as ``wkv_sequential``: ``wkv_chunk_step`` per chunk, the
    state carried. With ``remat`` each chunk runs under a non-reentrant
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint
    (chunk_step)``: autograd keeps only each chunk's inputs and carried
    state and recomputes the chunk in the backward pass."""
    B, S, H, N = r.shape
    if S % chunk:
        raise ValueError(f"S = {S} is not a multiple of {chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), -1)
    step = (functools.partial(checkpoint, wkv_chunk_step, use_reentrant=False)
            if remat else wkv_chunk_step)
    state = state0.float()
    ys = []
    for c0 in range(0, S, chunk):
        y, state = step(state, *(t[:, c0:c0 + chunk]
                                 for t in (r, k, v, logw)), u, mask)
        ys.append(y)
    return torch.cat(ys, dim=1), state
