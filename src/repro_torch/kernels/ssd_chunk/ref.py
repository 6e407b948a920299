"""Plain PyTorch versions of kernel L4: the Mamba2 SSD scan.

    S_t = exp(a_t) S_{t-1} + xdt_t ⊗ B_t ;   y_t = S_t C_t

(xdt = dt·x already folded in by the caller; the D residual is applied
outside.) ``ssd_sequential`` is the step-by-step recurrence, the port of
the oracle ``repro/kernels/ssd_chunk/ref.py``; ``ssd_chunked`` is the
chunked form of ``repro/models/mamba2.py::ssd_chunked`` (taking the log
decay ``a`` and ``xdt`` as ``ops.ssd_scan`` does), the CPU path of
``ops.ssd_scan``, the kernel's oracle on the card and, with ``remat``,
the hybrid family's training scan (``models/mamba2.py``). Both are
differentiable by autograd.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 128


def ssd_sequential(xdt, a, B_, C_, state0):
    """xdt: (Bb, S, H, P); a: (Bb, S, H) log decay; B_/C_: (Bb, S, N);
    state0: (Bb, H, P, N). Returns y (Bb, S, H, P), state, both f32."""
    h = state0.float()
    ys = []
    for t in range(xdt.shape[1]):
        h = (torch.exp(a[:, t])[..., None, None] * h
             + xdt[:, t, :, :, None] * B_[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunk_step(state, xb, ab, bb, cb, mask):
    """One chunk of ``ssd_chunked`` (the reference's ``chunk_step``): with
    L = cumsum(a) over the chunk, y_t = exp(L_t)·(C_t·S) + Σ_{j<=t} (C_t·B_j)
    exp(L_t − L_j) xdt_j and S' = exp(L_C) S + Σ_j exp(L_C − L_j) xdt_j ⊗
    B_j; the exponent is masked before the exponential, as in the
    reference (its VJP would meet 0·inf otherwise). ``mask`` is the
    (1, C, C, 1) lower triangle. Returns (y (Bb, C, H, P), S')."""
    L = torch.cumsum(ab, dim=1)                                  # (B, C, H)
    y = torch.exp(L)[..., None] * torch.einsum("bhpn,bcn->bchp", state, cb)
    G = torch.einsum("bcn,bjn->bcj", cb, bb)                     # C_t · B_j
    D = L[:, :, None, :] - L[:, None, :, :]                      # L_t − L_j
    M = G[..., None] * (torch.exp(torch.where(mask, D, 0.0)) * mask)
    y = y + torch.einsum("bcjh,bjhp->bchp", M, xb)
    LC = L[:, -1]                                                # (B, H)
    xw = torch.exp(LC[:, None, :] - L)[..., None] * xb
    state = (torch.exp(LC)[..., None, None] * state
             + torch.einsum("bjhp,bjn->bhpn", xw, bb))
    return y, state


def ssd_chunked(xdt, a, B_, C_, state0, chunk: int = CHUNK,
                remat: bool = False):
    """The chunk-parallel form over chunks of ``chunk`` steps (S % chunk
    == 0), shapes as ``ssd_sequential``: ``ssd_chunk_step`` per chunk, the
    state carried. With ``remat`` each chunk runs under a non-reentrant
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint
    (chunk_step)``: autograd keeps only each chunk's inputs and carried
    state and recomputes the chunk in the backward pass."""
    Bb, S, H, P = xdt.shape
    if S % chunk:
        raise ValueError(f"S = {S} is not a multiple of {chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xdt.device))[None, :, :, None]
    step = (functools.partial(checkpoint, ssd_chunk_step,
                              use_reentrant=False)
            if remat else ssd_chunk_step)
    state = state0.float()
    ys = []
    for c0 in range(0, S, chunk):
        y, state = step(state, *(t[:, c0:c0 + chunk]
                                 for t in (xdt, a, B_, C_)), mask)
        ys.append(y)
    return torch.cat(ys, dim=1), state
