"""Mamba2 (SSD) mixer of the hybrid family (port of
``repro/models/mamba2.py``).

Per head h (P = ssm_head_dim channels, N = ssm_state):

    S_t = exp(a_t) · S_{t-1} + dt_t · x_t ⊗ B_t        S ∈ R^{P×N}
    y_t = S_t C_t + D ⊙ x_t                            a_t = -exp(A_log)·dt_t

The projections stay separate matrices (w_z, w_x, w_B, w_C, w_dt), as in
the reference. A prompt (S > 1) is padded to a multiple of 128 with
identity steps (dt = 0 gives a = 0 and xdt = 0) and goes through
``ssd_scan`` (kernel L4 on the card, its plain chunked version on the CPU),
or, when autograd records a gradient of the scan's inputs, through
``ssd_scan_train``, the reference's training route (its ``ssd_chunked``
under ``jax.grad``, each chunk checkpointed; L4 has no backward, as the
reference's Pallas kernel has none); one token goes through ``ssd_step``.
The depthwise causal convolution is a sum of ``W`` shifted products in
the activation dtype, as the reference writes it, not a ``conv1d``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_chunk.ops import ssd_scan
from repro_torch.kernels.ssd_chunk.ref import CHUNK, ssd_chunked
from repro_torch.models.layers import RMSNorm

# the mixer's parameters in the reference's order (``mamba2_init``)
PARAM_NAMES = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
               "conv_C", "conv_bias_x", "conv_bias_B", "conv_bias_C",
               "A_log", "D", "dt_bias", "out_proj")


def mamba2_dims(cfg: ArchConfig):
    """(d_inner, n_heads, N, P)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def causal_conv(x, w, b, conv_state):
    """Depthwise causal conv + SiLU. x: (B, S, C); w: (W, C); b: (C,);
    conv_state: (B, W-1, C), the previous segment's last inputs. Returns
    (y in x's dtype, the new conv state)."""
    S = x.shape[1]
    W = w.shape[0]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)        # (B, S+W-1, C)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return F.silu(y.float()).to(x.dtype), xp[:, S:]


def ssd_scan_train(x, dt, A_log, B_, C_, state0):
    """The training scan, port of the reference's ``ssd_chunked(x, dt,
    A_log, B, C, state0)``: a = −exp(A_log)·dt and xdt = x·dt, then the
    chunked scan with each 128-step chunk under a non-reentrant
    checkpoint (``jax.checkpoint(chunk_step)``), so autograd keeps only
    the carried (B, H, P, N) state per chunk. x: (B, S, H, P); dt: (B, S,
    H); B_/C_: (B, S, N); state0: (B, H, P, N); S % 128 == 0. Returns y
    (B, S, H, P) and the final state, f32."""
    a = -torch.exp(A_log.float())[None, None, :] * dt
    return ssd_chunked(x * dt[..., None], a, B_, C_, state0, remat=True)


def ssd_step(x, dt, A_log, B_, C_, state):
    """One decode step. x: (B, H, P); dt: (B, H); B_/C_: (B, N); state
    (B, H, P, N) f32. Returns y (B, H, P), the new state."""
    a = torch.exp(-torch.exp(A_log.float())[None, :] * dt)           # (B, H)
    upd = (x * dt[..., None])[..., None] * B_[:, None, None, :]
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_)
    return y, state


class Mamba2Mixer(nn.Module):
    """The reference's ``mamba2_init`` parameters, each an ``nn.Parameter``
    (matrices stored (d_in, d_out)), and ``mamba2_apply``."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor],
                 norm: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        for n in PARAM_NAMES:
            setattr(self, n, nn.Parameter(params[n]))
        self.norm = RMSNorm(norm, cfg.norm_eps)

    def forward(self, x, state) -> Tuple[torch.Tensor, Dict]:
        """x: (B, S, d); state: dict of conv_x / conv_B / conv_C histories
        (B, W-1, ·) and ssm (B, H, P, N) f32. Returns (out (B, S, d), the
        new state as a dict of new tensors)."""
        y, z, new = self.mix(x, state)
        y = self.gate(self.norm(y), z)
        return y @ self.out_proj.to(x.dtype), new

    def mix(self, x, state) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """The mixer up to its gated norm, over the heads its parameters
        hold (``A_log``'s length: all H, or a model slot's share, whose
        ``w_z`` / ``w_x`` / ``conv_x`` columns are those heads' channels;
        ``B`` and ``C`` are whole on every slot): the projections, the
        causal convolutions, the scan and the D skip. Returns (y (B, S,
        heads · P) in x's dtype, z, the new state)."""
        Bb, S, _ = x.shape
        H, P = self.A_log.shape[0], self.cfg.ssm_head_dim
        z = x @ self.w_z.to(x.dtype)
        xin = x @ self.w_x.to(x.dtype)
        B_ = x @ self.w_B.to(x.dtype)
        C_ = x @ self.w_C.to(x.dtype)
        dt = x @ self.w_dt.to(x.dtype)

        xin, st_x = causal_conv(xin, self.conv_x, self.conv_bias_x,
                                state["conv_x"])
        B_, st_B = causal_conv(B_, self.conv_B, self.conv_bias_B,
                               state["conv_B"])
        C_, st_C = causal_conv(C_, self.conv_C, self.conv_bias_C,
                               state["conv_C"])

        dt = F.softplus(dt.float() + self.dt_bias.float())           # (B,S,H)
        xh = xin.float().reshape(Bb, S, H, P)
        Bf, Cf = B_.float(), C_.float()
        if S == 1:
            y, ssm = ssd_step(xh[:, 0], dt[:, 0], self.A_log, Bf[:, 0],
                              Cf[:, 0], state["ssm"])
            y = y[:, None]
        else:
            pad = (-S) % CHUNK
            xp, dtp, Bp, Cp = (
                F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
                for t in (xh, dt, Bf, Cf))
            train = torch.is_grad_enabled() and any(
                t.requires_grad for t in (xp, dtp, self.A_log, Bp, Cp,
                                          state["ssm"]))
            if train:
                y, ssm = ssd_scan_train(xp, dtp, self.A_log, Bp, Cp,
                                        state["ssm"])
            else:
                a = -torch.exp(self.A_log.float())[None, None, :] * dtp
                y, ssm = ssd_scan((xp * dtp[..., None]).contiguous(),
                                  a.contiguous(), Bp.contiguous(),
                                  Cp.contiguous(), state["ssm"].contiguous())
            y = y[:, :S]
        y = y + self.D.float()[None, None, :, None] * xh
        return (y.reshape(Bb, S, H * P).to(x.dtype), z,
                {"conv_x": st_x, "conv_B": st_B, "conv_C": st_C, "ssm": ssm})

    @staticmethod
    def gate(y, z):
        """The normed y times silu(z), in y's dtype."""
        return y * F.silu(z.float()).to(y.dtype)


def mamba2_state_init(cfg: ArchConfig, batch: int, dtype, device,
                      n_layers: int = 0):
    """Zero mixer state: conv histories in ``dtype``, ssm in f32; with
    ``n_layers`` a leading layer axis."""
    d_in, H, N, P = mamba2_dims(cfg)
    W = cfg.ssm_conv_width
    lead = (n_layers,) if n_layers else ()

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return {"conv_x": zeros(batch, W - 1, d_in),
            "conv_B": zeros(batch, W - 1, N),
            "conv_C": zeros(batch, W - 1, N),
            "ssm": zeros(batch, H, P, N, dt=torch.float32)}
