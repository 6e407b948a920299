"""RWKV6 (Finch) time-mix and channel-mix of the ssm family (port of
``repro/models/rwkv6.py``).

Recurrence (per head, key size = value size = wkv_head_dim N):

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ S_{t-1} + (r_t ⊙ u ⊙ k_t) · v_t

with the data-dependent decay w_t = exp(-exp(w0 + tanh(x A) B)) from a
small LoRA. A prompt (S > 1) is padded to a multiple of 128 with identity
steps (log w = 0 and k = 0 leave the state as it is) and goes through
``wkv6`` (kernel L5 on the card, its plain chunked version on the CPU),
or, when autograd records a gradient of the scan's inputs, through
``wkv_scan_train``, the reference's training route (its ``wkv_chunked``
under ``jax.grad``, each chunk checkpointed; L5 has no backward, as the
reference's Pallas kernel has none); one token goes through ``wkv_step``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import CHUNK, wkv_chunked
from repro_torch.models.layers import RMSNorm

LORA_R = 64
# the time-mix parameters in the reference's order (``timemix_init``),
# ``ln_out`` aside
TIMEMIX_NAMES = ("mix_base", "wr", "wk", "wv", "wg", "wo", "decay_w0",
                 "decay_A", "decay_B", "bonus_u")
CHANNELMIX_NAMES = ("mix_base", "w_in", "w_out")


def token_shift(x, x_prev):
    """x: (B, S, d); x_prev: (B, d), the last token of the previous
    segment. Returns x shifted one step right."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def wkv_scan_train(r, k, v, logw, u, state0):
    """The training scan, port of the reference's ``wkv_chunked``: the
    chunked recurrence with each 128-step chunk under a non-reentrant
    checkpoint (``jax.checkpoint(chunk_step)``), so autograd keeps only the
    carried (B, H, N, N) state per chunk. r, k, v, logw: (B, S, H, N) with
    S % 128 == 0; u: (H, N); state0: (B, H, N, N). Returns y (B, S, H, N)
    and the final state, f32."""
    return wkv_chunked(r, k, v, logw, u, state0, remat=True)


def wkv_step(r, k, v, logw, u, state):
    """One decode step. r, k, v, logw: (B, H, N); state: (B, H, N, N)."""
    y = torch.einsum("bhn,bhnm->bhm", r, state)
    y = y + (r * u * k).sum(-1, keepdim=True) * v
    state = torch.exp(logw)[..., None] * state + k[..., None] * v[..., None, :]
    return y, state


class TimeMix(nn.Module):
    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor],
                 ln_out: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        for n in TIMEMIX_NAMES:
            setattr(self, n, nn.Parameter(params[n]))
        self.ln_out = RMSNorm(ln_out, cfg.norm_eps)

    def forward(self, x, x_prev, state):
        """x: (B, S, d); x_prev: (B, d); state: (B, H, N, N) f32. Returns
        (out (B, S, d), x's last token, the new state)."""
        y, g, state = self.mix(x, x_prev, state)
        y = self.gate(self.ln_out(y), g)
        return y @ self.wo.to(x.dtype), x[:, -1], state

    def mix(self, x, x_prev, state, cols=None):
        """The time-mix up to ``ln_out``, over the WKV heads whose columns
        ``wr`` / ``wk`` / ``wv`` / ``wg`` hold (all of them, or a model
        slot's share: columns ``cols`` = (first, end) of d, whose columns
        of ``logw`` and ``u`` it computes from the replicated decay and
        bonus): the token shift and the five mixes of the whole x, the
        projections, the decay and the scan. Returns (y (B, S, columns)
        f32, g in x's dtype, the new state)."""
        Bb, S, d = x.shape
        N = self.cfg.wkv_head_dim
        H = self.wr.shape[1] // N
        shifted = token_shift(x, x_prev)
        mix = self.mix_base.to(x.dtype)                       # (5, d)
        xs = [x + mix[i] * (shifted - x) for i in range(5)]
        r = xs[0] @ self.wr.to(x.dtype)
        k = xs[1] @ self.wk.to(x.dtype)
        v = xs[2] @ self.wv.to(x.dtype)
        g = xs[3] @ self.wg.to(x.dtype)
        w0, dB, u = self.decay_w0, self.decay_B, self.bonus_u
        if cols is not None:
            w0, dB, u = w0[cols[0]:cols[1]], dB[:, cols[0]:cols[1]], \
                u[cols[0]:cols[1]]
        lora = torch.tanh(xs[4].float() @ self.decay_A.float()
                          ) @ dB.float()
        logw = -torch.exp(w0.float() + lora)                  # (B, S, ·) < 0
        u = u.float().reshape(H, N)

        rf, kf, vf, wf = (t.float().reshape(Bb, S, H, N)
                          for t in (r, k, v, logw))
        if S == 1:
            y, state = wkv_step(rf[:, 0], kf[:, 0], vf[:, 0], wf[:, 0], u,
                                state)
            y = y[:, None]
        else:
            pad = (-S) % CHUNK
            if pad:
                rf, kf, vf, wf = (F.pad(t, (0, 0, 0, 0, 0, pad))
                                  for t in (rf, kf, vf, wf))
            train = torch.is_grad_enabled() and any(
                t.requires_grad for t in (rf, kf, vf, wf, u, state))
            scan = wkv_scan_train if train else wkv6
            y, state = scan(rf.contiguous(), kf.contiguous(), vf.contiguous(),
                            wf.contiguous(), u.contiguous(),
                            state.contiguous())
            y = y[:, :S]
        return y.reshape(Bb, S, H * N), g, state

    @staticmethod
    def gate(y, g):
        """The normed f32 y in g's dtype times silu(g)."""
        return y.to(g.dtype) * F.silu(g.float()).to(g.dtype)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        for n in CHANNELMIX_NAMES:
            setattr(self, n, nn.Parameter(params[n]))

    def forward(self, x, x_prev):
        """Squared-ReLU MLP on the token-shifted mix. Returns (out, x's
        last token)."""
        h, last = self.hidden(x, x_prev)
        return h @ self.w_out.to(x.dtype), last

    def hidden(self, x, x_prev):
        """relu(xk @ w_in)² of the token-shifted mix (what ``w_out``
        takes, all of d_ff or a model slot's columns), and x's last
        token."""
        shifted = token_shift(x, x_prev)
        xk = x + self.mix_base.to(x.dtype)[0] * (shifted - x)
        h = xk @ self.w_in.to(x.dtype)
        return torch.square(F.relu(h.float())).to(x.dtype), x[:, -1]
