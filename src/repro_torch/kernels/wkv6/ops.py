"""Wrapper of kernel L5 (``csrc/wkv6.cu``), the RWKV6 WKV recurrence over
a whole sequence, forward only.

Replaces the TPU kernel ``src/repro/kernels/wkv6/kernel.py``
(``wkv_chunk_padded``, body ``_kernel``) and its wrapper ``ops.wkv6``,
which runs one kernel call per 128-step chunk inside a ``lax.scan``: the
CUDA kernel loops over 64-step chunks inside one block per (batch, head),
so a layer is one launch. Bound on the H100: bytes, once its products run
on the tensor cores (bf16 hi + lo operands, the next chunk's inputs in
flight while this one multiplies; see the source).

On a CUDA tensor ``wkv6`` launches the kernel or raises; on a CPU tensor
it runs the plain chunked version (``ref.wkv_chunked``); on ``meta``
tensors (a dry run's plan) it makes outputs of their shapes and records
the launch (``optrace.note_kernel``), nothing computed. The reference
kernel has no VJP, and neither has this one: on a CUDA tensor that needs
a gradient it raises. Training takes the reference's route instead, the
chunked scan under autograd (``models.rwkv6.wkv_scan_train``), which the
time-mix picks when a gradient is recorded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ops import check_cuda_operands
from repro_torch.kernels.wkv6.ref import CHUNK, wkv_chunked

HEAD_SIZES = (32, 64)      # N the kernel is built for


def _lib():
    fn = BUILD.load("wkv6").wkv6_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def wkv6(r, k, v, logw, u, state0):
    """r, k, v, logw: (B, S, H, N) with S % CHUNK == 0, as the reference
    requires (the mixer pads with identity steps); u: (H, N); state0:
    (B, H, N, N). Returns y (B, S, H, N) f32 and the final state
    (B, H, N, N) f32."""
    if r.dim() != 4:
        raise ValueError(f"expected r (B, S, H, N), got {tuple(r.shape)}")
    B, S, H, N = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or u.shape != (H, N) or state0.shape != (B, H, N, N)):
        raise ValueError(f"shapes disagree: r/k/v/logw {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, state0 "
                         f"{tuple(state0.shape)}")
    if S % CHUNK:
        raise ValueError(f"S = {S} is not a multiple of {CHUNK}")
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, logw, u, state0)
    if r.device.type == "meta":
        # a dry run's plan: the outputs' shapes and a record of the launch,
        # nothing computed and no launch counted
        y, state = torch.empty_like(r), torch.empty_like(state0)
        OPT.note_kernel("repro_torch::wkv6",
                        dict(r=r, k=k, v=v, logw=logw, u=u, state0=state0),
                        dict(y=y, state=state))
        return y, state
    return _launch(r, k, v, logw, u, state0)


wkv6.launches = 0


def _launch(r, k, v, logw, u, state0):
    B, S, H, N = r.shape
    tensors = dict(r=r, k=k, v=v, logw=logw, u=u, state0=state0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "wkv6's CUDA kernel is forward-only, as the reference's; "
            "a scan that needs a gradient takes the training scan, "
            "models.rwkv6.wkv_scan_train")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes N in {HEAD_SIZES}, got {N}")
    check_cuda_operands(tensors, {n: (torch.float32,) for n in tensors})
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), state0.data_ptr(), y.data_ptr(),
                 state.data_ptr(), B, S, H, N,
                 torch.cuda.current_stream(r.device).cuda_stream)
    BUILD.check(err, "wkv6_launch")
    wkv6.launches += 1
    return y, state
