"""Wrapper of kernel L4 (``csrc/ssd_chunk.cu``), the Mamba2 SSD scan over
a whole sequence, forward only.

Replaces the TPU kernel ``src/repro/kernels/ssd_chunk/kernel.py``
(``ssd_chunk_padded``, body ``_kernel``) and its wrapper ``ops.ssd_scan``,
which runs one kernel call per 128-step chunk inside a ``lax.scan``: the
CUDA kernel loops over the chunks inside one block per (batch, pair of
heads), its products on the tensor cores (bf16 operands split hi + lo),
so a layer is one launch. Bound on the H100: bytes (see the source).

On a CUDA tensor ``ssd_scan`` launches the kernel or raises; on a CPU
tensor it runs the plain chunked version (``ref.ssd_chunked``); on
``meta`` tensors (a dry run's plan) it makes outputs of their shapes and
records the launch (``optrace.note_kernel``), nothing computed. The
reference kernel has no VJP, and neither has this one: on a CUDA tensor
that needs a gradient it raises. Training takes the reference's route
instead, the chunked scan under autograd (``models.mamba2.ssd_scan_train``),
which the mixer picks when a gradient is recorded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ops import check_cuda_operands
from repro_torch.kernels.ssd_chunk.ref import CHUNK, ssd_chunked

SHAPES = ((32, 16), (64, 64))      # (P, N) the kernel is built for


def _lib():
    fn = BUILD.load("ssd_chunk").ssd_chunk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(xdt, a, B_, C_, state0):
    """xdt: (Bb, S, H, P) (dt folded in); a: (Bb, S, H) log decay; B_/C_:
    (Bb, S, N); state0: (Bb, H, P, N); S % CHUNK == 0, as the reference
    requires (the mixer pads with identity steps). Returns y (Bb, S, H, P)
    f32 and the final state (Bb, H, P, N) f32."""
    if xdt.dim() != 4:
        raise ValueError(f"expected xdt (Bb, S, H, P), got {tuple(xdt.shape)}")
    Bb, S, H, P = xdt.shape
    N = B_.shape[-1]
    if (a.shape != (Bb, S, H) or B_.shape != (Bb, S, N)
            or C_.shape != (Bb, S, N) or state0.shape != (Bb, H, P, N)):
        raise ValueError(f"shapes disagree: xdt {tuple(xdt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(B_.shape)}, C "
                         f"{tuple(C_.shape)}, state0 {tuple(state0.shape)}")
    if S % CHUNK:
        raise ValueError(f"S = {S} is not a multiple of {CHUNK}")
    if xdt.device.type == "cpu":
        return ssd_chunked(xdt, a, B_, C_, state0)
    if xdt.device.type == "meta":
        # a dry run's plan: the outputs' shapes and a record of the launch,
        # nothing computed and no launch counted
        y, state = torch.empty_like(xdt), torch.empty_like(state0)
        OPT.note_kernel("repro_torch::ssd_chunk",
                        dict(xdt=xdt, a=a, B=B_, C=C_, state0=state0),
                        dict(y=y, state=state))
        return y, state
    return _launch(xdt, a, B_, C_, state0)


ssd_scan.launches = 0


def _launch(xdt, a, B_, C_, state0):
    Bb, S, H, P = xdt.shape
    N = B_.shape[-1]
    tensors = dict(xdt=xdt, a=a, B=B_, C=C_, state0=state0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "ssd_scan's CUDA kernel is forward-only, as the reference's; "
            "a scan that needs a gradient takes the training scan, "
            "models.mamba2.ssd_scan_train")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan kernel takes (P, N) in {SHAPES}, got "
                         f"{(P, N)}")
    check_cuda_operands(tensors, {n: (torch.float32,) for n in tensors})
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    y = torch.empty_like(xdt)
    state = torch.empty_like(state0)
    err = _lib()(xdt.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                 state0.data_ptr(), y.data_ptr(), state.data_ptr(), Bb, S, H,
                 P, N, torch.cuda.current_stream(xdt.device).cuda_stream)
    BUILD.check(err, "ssd_chunk_launch")
    ssd_scan.launches += 1
    return y, state
