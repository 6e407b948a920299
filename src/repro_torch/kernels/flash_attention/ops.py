"""Wrappers of kernels L1 (the forward pass of flash attention, with an
optional row logsumexp) and L2 (its backward pass), and the autograd
Function that joins them for training.

Each kernel has two CUDA variants, chosen by dtype and by nothing else:
bf16 goes to the Hopper tensor-core kernels (``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention_bwd_sm90.cu``: wgmma fed by TMA), f32 to the
3xTF32 tensor-core kernels (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``: mma.sync fed by cp.async, each f32
product as three TF32 products of split operands x = hi + lo, which keep
the f32 results to 1e-5 where one TF32 product would not). Each wrapper
counts all its launches in ``launches`` and the bf16 ones in
``sm90_launches``.

L1 replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_padded``, body ``_kernel``, with ``return_lse``) and its
wrapper ``ops.flash_attention``, which pads q/k/v to 256/512 multiples: the
CUDA kernel masks the ragged edge itself, so nothing is padded or copied.
L2 replaces ``kernel_bwd.py`` (``flash_bwd_padded``: ``_dq_kernel`` and
``_dkv_kernel``) and the wrapper ``ops._fa_bwd``, which repeats K/V to every
q-head and sums per-q-head dk/dv afterwards: L2 sums over the GQA group
inside its dk/dv pass. Both are bound by operations on the H100 (see the
sources for the designs).

On a CUDA tensor ``flash_attention`` and ``flash_bwd`` launch their kernel
or raise, and report the launch to a recording op trace
(``analysis.optrace.note_kernel``); on a CPU tensor they run the plain
versions (``ref.py``); on ``meta`` tensors (a dry run's plan) they make
outputs of the kernel's shapes and record the launch, computing nothing
and counting nothing. The results are in the input dtype (lse in f32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ops import check_cuda_operands
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_bwd_ref)

HEAD_DIMS = (32, 64, 112, 128)       # L1; 112 is zamba2's shared block
BWD_HEAD_DIMS = HEAD_DIMS             # L2
DTYPES = (torch.float32, torch.bfloat16)
MAX_TILES = 65535            # the kernels' grid y axis: 64 rows per tile


def _lib():
    fn = BUILD.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def _lib_bwd():
    fn = BUILD.load("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def _lib_sm90():
    fn = BUILD.load("flash_attention_sm90").flash_attention_sm90_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def _lib_bwd_sm90():
    lib = BUILD.load("flash_attention_bwd_sm90")
    fn = lib.flash_attention_bwd_sm90_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Sq, H, hd) and k = v (B, Skv, Hkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "agree on batch and head size, or H % Hkv != 0")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_cuda(tensors, dtypes, head_dims):
    """The kernels' operand rules: f32 or bf16, contiguous, on the card,
    16-byte aligned, a head size they were built for, a grid that fits."""
    q, k = tensors["q"], tensors["k"]
    B, Sq, _, hd = q.shape
    if hd not in head_dims:
        raise ValueError(f"this flash attention kernel takes hd in "
                         f"{head_dims}, got {hd}")
    if (max(Sq, k.shape[1]) + 63) // 64 > MAX_TILES or B > 65535:
        raise ValueError(f"grid too large: B={B}, Sq={Sq}, Skv={k.shape[1]}")
    check_cuda_operands(tensors, dtypes)
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        # the bf16 kernels read by TMA, whose global strides (one row of a
        # head: hd elements) must be multiples of 16 bytes
        if t.dtype == torch.bfloat16 and (hd * t.element_size()) % 16:
            raise ValueError(f"{name}: a row of {hd} bf16 values is not a "
                             "multiple of 16 bytes, as TMA needs")


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd), f32 or bf16, one dtype.
    Query i attends to key j iff (not causal or j <= i) and (window == 0
    or j > i - window). Returns (B, Sq, H, hd) in the input dtype and, with
    ``return_lse``, the per-row logsumexp (B, Sq, H) f32 that ``flash_bwd``
    needs."""
    _check_qkv(q, k, v, window)
    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  return_lse=return_lse)
        if return_lse:
            return out[0].to(q.dtype), out[1]
        return out.to(q.dtype)
    if q.device.type == "meta":
        return _plan(q, k, v, return_lse)
    return _launch(q, k, v, causal, window, return_lse)


def _outputs(q, return_lse):
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    return o, lse


def _note(q, k, v, o, lse):
    OPT.note_kernel("repro_torch::flash_attention", dict(q=q, k=k, v=v),
                    dict(o=o) if lse is None else dict(o=o, lse=lse))


def _plan(q, k, v, return_lse):
    """The launch on ``meta`` operands (a dry run's plan): outputs of its
    shapes and a ``note_kernel`` record, nothing computed and no launch
    counted (``roofline.op_cost`` costs the record)."""
    o, lse = _outputs(q, return_lse)
    _note(q, k, v, o, lse)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.sm90_launches = 0


def _launch(q, k, v, causal, window, return_lse):
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _check_cuda(dict(q=q, k=k, v=v), dict(q=DTYPES, k=DTYPES, v=DTYPES),
                HEAD_DIMS)
    o, lse = _outputs(q, return_lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr())
    dims = (B, Sq, Skv, H, Hkv, hd, int(bool(causal)), int(window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        BUILD.check(_lib_sm90()(*ptrs, *dims, stream),
                    "flash_attention_sm90_launch")
        flash_attention.sm90_launches += 1
    else:
        BUILD.check(_lib()(*ptrs, *dims, stream), "flash_attention_launch")
    flash_attention.launches += 1
    _note(q, k, v, o, lse)
    return (o, lse) if return_lse else o


def flash_bwd(q, k, v, o, do, lse, causal: bool = True, window: int = 0):
    """The backward pass of ``flash_attention`` at (q, k, v) with output
    ``o``, its gradient ``do`` (both (B, Sq, H, hd), the dtype of q) and
    the forward's ``lse`` (B, Sq, H) f32. Returns (dq, dk, dv) in the
    input dtype, dk/dv summed over each GQA group."""
    _check_qkv(q, k, v, window)
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (B, Sq, H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 (B, Sq, H) = {(B, Sq, H)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not o.dtype == do.dtype == q.dtype:
        raise TypeError(f"o and do must be {q.dtype}, got {o.dtype}, "
                        f"{do.dtype}")
    if q.device.type == "cpu":
        dq, dk, dv = flash_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                   window=window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type == "meta":      # a dry run's plan, as ``_plan``
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _note_bwd(q, k, v, o, do, lse, *grads)
        return grads
    return _launch_bwd(q, k, v, o, do, lse, causal, window)


def _note_bwd(q, k, v, o, do, lse, dq, dk, dv):
    OPT.note_kernel("repro_torch::flash_attention_bwd",
                    dict(q=q, k=k, v=v, o=o, do=do, lse=lse),
                    dict(dq=dq, dk=dk, dv=dv))


flash_bwd.launches = 0
flash_bwd.sm90_launches = 0


def _launch_bwd(q, k, v, o, do, lse, causal, window):
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _check_cuda(dict(q=q, k=k, v=v, o=o, do=do, lse=lse),
                dict(q=DTYPES, k=DTYPES, v=DTYPES, o=DTYPES, do=DTYPES,
                     lse=(torch.float32,)), BWD_HEAD_DIMS)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, o, do, lse, D, dq, dk, dv))
    dims = (B, Sq, Skv, H, Hkv, hd, int(bool(causal)), int(window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        BUILD.check(_lib_bwd_sm90()(*ptrs, *dims, stream),
                    "flash_attention_bwd_sm90_launch")
        flash_bwd.sm90_launches += 1
    else:
        BUILD.check(_lib_bwd()(*ptrs, *dims, stream),
                    "flash_attention_bwd_launch")
    flash_bwd.launches += 1
    _note_bwd(q, k, v, o, do, lse, dq, dk, dv)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (port of the reference's
    ``flash_attention_trainable`` custom VJP): the forward is L1 with its
    lse output, the backward L2. Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, do.contiguous(), lse,
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, window: int = 0):
    """``flash_attention`` with a gradient: L1 forward, L2 backward. Unlike
    the reference's, it takes any Sq/Skv (the kernels mask ragged edges).
    Returns (B, Sq, H, hd) in the input dtype."""
    return FlashAttention.apply(q, k, v, causal, window)
