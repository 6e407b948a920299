"""Wrapper of kernel L1 (``csrc/flash_attention.cu``), the forward pass of
flash attention.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_padded``, body ``_kernel``) and its wrapper
``ops.flash_attention``, which pads q/k/v to 256/512 multiples: the CUDA
kernel masks the ragged edge itself, so nothing is padded or copied.
Bound on the H100: operations (see the source for the design).

On a CUDA tensor ``flash_attention`` launches the kernel or raises; on a
CPU tensor it runs the plain version (``ref.flash_attention_ref``). Either
way the result is in the input dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ops import check_cuda_operands
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_Q_TILES = 65535          # the kernel's grid y axis: 64 rows per tile


def _lib():
    fn = BUILD.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd), f32 or bf16, one dtype.
    Query i attends to key j iff (not causal or j <= i) and (window == 0
    or j > i - window). Returns (B, Sq, H, hd) in the input dtype."""
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
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=window).to(q.dtype)
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0


def _launch(q, k, v, causal, window):
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if (Sq + 63) // 64 > MAX_Q_TILES or B > 65535:
        raise ValueError(f"grid too large: B={B}, Sq={Sq}")
    check_cuda_operands(dict(q=q, k=k, v=v),
                        dict(q=DTYPES, k=DTYPES, v=DTYPES))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    o = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Skv, H, Hkv, hd,
                 int(bool(causal)), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    BUILD.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return o
