"""Wrapper of kernel B1 (``csrc/bmf_precision.cu``).

Replaces the TPU kernel ``src/repro/kernels/bmf_precision/kernel.py``
(``precision_accum_fused_padded``, body ``_fused_kernel``) and its
wrappers ``ops.precision_accum`` / ``ops.precision_accum_fused``.

Two designs, both gathering inside the kernel (no (N, M, K) tensor) and
reading only the live prefix of each row (the per-row ``live`` lengths
take the place of ``tile_occupancy``'s M-tile skip):

  - K ≤ ``ROW_K_MAX``: one thread per row keeps Λ's lower triangle and η
    in registers (the accumulate of B2, ``csrc/bmf_common.cuh``); a warp
    writes its rows' Λ through shared memory in coalesced stores. Bound
    on the H100: bytes.
  - ``ROW_K_MAX`` < K ≤ ``K_MAX``: persistent blocks form Λ = τ(w⊙V)ᵀV
    from each row's gathered factor rows on the tensor cores (fp32
    factors as 3xTF32 split products, bf16 as bf16 products) and η on
    the CUDA cores; a producer warp gathers the rows by the TMA, so their
    bytes must be a multiple of 16: the wrapper pads the factor's rows
    with zeros where they are not (bf16 at K = 100: 100 → 104 columns).
    Bound: bytes, mostly Λ's write.

On a CUDA tensor ``precision_accum`` launches the kernel or raises; on a
CPU tensor it runs the plain version (``ref.precision_accum_plain``); on
``meta`` tensors (a dry run's plan, ``launch.bmf_dryrun``) it computes
nothing and returns outputs of the launch's shapes, recording the launch
it stands for (``_plan``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.data.sparse import row_live
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ref import (gather_rows,
                                                   precision_accum_plain,
                                                   precision_accum_ref)

K_MAX = 128
ROW_K_MAX = 16      # one thread per row up to here, the Gram kernel above
_OTHER_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = BUILD.load("bmf_precision")
    fn = lib.bmf_precision_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, p, ctypes.c_longlong, i, i, i, i,
                       i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def as_batched(idx, val, mask, other, live=None):
    """View (N, M) planes / (D, K) factors as a batch of one; check that
    planes and factors agree on the leading block axis."""
    if idx.dim() == 2:
        idx, val, mask, other = idx[None], val[None], mask[None], other[None]
        live = None if live is None else live[None]
    if idx.dim() != 3 or other.dim() != 3:
        raise ValueError(f"expected (B, N, M) planes and (B, D, K) factors, "
                         f"got {tuple(idx.shape)} and {tuple(other.shape)}")
    if val.shape != idx.shape or mask.shape != idx.shape:
        raise ValueError("idx/val/mask shapes differ: "
                         f"{tuple(idx.shape)} {tuple(val.shape)} "
                         f"{tuple(mask.shape)}")
    if other.shape[0] != idx.shape[0]:
        raise ValueError(f"batch of planes {idx.shape[0]} != batch of "
                         f"factors {other.shape[0]}")
    if live is not None and live.shape != idx.shape[:2]:
        raise ValueError(f"live {tuple(live.shape)} != {tuple(idx.shape[:2])}")
    return idx, val, mask, other, live


def check_cuda_operands(named, dtypes):
    """Device, dtype and contiguity checks before pointers go to C."""
    dev = None
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected cuda")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                            f"{dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def precision_accum(idx, val, mask, other, tau: float, live=None):
    """idx/val/mask: padded CSR (N, M) or a stacked (B, N, M); other: the
    other factor (D, K) or (B, D, K), f32 or bf16; live: optional (B, N)
    int32 live lengths (``data.sparse.row_live``; computed when omitted).
    Returns (Lam (…, N, K, K), eta (…, N, K)) f32 likelihood
    contributions."""
    squeeze = idx.dim() == 2
    idx, val, mask, other, live = as_batched(idx, val, mask, other, live)
    if idx.device.type == "cpu":
        with OPT.plain_region("repro_torch::bmf_precision"):
            lam, eta = precision_accum_plain(idx, val, mask, other.float(),
                                             tau, live)
    elif idx.device.type == "meta":
        lam, eta = _plan(idx, val, mask, other,
                         row_live(mask) if live is None else live)
    else:
        lam, eta = _launch(idx, val, mask, other, tau,
                           row_live(mask) if live is None else live)
    return (lam[0], eta[0]) if squeeze else (lam, eta)


precision_accum.launches = 0


def _launch(idx, val, mask, other, tau, live):
    B, N, M = idx.shape
    D, K = other.shape[1:]
    if not 1 <= K <= K_MAX:
        raise ValueError(f"bmf_precision kernel takes 1 <= K <= {K_MAX}, "
                         f"got K={K}")
    if M < 1 or D < 1:
        raise ValueError(f"empty planes or factors: M={M}, D={D}")
    check_cuda_operands(
        dict(idx=idx, val=val, mask=mask, live=live, other=other),
        dict(idx=(torch.int32,), val=(torch.float32,),
             mask=(torch.float32,), live=(torch.int32,),
             other=_OTHER_DTYPES))
    ldo = K
    if K > ROW_K_MAX:
        # the Gram kernel's TMA copies rows of a multiple of 16 bytes
        per = 16 // other.element_size()
        ldo = -(-K // per) * per
        if ldo != K:
            other = torch.nn.functional.pad(other, (0, ldo - K))
    if other.data_ptr() % 16:      # the kernel gathers in 16-byte loads
        other = other.clone()
    lam = torch.empty((B, N, K, K), dtype=torch.float32, device=idx.device)
    eta = torch.empty((B, N, K), dtype=torch.float32, device=idx.device)
    fn = _lib()
    err = fn(idx.data_ptr(), val.data_ptr(), mask.data_ptr(), live.data_ptr(),
             other.data_ptr(), int(other.dtype == torch.bfloat16),
             lam.data_ptr(), eta.data_ptr(), B, N, M, D, K, ldo, float(tau),
             torch.cuda.current_stream(idx.device).cuda_stream)
    BUILD.check(err, "bmf_precision_launch")
    precision_accum.launches += 1
    OPT.note_kernel("repro_torch::bmf_precision",
                    dict(idx=idx, val=val, mask=mask, live=live, other=other),
                    dict(lam=lam, eta=eta))
    return lam, eta


def _plan(idx, val, mask, other, live):
    """The launch on ``meta`` operands: outputs of its shapes and a
    ``note_kernel`` record under the kernel's name, nothing computed and
    no launch counted (``roofline.op_cost`` costs the record)."""
    B, N, _ = idx.shape
    K = other.shape[-1]
    lam = torch.empty((B, N, K, K), dtype=torch.float32, device=idx.device)
    eta = torch.empty((B, N, K), dtype=torch.float32, device=idx.device)
    OPT.note_kernel("repro_torch::bmf_precision",
                    dict(idx=idx, val=val, mask=mask, live=live, other=other),
                    dict(lam=lam, eta=eta))
    return lam, eta


def precision_accum_reference(idx, val, mask, other, tau: float):
    """Dense full-gather oracle — materializes (…, N, M, K); tests only."""
    squeeze = idx.dim() == 2
    idx, val, mask, other, _ = as_batched(idx, val, mask, other)
    lam, eta = precision_accum_ref(gather_rows(other, idx), val, mask, tau)
    return (lam[0], eta[0]) if squeeze else (lam, eta)
