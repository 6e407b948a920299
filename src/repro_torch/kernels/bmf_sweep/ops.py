"""Wrapper of kernel B2 (``csrc/bmf_sweep.cu``): the whole Gibbs factor
step in one pass.

Replaces the TPU kernel ``src/repro/kernels/bmf_sweep/kernel.py``
(``fused_sweep_padded``, body ``_sweep_kernel``) and its wrappers
``ops.fused_sweep`` / ``ops.sample_factor_fused``.

Bound on the H100: bytes — per row the live CSR slots, their gathered
factor rows, the K×K prior precision and two K-vectors come in and K
floats go out; the O(K³) factorization is small against that traffic.
Up to K = 16 one thread owns one row and keeps Λ's lower
triangle, η and the Cholesky factor in registers; above it, up to
``SWEEP_K_MAX``, one warp owns a row and a lane each column of Λ. Only U
is written (see the source for both designs).

Routes, chosen from what the call can observe:
  - CUDA tensor, K ≤ ``SWEEP_K_MAX``: the B2 kernel;
  - CUDA tensor, K > ``SWEEP_K_MAX``: the B1 kernel for Λ/η, then
    ``cholesky_ex`` / ``solve_triangular`` in torch — what the reference
    runs outside Pallas above its cutoff; B1's launch counter shows it;
  - CPU tensor: the plain version (``ref.sweep_ref_padded``);
  - ``meta`` tensors (a dry run's plan): the CUDA routes' outputs and
    launch records, nothing computed (``_plan``; above ``SWEEP_K_MAX``
    B1's plan and the torch factorization on ``meta``).
Nothing falls back silently from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.core import posterior as POST
from repro_torch.data.sparse import row_live
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision import ops as PREC
from repro_torch.kernels.bmf_sweep.ref import sweep_ref_padded

SWEEP_DTYPES = ("fp32", "bf16")
# one thread per row up to K = 16; one warp per row, one lane per column
# of Λ, up to SWEEP_K_MAX
SWEEP_K_MAX = 32


def _lib():
    fn = BUILD.load("bmf_sweep").bmf_sweep_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, p, p, p, p, ctypes.c_longlong, i, i,
                       i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def fused_sweep(z, idx, val, mask, prior_eta, prior_lam, other, tau: float,
                *, dtype: str = "fp32", jitter: float = 1e-6, live=None):
    """One-pass factor step: U (…, N, K) sampled from the Gibbs
    conditional, given the padded CSR planes (…, N, M), per-row prior
    natural params (…, N, K) / (…, N, K, K), the caller's noise z
    (…, N, K), and the other factor (…, D, K). ``dtype='bf16'`` rounds the
    other factor to bf16 for the gather and accumulate; priors, the
    factorization and the solves stay f32."""
    if dtype not in SWEEP_DTYPES:
        raise ValueError(
            f"sweep dtype must be one of {SWEEP_DTYPES}, got {dtype!r}")
    squeeze = idx.dim() == 2
    if squeeze:
        z, prior_eta, prior_lam = z[None], prior_eta[None], prior_lam[None]
    idx, val, mask, other, live = PREC.as_batched(idx, val, mask, other, live)
    B, N, _ = idx.shape
    K = other.shape[-1]
    for name, t, shape in (("z", z, (B, N, K)), ("prior_eta", prior_eta,
                                                 (B, N, K)),
                           ("prior_lam", prior_lam, (B, N, K, K))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    other = other.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    if idx.device.type == "cpu":
        with OPT.plain_region("repro_torch::bmf_sweep"):
            U = sweep_ref_padded(idx, val, mask, prior_eta, prior_lam, z,
                                 other, tau, jitter=jitter, live=live)
    elif idx.device.type == "meta" and K <= SWEEP_K_MAX:
        U = _plan(z, idx, val, mask, prior_eta, prior_lam, other,
                  row_live(mask) if live is None else live)
    elif K > SWEEP_K_MAX:
        lam, eta = PREC.precision_accum(idx, val, mask, other, tau, live)
        U = POST.sample_rows_noise(
            POST.RowGaussians(eta=prior_eta + eta, Lambda=prior_lam + lam),
            z, jitter)
    else:
        U = _launch(z, idx, val, mask, prior_eta, prior_lam, other, tau,
                    jitter, row_live(mask) if live is None else live)
    return U[0] if squeeze else U


fused_sweep.launches = 0


def _launch(z, idx, val, mask, prior_eta, prior_lam, other, tau, jitter,
            live):
    B, N, M = idx.shape
    D, K = other.shape[1:]
    if M < 1 or D < 1:
        raise ValueError(f"empty planes or factors: M={M}, D={D}")
    f32 = (torch.float32,)
    PREC.check_cuda_operands(
        dict(idx=idx, val=val, mask=mask, live=live, other=other,
             prior_eta=prior_eta, prior_lam=prior_lam, z=z),
        dict(idx=(torch.int32,), val=f32, mask=f32, live=(torch.int32,),
             other=(torch.float32, torch.bfloat16), prior_eta=f32,
             prior_lam=f32, z=f32))
    if other.data_ptr() % 16:      # the kernel gathers in 16-byte loads
        other = other.clone()
    U = torch.empty((B, N, K), dtype=torch.float32, device=idx.device)
    err = _lib()(idx.data_ptr(), val.data_ptr(), mask.data_ptr(),
                 live.data_ptr(), other.data_ptr(),
                 int(other.dtype == torch.bfloat16), prior_eta.data_ptr(),
                 prior_lam.data_ptr(), z.data_ptr(), U.data_ptr(), B, N, M,
                 D, K, float(tau), float(jitter),
                 torch.cuda.current_stream(idx.device).cuda_stream)
    BUILD.check(err, "bmf_sweep_launch")
    fused_sweep.launches += 1
    OPT.note_kernel("repro_torch::bmf_sweep",
                    dict(idx=idx, val=val, mask=mask, live=live, other=other,
                         prior_eta=prior_eta, prior_lam=prior_lam, z=z),
                    dict(U=U))
    return U


def _plan(z, idx, val, mask, prior_eta, prior_lam, other, live):
    """The launch on ``meta`` operands: U of its shape and a
    ``note_kernel`` record under the kernel's name, nothing computed and
    no launch counted (``roofline.op_cost`` costs the record)."""
    U = torch.empty(z.shape, dtype=torch.float32, device=idx.device)
    OPT.note_kernel("repro_torch::bmf_sweep",
                    dict(idx=idx, val=val, mask=mask, live=live, other=other,
                         prior_eta=prior_eta, prior_lam=prior_lam, z=z),
                    dict(U=U))
    return U


def sample_factor_fused(z, csr, other, tau: float, prior, *,
                        dtype: str = "fp32", jitter: float = 1e-6,
                        live=None):
    """Drop-in for ``bmf.sample_factor`` with the noise ``z`` supplied:
    one fused pass instead of sufficient stats -> Cholesky -> sample."""
    return fused_sweep(z, csr.idx, csr.val, csr.mask,
                       prior.eta.contiguous(), prior.Lambda.contiguous(),
                       other, tau, dtype=dtype, jitter=jitter, live=live)


def trace_sweep(K: int, n_rows: int, m_rows: int, n_other: int, *,
                dtype: str = "fp32", device=None):
    """Analyzer hook (``launch.bmf_lint``), shaped like
    ``gibbs.trace_chain``: one ``fused_sweep`` factor step on seeded
    random inputs at these dims, under the op recorder — B2's launch on a
    CUDA device, its plain version on the CPU."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.core.gibbs import TracedChain, lint_inputs
    dev = resolve_device(device)
    inp = lint_inputs(0, 1, n_rows, n_other, m_rows, n_rows, 1, K, dev)
    rng = np.random.default_rng(1)
    z, other = (torch.from_numpy(rng.normal(size=(n, K)).astype(np.float32))
                .to(dev) for n in (n_rows, n_other))
    with OPT.record() as tr:
        fused_sweep(z, inp.rows.idx[0], inp.rows.val[0], inp.rows.mask[0],
                    inp.U_prior.eta[0], inp.U_prior.Lambda[0], other, 2.0,
                    dtype=dtype)
    return TracedChain(ops=tr.ops, collectives=[], sweeps=1)
