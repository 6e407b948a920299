"""Plain PyTorch versions of the bmf_precision kernel.

``precision_accum_ref`` is the port of the reference's oracle: given the
gathered factor rows Vg = other[idx] (..., N, M, K), mask and ratings
(..., N, M), it computes

    Lam[n] = tau * sum_m mask[n,m] * Vg[n,m] Vg[n,m]^T     (..., N, K, K)
    eta[n] = tau * sum_m mask[n,m] * val[n,m] * Vg[n,m]    (..., N, K)

``precision_accum_plain`` is what the ops wrapper runs for CPU tensors:
the same function over padded-CSR planes, gathering one row stripe at a
time so no (N, M, K) tensor of the whole plane exists. bf16 factors are
widened to f32 after the gather, as the kernel widens them on load.
"""
from __future__ import annotations

import torch

# elements of one stripe's gathered (rows, M, K) tensor (~64 MB f32)
STRIPE_ELEMS = 1 << 24


def precision_accum_ref(Vg, val, mask, tau: float):
    Vg = Vg.float()
    Vm = Vg * mask[..., None]
    Lam = tau * torch.einsum("...mk,...ml->...kl", Vm, Vg)
    eta = tau * torch.einsum("...m,...mk->...k", val * mask, Vg)
    return Lam, eta


def gather_rows(other: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """other (B, D, K), idx (B, n, M) -> (B, n, M, K)."""
    B, n, M = idx.shape
    flat = idx.reshape(B, n * M, 1).long().expand(B, n * M, other.shape[-1])
    return torch.gather(other, 1, flat).reshape(B, n, M, other.shape[-1])


def stripe_rows(B: int, M: int, K: int) -> int:
    """Rows of one stripe of ``precision_accum_plain`` (the plain version
    works stripe by stripe; its cost per stripe depends on nothing
    else)."""
    return max(1, STRIPE_ELEMS // max(B * M * K, 1))


def precision_accum_plain(idx, val, mask, other, tau: float, live=None):
    """idx/val/mask (B, N, M), other (B, D, K) -> Lam (B, N, K, K), eta
    (B, N, K). ``live`` (B, N) trims each stripe to its longest live row
    (the padded tail contributes exact zeros either way)."""
    B, N, M = idx.shape
    K = other.shape[-1]
    lam = torch.empty((B, N, K, K), dtype=torch.float32, device=idx.device)
    eta = torch.empty((B, N, K), dtype=torch.float32, device=idx.device)
    ns = stripe_rows(B, M, K)
    for lo in range(0, N, ns):
        hi = min(lo + ns, N)
        m = M if live is None else max(int(live[:, lo:hi].max()), 1)
        Vg = gather_rows(other, idx[:, lo:hi, :m].contiguous())
        lam[:, lo:hi], eta[:, lo:hi] = precision_accum_ref(
            Vg, val[:, lo:hi, :m], mask[:, lo:hi, :m], tau)
    return lam, eta
