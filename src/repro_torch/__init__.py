"""PyTorch/CUDA port of the BMF + Posterior Propagation system.

The JAX package ``repro`` is the reference; this package keeps its module
names (``data``, ``core``, ``kernels``, ``launch``) so each counterpart is
easy to find. It imports ``torch`` and numpy only — never ``jax`` and
never ``repro``.

Entry points (``core.gibbs.run_gibbs`` / ``run_gibbs_stacked``,
``core.pp.run_pp`` / ``run_full_bmf``, ``launch.bmf_train``) run on the GPU
unless the caller passes ``device="cpu"``; with no GPU they raise instead
of carrying on on the CPU (``resolve_device``).
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA request without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and found none; "
                "pass device='cpu' to run the plain PyTorch versions")
        # the JAX reference is fp32 throughout: TF32 would keep ~3 decimal
        # digits in matmuls/convolutions and break parity with it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def host_tensor(arr, dev) -> torch.Tensor:
    """``arr`` as a CPU tensor ready for a copy to ``dev``: on a CUDA
    device a pinned buffer from the caching host allocator (which keeps it
    until the copies that read it are done), else the array itself."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(dev).type != "cuda":
        return src
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    return pinned.copy_(src)


def to_device(arr, dev) -> torch.Tensor:
    """A host array on ``dev`` without blocking the host: a CUDA copy is
    non-blocking from pinned memory, so a caller that enqueues work for
    the card never waits for the card to drain."""
    return host_tensor(arr, dev).to(dev, non_blocking=True)
