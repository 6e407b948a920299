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
