"""Op-trace passes: materialization budget, dtype promotion, host
callbacks (port of ``repro.analysis.jaxpr_passes``). All three walk every
op a call ran (``optrace``), the kernels' launches and their plain
versions' ops included: a materialized (N, M, K) tensor inside a sweep is
exactly the bug class they exist to catch."""
from __future__ import annotations

from typing import List

from repro_torch.analysis.registry import OpArtifact, Pass, Violation, register


def materialization_budget(n_rows: int, n_cols: int, m_rows: int,
                           m_cols: int, K: int, batch: int = 1,
                           slack: float = 2.0) -> int:
    """Largest buffer a fused block chain legitimately holds, from block
    dims: the per-observation factor gathers on the padded CSR planes
    (B*n*m*K f32 — U[idx] per plane slot) and the per-row outer-product
    accumulators (B*n*K*K f32), whichever is bigger, times ``slack`` for
    layout/padding headroom. The naive sufficient-stats formulation
    materializes the DENSE (N_block, M_block, K) factor tensor instead —
    a factor M_block/m_pad over the plane gather, so it trips the pass
    whenever the block is meaningfully sparse."""
    plane = max(n_rows * m_rows, n_cols * m_cols) * K
    outer = max(n_rows, n_cols) * K * K
    return int(slack * 4 * batch * max(plane, outer))


def _materialization(art: OpArtifact) -> List[Violation]:
    if art.bytes_budget is None:
        return []
    seen = set()
    out = []
    for o in art.ops:
        for dt, shape, nb in o.new:
            if nb <= art.bytes_budget or (dt, shape) in seen:
                continue
            seen.add((dt, shape))
            out.append(Violation(
                "materialization", art.label,
                f"{o.op} allocates {dt}{list(shape)}: {nb} bytes, over the "
                f"{art.bytes_budget}-byte block budget",
                "a gathered/broadcast intermediate is being materialized — "
                "route the sufficient-stats accumulation through kernel B1 "
                "or B2 (or their plain versions' row stripes) so no buffer "
                "exceeds the padded CSR plane's gather"))
    return out


register(Pass(
    "materialization", "ops",
    "no new buffer anywhere in the op trace exceeds the block-dim byte "
    "budget — the no-(N,M,K)-tensor invariant",
    _materialization))


# fp32-required linear algebra: the Cholesky factor/solve path of the
# posterior update loses PD-ness in half precision. ``sqrt`` is the
# Cholesky diagonal. B2 factors inside the kernel, so its launch is checked
# by operand name: the prior and the noise it factors and solves with must
# be f32; only the gathered ``other`` factor may be bf16.
_FP32_REQUIRED = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular",
                  "aten::cholesky_solve", "aten::sqrt")
_KERNEL_FP32 = {"repro_torch::bmf_sweep": ("prior_eta", "prior_lam", "z")}
_LOW_PRECISION = ("bfloat16", "float16")


def _dtype_promotion(art: OpArtifact) -> List[Violation]:
    out = []
    seen = set()
    for o in art.ops:
        if not art.allow_f64:
            for t in o.operands + o.outputs:
                if t.dtype != "float64" or t.shape in seen:
                    continue
                seen.add(t.shape)
                out.append(Violation(
                    "dtype-promotion", art.label,
                    f"silent f64 upcast: {o.op} sees float64{list(t.shape)}",
                    "a host-side numpy float64 leaked into the chain — cast "
                    "inputs to float32 at the data layer (or mark the "
                    "artifact allow_f64 if the upcast is deliberate)"))
        if o.op in _FP32_REQUIRED:
            names = None                    # every operand
        elif o.op in _KERNEL_FP32:
            names = _KERNEL_FP32[o.op]
        else:
            continue
        for t in o.operands:
            if t.dtype in _LOW_PRECISION and (names is None
                                              or t.name in names):
                out.append(Violation(
                    "dtype-promotion", art.label,
                    f"{o.op} sees {t.dtype} operand {t.name!r} "
                    f"{list(t.shape)} — the posterior factor/solve path "
                    f"requires fp32",
                    "keep mixed precision on the gather/accumulate side "
                    "only: widen the Lambda accumulator (and the prior and "
                    "noise) to float32 before the factorization"))
    return out


register(Pass(
    "dtype-promotion", "ops",
    "no silent f64 upcast; Cholesky/triangular-solve/cholesky-solve/sqrt "
    "operands, and B2's prior and noise, are never bf16/f16",
    _dtype_promotion))


# ops that read device data back to the host: inside a chain each one
# stops the host until the device's queue drains. Indexing by a boolean
# mask sizes its result (or its writes) by the mask's count, read back.
_HOST_READS = frozenset({"aten::_local_scalar_dense", "aten::item",
                         "aten::nonzero", "aten::masked_select"})
_MASK_INDEX = frozenset({"aten::index", "aten::index_put",
                         "aten::index_put_"})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})


def _host_callback(art: OpArtifact) -> List[Violation]:
    out = []
    for o in art.ops:
        if o.plain is not None:
            # a kernel's plain version (CPU route): on the card this region
            # is one launch, which reads nothing back
            continue
        if o.op in _HOST_READS:
            what = f"host read {o.op!r}"
        elif o.op in _MASK_INDEX and any(
                t.name.startswith("indices") and t.dtype in ("bool", "uint8")
                for t in o.operands):
            what = f"boolean-mask {o.op!r}"
        elif (o.op in _COPIES
              and any(t.device == "cuda" for t in o.operands)
              and any(t.device == "cpu" for t in o.outputs)):
            what = f"device-to-host copy {o.op!r}"
        else:
            continue
        out.append(Violation(
            "host-callback", art.label,
            f"{what} inside a traced chain "
            f"({', '.join(f'{t.device} {t.name}' for t in o.operands)})",
            "phase chains must stay device-resident end to end "
            "(guards.no_host_transfers is the runtime twin of this check) "
            "— keep the value on the device (torch.where, a device scalar) "
            "or move the read outside the chain"))
    return out


register(Pass(
    "host-callback", "ops",
    "no host read (.item(), nonzero, masked_select, boolean-mask "
    "indexing) or device-to-host copy inside a traced chain",
    _host_callback))
