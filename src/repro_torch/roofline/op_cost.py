"""Op-trace cost model (the counterpart of ``repro.roofline.jaxpr_cost``).

Where the reference walks a jaxpr, the port costs what ran: the
``analysis.optrace.OpRecord`` list of one call (``optrace.record``), on
any device — on ``meta`` a dry run's plan at full size costs nothing to
record. The rules are ``jaxpr_cost``'s:

  - the matmul family (``mm``, ``bmm``, ``mv``, ``dot``, ``addmm``,
    ``baddbmm``; ``matmul`` and ``einsum`` reach these after views):
    2·M·N·K in ``flops`` and ``dot_flops``, operands and result in
    ``bytes`` and ``bytes_min``;
  - the gather and scatter family (``gather``, ``index``, ``scatter``,
    ``index_put``, …, and ``copy_`` / ``clone``, the port's slice write
    and materialized slice, the reference's ``dynamic_update_slice`` /
    ``dynamic_slice``): twice the output's bytes, no flops;
  - views, allocations (``empty``) and host reads of a scalar: nothing;
  - any other op: its output's elements as ``elem_flops`` (and
    ``flops``), its operands and outputs in ``bytes`` (not
    ``bytes_min``: fused away in the ideal).

A hand-written kernel's launch (a ``note_kernel`` record of B1, B2, or of
the attention kernels L1, L2, L3 and the scans L4, L5,
``shape_kernel_cost``) is the counterpart of the reference's
``pallas_call`` branch:

  - its flops are those of the kernel's PLAIN version at the same shapes
    (``ref.precision_accum_plain``, ``ref.sweep_ref_padded``), counted by
    tracing that version on ``meta`` and cached per shape — so a roofline
    counts the same work whether the kernel, the plain version or a later
    redesign runs it;
  - its ``bytes`` and ``bytes_min`` are its operands read once and its
    outputs written once (``PERF.md``'s bounds), the padded-CSR planes
    (idx, val, mask) at the live slots where the caller knows them
    (``live_slots``), else at every slot;
  - B1's Gram kernel above K = 16, L1 and L2 run their products on the
    tensor cores: their matmul flops go to ``tf32_flops`` three times over
    (f32 operands, hi + lo split) or to ``bf16_flops`` (bf16 operands).

Besides the reference's keys (``flops``, ``bytes``, ``bytes_min``,
``dot_flops``, ``elem_flops``) a cost holds ``fp32_flops``,
``tf32_flops`` and ``bf16_flops``: the operations by the precision that
runs them (``roofline.analysis.flops_by_rate``). Costs are global;
``analysis.terms_from`` divides them by the devices.

``peak_buffer_bytes`` stands in for XLA's ``memory_analysis`` and for the
reference's ``peak_buffer_bytes`` (which fails on JAX 0.9): the live
bytes' high-water mark of a trace, from each new storage's allocation to
its death (``OpTrace.frees``), the caller's inputs live throughout.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.roofline.analysis import dtype_bytes

KEYS = ("flops", "bytes", "bytes_min", "dot_flops", "elem_flops",
        "fp32_flops", "tf32_flops", "bf16_flops")

# matmul op -> the operand whose last dim is the contracted K
MATMUL_K = {"aten::mm": "self", "aten::bmm": "self", "aten::mv": "self",
            "aten::dot": "self", "aten::vdot": "self",
            "aten::addmm": "mat1", "aten::baddbmm": "batch1",
            "aten::addmv": "mat"}
MOVES = {"aten::gather", "aten::index", "aten::index_select", "aten::take",
         "aten::embedding", "aten::scatter", "aten::scatter_add",
         "aten::scatter_reduce", "aten::index_put", "aten::index_put_",
         "aten::_index_put_impl_", "aten::index_add", "aten::index_copy",
         "aten::slice_scatter", "aten::select_scatter", "aten::copy_",
         "aten::clone"}
FREE = {"aten::empty", "aten::empty_like", "aten::empty_strided",
        "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
        "aten::_unsafe_view", "aten::_reshape_alias", "aten::lift_fresh",
        "aten::_local_scalar_dense", "aten::set_", "aten::detach"}
_HALF = ("bfloat16", "float16")


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _nbytes(t: OPT.TensorMeta) -> int:
    return _numel(t.shape) * dtype_bytes(t.dtype)


def zero() -> Dict[str, float]:
    return {k: 0.0 for k in KEYS}


def _add(total, part, mult=1.0):
    for k in KEYS:
        total[k] += mult * part.get(k, 0.0)


def _op(o: OPT.OpRecord) -> Dict[str, float]:
    """One aten op's cost by the rules above."""
    c = zero()
    if o.view or o.op in FREE:
        return c
    ins = [t for t in o.operands if not t.name.startswith("out")]
    io = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in o.outputs)
    if o.op in MATMUL_K:
        k_from = next((t for t in o.operands if t.name == MATMUL_K[o.op]),
                      None)
        k = int(k_from.shape[-1]) if k_from is not None and k_from.shape \
            else 1
        f = 2.0 * sum(_numel(t.shape) for t in o.outputs) * k
        rate = "bf16_flops" if k_from is not None and \
            k_from.dtype in _HALF else "fp32_flops"
        c.update(flops=f, dot_flops=f, bytes=io, bytes_min=io)
        c[rate] = f
    elif o.op in MOVES:
        b = 2.0 * sum(_nbytes(t) for t in o.outputs)
        c.update(bytes=b, bytes_min=b)
    else:
        n = float(sum(_numel(t.shape) for t in o.outputs))
        c.update(flops=n, elem_flops=n, fp32_flops=n, bytes=io)
    return c


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_PLANES = ("idx", "val", "mask")     # read at the live slots only
_PLAIN_CACHE: Dict[tuple, Dict[str, float]] = {}


def _plain_b1(t, live):
    from repro_torch.kernels.bmf_precision.ref import precision_accum_plain
    K = t["lam"].shape[-1]
    precision_accum_plain(t["idx"], t["val"], t["mask"],
                          t["other"][..., :K].float(), 2.0, live)


def _stripe_b1(B, M, K):
    from repro_torch.kernels.bmf_precision.ref import stripe_rows
    return stripe_rows(B, M, K)


def _plain_b2(t, live):
    from repro_torch.kernels.bmf_sweep.ref import sweep_ref_padded
    sweep_ref_padded(t["idx"], t["val"], t["mask"], t["prior_eta"],
                     t["prior_lam"], t["z"], t["other"], 2.0, live=live)


def _stripe_b2(B, M, K):
    from repro_torch.kernels.bmf_sweep.ref import stripe_rows
    return stripe_rows(B, M, K)


def _b1_tensor_cores(rec) -> Optional[str]:
    """B1's Gram kernel (K > ROW_K_MAX) forms Λ on the tensor cores:
    'tf32' (3 products each) for fp32 factors, 'bf16' for bf16."""
    from repro_torch.kernels.bmf_precision.ops import ROW_K_MAX
    out = {t.name: t for t in rec.outputs}
    if out["lam"].shape[-1] <= ROW_K_MAX:
        return None
    other = next(t for t in rec.operands if t.name == "other")
    return "bf16" if other.dtype == "bfloat16" else "tf32"


# kernel record name -> (plain version on named meta tensors, rows of
# one of its stripes, tensor-core precision of its matmuls or None)
KERNELS = {
    "repro_torch::bmf_precision": (_plain_b1, _stripe_b1, _b1_tensor_cores),
    "repro_torch::bmf_sweep": (_plain_b2, _stripe_b2, lambda rec: None),
}
# operands and outputs with a row axis (second): a stripe's share of them
_ROWS = ("idx", "val", "mask", "live", "prior_eta", "prior_lam", "z", "lam",
         "eta", "U")


def _trace_plain(rec: OPT.OpRecord, m: int, n: int) -> Dict[str, float]:
    """Cost of the kernel's plain version at the record's shapes with
    ``n`` rows of ``m`` slots each (traced on ``meta``, cached)."""
    key = (rec.op, tuple((t.name, t.dtype, t.shape) for t in rec.operands),
           tuple((t.name, t.dtype, t.shape) for t in rec.outputs), m, n)
    if key not in _PLAIN_CACHE:
        def shape(x):
            s = list(x.shape)
            if x.name in _ROWS:
                s[1] = n
            if x.name in _PLANES:
                s[-1] = m
            return tuple(s)

        t = {x.name: torch.empty(shape(x), dtype=getattr(torch, x.dtype),
                                 device="meta")
             for x in rec.operands + rec.outputs}
        # every row full: the plain versions' host-side stripe trims (a
        # reduction over the live lengths on the host) keep every slot
        live = torch.full((t["idx"].shape[0], n), m, dtype=torch.int32)
        with OPT.record() as tr:
            KERNELS[rec.op][0](t, live)
        _PLAIN_CACHE[key] = op_cost(tr.ops)
    return _PLAIN_CACHE[key]


def _plain_cost(rec: OPT.OpRecord, m: int) -> Dict[str, float]:
    """Cost of the kernel's plain version at the record's shapes with
    ``m`` slots in every row. The plain versions work a row stripe at a
    time and a stripe's cost depends on its rows only, so one whole
    stripe and the last partial one are traced and the whole stripes
    counted (a plan at the Netflix shape has ~1,200 of them)."""
    B, N = rec.operands[0].shape[:2]
    K = rec.outputs[-1].shape[-1]          # eta / U: (B, N, K)
    ns = min(KERNELS[rec.op][1](B, m, K), N)
    whole, rest = divmod(N, ns)
    c = zero()
    _add(c, _trace_plain(rec, m, ns), whole)
    if rest:
        _add(c, _trace_plain(rec, m, rest))
    return c


def _plain_l1(t):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    flash_attention_ref(t["q"], t["k"], t["v"], return_lse="lse" in t)


def _plain_l2(t):
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    flash_bwd_ref(t["q"], t["k"], t["v"], t["o"], t["do"], t["lse"])


def _plain_l3(t):
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    decode_attention_ref(t["q"], t["k"], t["v"], t["kv_pos"], 0)


def _plain_l4(t):
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunked
    ssd_chunked(t["xdt"], t["a"], t["B"], t["C"], t["state0"])


def _plain_l5(t):
    from repro_torch.kernels.wkv6.ref import wkv_chunked
    wkv_chunked(t["r"], t["k"], t["v"], t["logw"], t["u"], t["state0"])


# the attention kernels (L1, L2, L3) and the scans (L4, L5): kernel record
# name -> plain version on named meta tensors; their cost depends on the
# shapes only
SHAPE_KERNELS = {
    "repro_torch::flash_attention": _plain_l1,
    "repro_torch::flash_attention_bwd": _plain_l2,
    "repro_torch::decode_attention": _plain_l3,
    "repro_torch::ssd_chunk": _plain_l4,
    "repro_torch::wkv6": _plain_l5,
}


# the attention kernels whose products run on the tensor cores in either
# dtype (L1, L2)
_TENSOR_CORE_KERNELS = ("repro_torch::flash_attention",
                        "repro_torch::flash_attention_bwd")


def shape_kernel_cost(rec: OPT.OpRecord) -> Dict[str, float]:
    """Cost of one L1-L5 launch record: the flops of the kernel's plain
    version at the record's shapes (traced on ``meta``, cached), the
    matrix products of L1 and L2 on the tensor cores (bf16 q: one bf16
    product each, the sm90 kernels; f32 q: three TF32 products each, the
    3xTF32 kernels, as B1's Gram kernel), L3's (a bf16 cache read into
    f32 products on the CUDA cores) and L4's and L5's (f32 operands) at
    the f32 rate, and its operands read once and its outputs written
    once."""
    key = (rec.op, tuple((t.name, t.dtype, t.shape) for t in rec.operands),
           tuple((t.name, t.dtype, t.shape) for t in rec.outputs))
    if key not in _PLAIN_CACHE:
        t = {x.name: torch.empty(x.shape, dtype=getattr(torch, x.dtype),
                                 device="meta")
             for x in rec.operands + rec.outputs}
        with OPT.record() as tr:
            SHAPE_KERNELS[rec.op](t)
        c = op_cost(tr.ops)
        io = sum(_nbytes(x) for x in rec.operands + rec.outputs)
        c["bytes"] = c["bytes_min"] = float(io)
        q = rec.operands[0]
        c["tf32_flops"] = c["bf16_flops"] = 0.0
        if rec.op in _TENSOR_CORE_KERNELS:
            c["fp32_flops"] = c["flops"] - c["dot_flops"]
            if q.dtype == "bfloat16":
                c["bf16_flops"] = c["dot_flops"]
            else:
                c["tf32_flops"] = 3 * c["dot_flops"]
        else:
            c["fp32_flops"] = c["flops"]
        _PLAIN_CACHE[key] = c
    return dict(_PLAIN_CACHE[key])


def kernel_cost(rec: OPT.OpRecord,
                live_slots: Optional[float] = None) -> Dict[str, float]:
    """Cost of one B1/B2 launch record (module docstring); an attention
    kernel's or a scan's record goes to ``shape_kernel_cost``.
    ``live_slots``:
    the live CSR slots the launch reads (data-dependent; a caller holding
    the planes counts them, ``int(live.sum())``), default every slot. The
    plain version's flops are taken at the mean live row length,
    interpolated between the two whole lengths around it."""
    if rec.op in SHAPE_KERNELS:
        return shape_kernel_cost(rec)
    if rec.op not in KERNELS:
        raise KeyError(f"no cost rule for kernel {rec.op!r} "
                       f"(known: {sorted(KERNELS)})")
    ops = {t.name: t for t in rec.operands}
    B, N, M = ops["idx"].shape
    slots = float(B * N * M) if live_slots is None else float(live_slots)
    m_eff = min(max(slots / max(B * N, 1), 1.0), float(M))
    lo = int(math.floor(m_eff))
    c = dict(_plain_cost(rec, lo))
    if m_eff > lo:
        hi = _plain_cost(rec, lo + 1)
        for k in KEYS:
            c[k] += (m_eff - lo) * (hi[k] - c[k])
    io = sum(dtype_bytes(t.dtype) * slots if t.name in _PLANES
             else _nbytes(t) for t in rec.operands)
    io += sum(_nbytes(t) for t in rec.outputs)
    c["bytes"] = c["bytes_min"] = float(io)
    rate = KERNELS[rec.op][2](rec)
    c["tf32_flops"] = c["bf16_flops"] = 0.0
    if rate is None:
        c["fp32_flops"] = c["flops"]
    else:
        c["fp32_flops"] = c["flops"] - c["dot_flops"]
        c[f"{rate}_flops"] = c["dot_flops"] * (3 if rate == "tf32" else 1)
    return c


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def op_cost(ops: Iterable[OPT.OpRecord], mult: float = 1,
            live_slots: Optional[float] = None) -> Dict[str, float]:
    """Summed cost of an op trace (module docstring), times ``mult``
    (e.g. a chain's sweeps when one sweep was traced). ``live_slots``
    applies to every kernel launch in ``ops`` (``kernel_cost``): give it
    only for a trace of one launch, or of launches on the same planes."""
    total = zero()
    for o in ops:
        _add(total, kernel_cost(o, live_slots) if o.kernel else _op(o),
             mult)
    return total


def _storages(tensors, device: Optional[str]):
    seen = {}
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        if device is not None and t.device.type != device:
            continue
        st = OPT.storage_of(t)
        if st is not None:
            seen[st._cdata] = st.nbytes()
    return seen


def storage_bytes(tensors: Iterable, device: Optional[str] = None) -> int:
    """Bytes of the distinct storages of ``tensors`` (on ``device``)."""
    return sum(_storages(tensors, device).values())


def alias_bytes(inputs: Iterable, outputs: Iterable,
                device: Optional[str] = None) -> int:
    """Bytes of the input storages that an output lives in — the port's
    counterpart of XLA's aliased (donated) input bytes."""
    ins = _storages(inputs, device)
    outs = _storages(outputs, device)
    return sum(nb for k, nb in ins.items() if k in outs)


def peak_buffer_bytes(trace, inputs: Iterable = (),
                      device: Optional[str] = None) -> int:
    """The live-bytes high-water mark of a trace (an ``OpTrace``; a bare
    list of ops, which has no frees, keeps every buffer to the end): the
    distinct storages of ``inputs`` live throughout, each storage an op
    allocated from that op to its death. ``device`` (a device type)
    counts only storages there — a dry run's host-side draws are not
    device memory."""
    ops: List[OPT.OpRecord] = list(getattr(trace, "ops", trace))
    frees = sorted(getattr(trace, "frees", ()))
    live = storage_bytes(inputs, device)
    peak, sizes, fi = live, {}, 0
    for i, o in enumerate(ops):
        while fi < len(frees) and frees[fi][0] <= i:
            live -= sizes.pop(frees[fi][1], 0)
            fi += 1
        for (_, _, nb), (key, dev) in zip(o.new, o.new_keys):
            if device is None or dev == device:
                live += nb
                sizes[key] = nb
        peak = max(peak, live)
    return int(peak)


def traced_cost(fn, *args, mult: float = 1,
                live_slots: Optional[float] = None) -> Dict[str, float]:
    """Cost of one call ``fn(*args)`` (run under the op recorder), with
    its ``peak_bytes`` (``peak_buffer_bytes``, the tensor arguments
    counted as live)."""
    with OPT.record() as tr:
        fn(*args)
    out = op_cost(tr.ops, mult, live_slots)
    out["peak_bytes"] = float(peak_buffer_bytes(tr, args))
    return out
