"""Roofline terms on an NVIDIA H100 (port of ``repro.roofline.analysis``).

Three terms (seconds), per device:

    compute    = Σ over precisions: flops of that precision / its peak
    memory     = bytes / HBM rate
    collective = collective bytes / NVLink rate (one direction)

The peaks are NVIDIA's data sheet for the H100 SXM, dense (no sparsity),
at its 700 W power limit; a card set below that limit runs slower under
load, so a measured time stands beside the card's name and limit. The
reference uses one TPU v5e bf16 peak for all work; the port picks the
peak by the work's precision, as the kernels run it:

  - ``fp32``: the CUDA cores. The port sets ``allow_tf32 = False``
    (``repro_torch.resolve_device``), so a plain fp32 matmul counts here;
  - ``tf32``: the tensor cores' TF32 rate. Kernel B1's Gram kernel above
    K = 16 forms an fp32 product as 3 TF32 products (hi + lo split);
  - ``bf16``: the tensor cores' bf16 rate (B1's Gram kernel on bf16
    factors).

FLOPs and bytes come from the op traces (``roofline.op_cost``): the
global work of what ran, divided by the devices. Collectives come from
what a ``core.topology.Group`` was asked for (``record_collectives``).
The reference recovers both from compiled HLO text with a computation
call-graph walk (``_split_computations``, ``_while_trip_count``,
``collective_bytes_graph``, ``collective_replica_groups``); the port
records each call with its group and part shapes, so none of that walk
has a counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

# H100 SXM, NVIDIA data sheet, dense, at the 700 W power limit
HBM_BW = 3.35e12                 # B/s
PEAK_FLOPS = {
    "fp32": 67e12,               # CUDA cores
    "tf32": 495e12,              # tensor cores
    "bf16": 989e12,              # tensor cores
}
NVLINK_BW = 450e9                # B/s each way (NVLink 4, 900 GB/s both)
HBM_CAPACITY = 80e9              # bytes of device memory

# the reference's collective kinds, in its order, and the port's
# ``Group`` methods under them; ``broadcast`` (V copied to a group's
# slots every U-step) has no counterpart in the reference's shard_map,
# which gets V replicated, so it keeps a kind of its own
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast")
KIND_OF = {"all_gather": "all-gather", "psum": "all-reduce",
           "psum_scatter": "reduce-scatter", "broadcast": "broadcast"}

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "uint16": 2,
    "bfloat16": 2, "float16": 2, "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def dtype_bytes(dtype: str) -> int:
    """Bytes of one element of a dtype named as ``optrace`` names it
    (``"float32"``)."""
    return _DTYPE_BYTES[dtype]


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# collectives (core.topology.CollectiveCall)
# ---------------------------------------------------------------------------


def call_bytes(call) -> int:
    """Bytes one call delivers to each slot of its group, as the
    reference counts an HLO collective by its per-device result:
    ``all_gather`` the concatenated parts, ``psum`` one part,
    ``psum_scatter`` one tile of the sum, ``broadcast`` the tensor, at
    the parts' dtype (f32 where the call carries none)."""
    elt = dtype_bytes(call.dtypes[0] if getattr(call, "dtypes", ())
                      else "float32")
    parts = [_numel(s) for s in call.shapes]
    if call.op == "all_gather":
        return elt * sum(parts)
    if call.op == "psum_scatter":
        return elt * parts[0] // max(len(call.devices), 1)
    return elt * parts[0]


def collective_counts(calls: Iterable) -> Dict[str, int]:
    """Calls per reference kind (zero-count kinds omitted)."""
    counts: Dict[str, int] = {}
    for c in calls:
        k = KIND_OF[c.op]
        counts[k] = counts.get(k, 0) + 1
    return counts


def collective_bytes(calls: Iterable) -> Dict[str, float]:
    """Bytes per slot by reference kind, plus ``n_<kind>`` call counts —
    the reference's record keys, with ``broadcast`` beside them."""
    calls = list(calls)
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    for c in calls:
        out[KIND_OF[c.op]] += call_bytes(c)
    counts = collective_counts(calls)
    out.update({f"n_{k}": counts.get(k, 0) for k in COLLECTIVE_KINDS})
    return out


def collectives_confined_to_groups(calls: Iterable,
                                   allowed_groups) -> Dict:
    """Check that every call runs over one allowed group — ``(index,
    devices)`` pairs, e.g. ``[(g, topo.group(g)) ...]``: a call is
    confined when its group index and slot devices are one allowed
    group's. Returns ``{"n_collectives", "n_confined", "n_crossing",
    "crossing"}``; for a composed PP chain ``crossing`` must be empty
    (nothing reduces over the 'block' axis)."""
    allowed = {(int(g), tuple(str(d) for d in devs))
               for g, devs in allowed_groups}
    crossing, n = [], 0
    for c in calls:
        n += 1
        if (int(c.group), tuple(c.devices)) not in allowed:
            crossing.append((KIND_OF[c.op], c.group, list(c.devices)))
    return {"n_collectives": n, "n_crossing": len(crossing),
            "n_confined": n - len(crossing), "crossing": crossing}


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclass
class RooflineTerms:
    flops: float          # per device, counted as the plain versions do
    hbm_bytes: float      # per device
    coll_bytes: float     # per device
    # flops by the precision that runs them (keys of PEAK_FLOPS); by
    # default all of ``flops`` on the CUDA cores
    flops_by_rate: Optional[Mapping[str, float]] = None
    compute_s: float = field(init=False)
    memory_s: float = field(init=False)
    collective_s: float = field(init=False)

    def __post_init__(self):
        rates = (dict(self.flops_by_rate) if self.flops_by_rate is not None
                 else {"fp32": self.flops})
        self.flops_by_rate = rates
        self.compute_s = sum(f / PEAK_FLOPS[k] for k, f in rates.items())
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bound_s(self) -> float:
        """The least time: the larger of the compute and memory terms
        (the kernels' ``bound_ms`` in ``chip_smoke.py``)."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.memory_s >= self.compute_s else "operations"

    def as_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "compute_s": self.compute_s,
            "memory_s": self.memory_s, "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops_per_step(n_params_active: int, tokens: int,
                         kind: str) -> float:
    """6ND for train (fwd+bwd), 2ND for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def flops_by_rate(costs: Mapping[str, float]) -> Dict[str, float]:
    """``op_cost``'s flops split by the precision that runs them: the
    tensor-core operations under their rates, the rest on the CUDA
    cores."""
    return {"fp32": costs.get("fp32_flops", costs["flops"]),
            "tf32": costs.get("tf32_flops", 0.0),
            "bf16": costs.get("bf16_flops", 0.0)}


def terms_from(costs: Mapping[str, float], collectives: Iterable = (),
               n_devices: int = 1, coll_mult: int = 1) -> RooflineTerms:
    """Combine global op-trace costs (÷ devices) with the recorded
    collectives' bytes per slot (× ``coll_mult``, the sweeps they stand
    for).

    The memory term uses ``bytes_min`` (matmul, gather and kernel
    operand + result traffic: the fused ideal); ``bytes`` (unfused upper
    bound) stays in the costs beside it."""
    coll = sum(call_bytes(c) for c in collectives) * coll_mult
    n = max(int(n_devices), 1)
    return RooflineTerms(
        flops=costs["flops"] / n, hbm_bytes=costs["bytes_min"] / n,
        coll_bytes=float(coll),
        flops_by_rate={k: v / n for k, v in flops_by_rate(costs).items()})


def bound(n_bytes: float, flops: float, rate: str = "fp32"
          ) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for work that moves
    ``n_bytes`` and does ``flops`` at the ``rate`` precision's peak."""
    t = RooflineTerms(flops=flops, hbm_bytes=n_bytes, coll_bytes=0.0,
                      flops_by_rate={rate: flops})
    return 1e3 * t.bound_s, t.bound_by
