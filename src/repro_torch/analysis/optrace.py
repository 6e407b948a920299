"""Op traces: what one call of a function runs (the counterpart of the
reference's ``roofline.jaxpr_cost.iter_avals`` / ``iter_eqns``).

Where the reference traces a program at abstract shapes and walks its
jaxpr, the port runs the call once on real tensors under a
``TorchDispatchMode`` and keeps one ``OpRecord`` per aten op it ran,
below autograd and after every composite op has decomposed:

  - the op's name (``aten::linalg_cholesky_ex``);
  - its tensor operands, by schema argument name, with dtype, shape and
    device;
  - its tensor outputs, and the buffers it allocated (``new``): an output
    whose storage is none of the operands' is a new buffer, counted once
    per storage, so a view or an ``expand`` allocates nothing;
  - whether it is a view (its schema returns an alias it does not write).

Storages are told apart by their ``StorageImpl`` (``storage_key``), not
their data pointer, so a trace on the ``meta`` device (every pointer 0)
records its buffers too. A dispatch mode never sees a free: the trace
puts a ``weakref.finalize`` on each new storage (PyTorch keeps one Python
object per storage alive as long as the storage itself) and notes in
``frees`` where in the op sequence it died. ``roofline.op_cost``'s
``peak_buffer_bytes`` replays both into a live-bytes high-water mark.

The hand-written kernels are ctypes calls that the dispatcher never sees:
their wrappers report each launch through ``note_kernel`` (a no-op unless
a trace is recording), so B1 and B2 appear as ops of their own
(``repro_torch::bmf_precision``, ``repro_torch::bmf_sweep``) with their
named operands. On a CPU tensor a wrapper runs the kernel's plain version
instead, inside ``plain_region``: those aten ops are recorded as usual and
tagged with the kernel they stand in for (``OpRecord.plain``).

    with optrace.record() as tr:
        run_gibbs(...)
    analyze(OpArtifact("chain", tr.ops, bytes_budget=...))
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass(frozen=True)
class TensorMeta:
    name: str                   # schema argument name, or the output index
    dtype: str                  # "float32", "bfloat16", ...
    shape: Tuple[int, ...]
    device: str                 # "cpu", "cuda", ...


@dataclass(frozen=True)
class OpRecord:
    op: str                     # "aten::add", "repro_torch::bmf_sweep"
    operands: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    # (dtype, shape, bytes) of every new storage the op allocated
    new: Tuple[Tuple[str, Tuple[int, ...], int], ...] = ()
    plain: Optional[str] = None  # the kernel whose plain version ran it
    kernel: bool = False         # a hand-written kernel's launch
    view: bool = False           # returns an alias of an operand
    # ``storage_key`` and device type of each entry of ``new``
    new_keys: Tuple[Tuple[int, str], ...] = ()


# traces recording now, innermost last; the kernel wrappers' plain regions
_ACTIVE: List["OpTrace"] = []
_PLAIN: List[str] = []


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _meta(name: str, t: torch.Tensor) -> TensorMeta:
    return TensorMeta(name, _dtype(t), tuple(t.shape), t.device.type)


def _named_tensors(func, args, kwargs):
    """(schema argument name, tensor) for every tensor operand; a tensor
    list ``tensors`` yields ``tensors.0``, ``tensors.1``, ..."""
    names = [a.name for a in func._schema.arguments]
    pairs = list(zip(names, args)) + list(kwargs.items())
    for i, v in enumerate(args[len(names):]):
        pairs.append((f"arg{len(names) + i}", v))
    for name, v in pairs:
        if isinstance(v, torch.Tensor):
            yield name, v
        elif isinstance(v, (list, tuple)):
            for j, x in enumerate(v):
                if isinstance(x, torch.Tensor):
                    yield f"{name}.{j}", x


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def storage_of(t: torch.Tensor):
    """``t``'s storage, or None where it has none."""
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def storage_key(t: torch.Tensor) -> int:
    """Identity of ``t``'s storage (its ``StorageImpl``; 0 where it has
    none): equal for a tensor and its views, on every device."""
    s = storage_of(t)
    return 0 if s is None else s._cdata


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpTrace(TorchDispatchMode):
    """A dispatch mode that records every op run under it (``ops``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        # (position in ``ops`` when it died, storage key, bytes) of every
        # storage a recorded op allocated and the trace outlived
        self.frees: List[Tuple[int, int, int]] = []
        self._recording = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        operands = list(_named_tensors(func, args, kwargs))
        before = {storage_key(t) for _, t in operands}
        metas = tuple(_meta(n, t) for n, t in operands)
        plain = _PLAIN[-1] if _PLAIN else None
        try:
            out = func(*args, **kwargs)
        except Exception:
            # an op the backend refuses (a bf16 Cholesky) is still what
            # the call asked for
            self.ops.append(OpRecord(func._schema.name, metas, (),
                                     plain=plain))
            raise
        outs = _outputs(out)
        new, keys, seen = [], [], set(before)
        for t in outs:
            st = storage_of(t)
            if st is None or not st.nbytes() or st._cdata in seen:
                continue
            seen.add(st._cdata)
            new.append((_dtype(t), tuple(t.shape), st.nbytes()))
            keys.append((st._cdata, t.device.type))
            fin = weakref.finalize(st, self._freed, st._cdata,
                                   st.nbytes())
            fin.atexit = False
        self.ops.append(OpRecord(
            op=func._schema.name, operands=metas,
            outputs=tuple(_meta(str(i), t) for i, t in enumerate(outs)),
            new=tuple(new), plain=plain, view=_is_view(func),
            new_keys=tuple(keys)))
        return out

    def _freed(self, key: int, nbytes: int):
        if self._recording:
            self.frees.append((len(self.ops), key, nbytes))

    def __enter__(self):
        super().__enter__()
        _ACTIVE.append(self)
        self._recording = True
        return self

    def __exit__(self, *exc):
        self._recording = False
        _ACTIVE.remove(self)
        return super().__exit__(*exc)


def record() -> OpTrace:
    """``with record() as tr:`` — ``tr.ops`` holds what the block ran."""
    return OpTrace()


def note_kernel(name: str, operands: Dict[str, torch.Tensor],
                outputs: Dict[str, torch.Tensor]):
    """Record one hand-written kernel launch in every recording trace; a
    no-op when none records (the launch path's only cost)."""
    if not _ACTIVE:
        return
    rec = OpRecord(op=name,
                   operands=tuple(_meta(n, t) for n, t in operands.items()),
                   outputs=tuple(_meta(n, t) for n, t in outputs.items()),
                   kernel=True)
    for tr in _ACTIVE:
        tr.ops.append(rec)


@contextlib.contextmanager
def plain_region(kernel: str):
    """Tag the ops recorded inside with ``kernel``: the wrapper runs the
    kernel's plain version there (a CPU tensor)."""
    _PLAIN.append(kernel)
    try:
        yield
    finally:
        _PLAIN.pop()


# -- summaries --------------------------------------------------------------


def op_counts(ops: Iterable[OpRecord]) -> Counter:
    return Counter(o.op for o in ops)


def kernel_counts(ops: Iterable[OpRecord]) -> Dict[str, int]:
    """Launches per hand-written kernel in a trace."""
    return dict(Counter(o.op for o in ops if o.kernel))


def largest_buffer(ops: Iterable[OpRecord]):
    """(bytes, op, dtype, shape) of the largest new buffer, or None."""
    best = None
    for o in ops:
        for dt, shape, nb in o.new:
            if best is None or nb > best[0]:
                best = (nb, o.op, dt, shape)
    return best
