"""Carry state between the JAX reference and the port, as numpy arrays.

The reference's state types are NamedTuples (``RowGaussians``,
``GibbsAccumulators``, ``NormalWishart``, ``BMFConfig``) and the
``PaddedCSR`` dataclass; the port's have the same field names. The
``*_from_numpy`` functions build the port's objects from a mapping of
field name to numpy array (e.g. ``{k: np.asarray(v) for k, v in
jax_obj._asdict().items()}``) on a device; ``to_numpy`` turns any of the
port's objects back into nested dicts of numpy arrays. Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bmf import BMFConfig
from repro_torch.core.gibbs import GibbsAccumulators
from repro_torch.core.posterior import NormalWishart, RowGaussians
from repro_torch.data.sparse import PaddedCSR


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``; copies, so the
    source may be read-only."""
    arr = np.array(x, copy=True)
    return torch.from_numpy(arr).to(resolve_device(device), dtype=dtype)


def _named(cls, fields: Mapping[str, object], device):
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {missing}")
    return cls(**{f: tensor(fields[f], device) for f in cls._fields})


def padded_csr_from_numpy(fields: Mapping[str, object],
                          device=None) -> PaddedCSR:
    """``fields``: idx (int32), val, mask (f32) planes and ``n_cols``."""
    dev = resolve_device(device)
    return PaddedCSR(idx=tensor(fields["idx"], dev, torch.int32),
                     val=tensor(fields["val"], dev, torch.float32),
                     mask=tensor(fields["mask"], dev, torch.float32),
                     n_cols=int(fields["n_cols"]))


def row_gaussians_from_numpy(fields, device=None) -> RowGaussians:
    return _named(RowGaussians, fields, device)


def accumulators_from_numpy(fields, device=None) -> GibbsAccumulators:
    return _named(GibbsAccumulators, fields, device)


def normal_wishart_from_numpy(fields, device=None) -> NormalWishart:
    return _named(NormalWishart, fields, device)


def factors_from_numpy(U, V, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return tensor(U, device, torch.float32), tensor(V, device, torch.float32)


def aggregates_from_numpy(U_agg, V_agg, device=None):
    """The ``U_agg`` / ``V_agg`` of a reference ``PPResult`` (each a
    mapping with eta and Lambda)."""
    return (row_gaussians_from_numpy(U_agg, device),
            row_gaussians_from_numpy(V_agg, device))


def bmf_config_from_dict(fields: Mapping[str, object]) -> BMFConfig:
    """A ``BMFConfig`` from the reference's ``cfg._asdict()``; unknown
    fields raise, missing ones keep their defaults."""
    unknown = set(fields) - set(BMFConfig._fields)
    if unknown:
        raise KeyError(f"BMFConfig has no fields {sorted(unknown)}")
    return BMFConfig(**dict(fields))


def to_numpy(obj):
    """The port's state as numpy: tensors become arrays, NamedTuples and
    ``PaddedCSR`` become dicts of their fields, other values pass as they
    are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, PaddedCSR):
        return {"idx": to_numpy(obj.idx), "val": to_numpy(obj.val),
                "mask": to_numpy(obj.mask), "n_cols": obj.n_cols}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
