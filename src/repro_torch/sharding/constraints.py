"""Ambient-mesh-aware sharding constraints (port of
``repro.sharding.constraints``).

The sharded steps (``models.sharded``) call ``constrain(x, batch_axes(),
None, "model", None)`` where they place q, k and v, the reference's sites.
With no ambient mesh (``use_mesh``, the counterpart of ``jax.set_mesh``)
both are no-ops, as in the reference. Under a mesh the spec is filtered as the reference
filters it (axes absent from the mesh are dropped, a dim the axes'
product does not divide stays unsharded), and a ``Sharded`` value (one
logical tensor as its slots' shards) moves to that placement
(``partitioning.reshard``: an all-gather where a dim loses its axes, a
local cut where it gains them). A plain tensor is one slot's value,
already placed, and passes as it is.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

from repro_torch.sharding.partitioning import Sharded, reshard

_MESHES: List = []


@contextlib.contextmanager
def use_mesh(mesh):
    """``with use_mesh(mesh):`` — ``mesh`` is ambient inside."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def ambient_mesh():
    return _MESHES[-1] if _MESHES else None


def _ambient_axes() -> Tuple[str, ...]:
    mesh = ambient_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def constraint_spec(shape, *dim_axes) -> Optional[tuple]:
    """The spec ``constrain`` would place a ``shape`` tensor under: None
    with no ambient mesh, else one entry per ``dim_axes`` entry (None, an
    axis name, or a tuple of names), filtered to the ambient axes and to
    the dims their product divides."""
    names = _ambient_axes()
    if not names:
        return None
    sizes = ambient_mesh().shape
    spec = []
    for i, d in enumerate(dim_axes):
        if d is None:
            spec.append(None)
            continue
        cand = d if isinstance(d, tuple) else (d,)
        cand = tuple(a for a in cand if a in names)
        if not cand:
            spec.append(None)
            continue
        prod = 1
        for a in cand:
            prod *= sizes[a]
        if shape[i] % prod == 0:
            spec.append(cand if len(cand) > 1 else cand[0])
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *dim_axes):
    """``x`` under ``constraint_spec(x.shape, *dim_axes)`` (module
    docstring)."""
    spec = constraint_spec(x.shape, *dim_axes)
    if spec is None or not isinstance(x, Sharded):
        return x
    return reshard(x, spec)


def batch_axes():
    """('pod', 'data') subset present in the ambient mesh."""
    names = _ambient_axes()
    return tuple(a for a in ("pod", "data") if a in names) or None
