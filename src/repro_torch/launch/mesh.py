"""Placement meshes (port of ``repro.launch.mesh``).

The LLM meshes: ``Mesh`` is a named grid of slots, row-major over its
axes, the counterpart of ``jax.sharding.Mesh``. A slot is a (device,
stream) pair and a device may repeat, so one GPU holds every slot of a
mesh, each on its own CUDA stream; a mesh built with no devices is the
counterpart of ``jax.sharding.AbstractMesh`` (specs and shard shapes
only). The mesh runs the collectives over its axes (``all_gather``,
``psum``, ``psum_scatter``) on ``core.topology.Group``: tensor ops where
the slots share a device, ``torch.cuda.comm`` copies where they do not
(unverified: the port has run on one card only).

  single pod : 16 × 16 slots, axes ('data', 'model')
  multi-pod  : 2 × 16 × 16 slots, axes ('pod', 'data', 'model')
  debug      : n_data × n_model slots, axes ('data', 'model')

BMF-PP placement goes through ``make_pp_topology`` / ``make_pp_mesh``: a
``core.topology.Topology`` of ``block`` device groups × ``data`` shard
slots, unrelated to the LLM meshes.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.topology import Group, _as_device

Slot = Tuple[int, ...]
Axes = Union[str, Tuple[str, ...]]


class Mesh:
    """``shape`` slots over ``axis_names``; ``devices`` lists the slots'
    devices row-major (one device: every slot on it), or is None for a
    mesh without devices (specs and shard shapes only)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in shape)
        if min(self.axis_sizes, default=1) < 1:
            raise ValueError(f"mesh axes must be >= 1, got {shape}")
        self.shape = dict(zip(self.axis_names, self.axis_sizes))
        self.size = math.prod(self.axis_sizes)
        self.slots: List[Slot] = list(itertools.product(
            *(range(n) for n in self.axis_sizes)))
        if devices is None:
            self.devices = None
        else:
            if isinstance(devices, (str, torch.device)):
                devices = (devices,)
            devs = tuple(_as_device(d) for d in devices)
            if len(devs) == 1:
                devs = devs * self.size
            if len(devs) != self.size:
                raise ValueError(f"mesh {self.axis_sizes} needs {self.size} "
                                 f"devices (or one), got {len(devs)}")
            self.devices = devs
        self._streams: Optional[Dict[Slot, object]] = None
        self._groups: Dict[tuple, Tuple[Group, List[Slot]]] = {}

    def __repr__(self):
        where = ("no devices" if self.devices is None else
                 ", ".join(sorted({str(d) for d in self.devices})))
        return (f"Mesh({dict(self.shape)}, {self.size} slot(s) on {where})")

    # -- slots ----------------------------------------------------------------

    def axis_size(self, axes: Axes) -> int:
        """Slots along ``axes`` (a name or a tuple of names; an absent
        axis counts 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def coord(self, slot: Slot, axes: Axes) -> int:
        """``slot``'s index along ``axes``, row-major over a tuple (the
        first name major), as JAX numbers a dimension sharded over several
        axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + slot[self.axis_names.index(a)]
        return i

    def device(self, slot: Slot) -> torch.device:
        if self.devices is None:
            raise ValueError("this mesh has no devices (specs only)")
        return self.devices[self.slots.index(tuple(slot))]

    @property
    def cuda(self) -> bool:
        return self.devices is not None and self.devices[0].type == "cuda"

    def stream(self, slot: Slot):
        """Slot ``slot``'s CUDA stream (made on first use), None off the
        GPU."""
        if not self.cuda:
            return None
        if self._streams is None:
            self._streams = {s: torch.cuda.Stream(self.device(s))
                             for s in self.slots}
        return self._streams[tuple(slot)]

    def on(self, slot: Slot):
        """Context that runs the enclosed work on ``slot``'s stream."""
        st = self.stream(slot)
        return (torch.cuda.stream(st) if st is not None
                else contextlib.nullcontext())

    def fork(self):
        """Every slot stream waits for the current stream (inputs made
        before the call are ready)."""
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.devices[0])
        for s in self.slots:
            self.stream(s).wait_stream(cur)

    def join(self):
        """The current stream waits for every slot stream."""
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.devices[0])
        for s in self.slots:
            cur.wait_stream(self.stream(s))

    def map(self, fn, *parts: Dict[Slot, object]) -> Dict[Slot, object]:
        """``{slot: fn(slot, *(p[slot] for p in parts))}``, each call on
        its slot's stream."""
        out = {}
        for s in self.slots:
            with self.on(s):
                out[s] = fn(s, *(p[s] for p in parts))
        return out

    def groups(self, axes: Axes) -> List[Tuple[Group, List[Slot]]]:
        """The slot groups along ``axes``: each holds the slots that
        share every other coordinate, ordered by their index along
        ``axes``; its ``Group`` index is its first slot's position."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a in self.shape)
        key = axes
        if key not in self._groups:
            rest = [i for i, a in enumerate(self.axis_names)
                    if a not in axes]
            by_rest: Dict[tuple, List[Slot]] = {}
            for s in self.slots:
                by_rest.setdefault(tuple(s[i] for i in rest), []).append(s)
            out = []
            for members in by_rest.values():
                members = sorted(members, key=lambda s: self.coord(s, axes))
                devs = (tuple(self.device(s) for s in members)
                        if self.devices is not None
                        else (torch.device("meta"),) * len(members))
                out.append((Group(self.slots.index(members[0]), devs),
                            members))
            self._groups[key] = out
        return self._groups[key]

    # -- collectives ----------------------------------------------------------

    def _collective(self, members, parts, op, fn):
        """Run ``fn(ordered parts) -> per-member results`` on the group's
        first slot's stream, after every member's stream, and make every
        member's stream wait for it; buffers that cross streams are
        recorded on the streams that read them."""
        ordered = [parts[s] for s in members]
        lead = self.stream(members[0])
        if lead is None:
            return dict(zip(members, fn(ordered)))
        for s in members:
            lead.wait_stream(self.stream(s))
        for s, p in zip(members, ordered):
            if self.stream(s) is not lead:
                p.record_stream(lead)
        with torch.cuda.stream(lead):
            res = fn(ordered)
        for s, r in zip(members, res):
            st = self.stream(s)
            if st is not lead:
                st.wait_stream(lead)
                r.record_stream(st)
        return dict(zip(members, res))

    # each collective leaves its parts as they are along an axis of one
    # slot (nothing to exchange, nothing recorded). Under autograd a
    # result is one tensor per member, and the backward pass runs the
    # transposed collective (an all-gather's a reduce-scatter, a psum's a
    # psum), recorded as the forward's are: the gradient of a value every
    # member uses is the members' cotangents summed, which is what the
    # reference's SPMD program exchanges

    def all_gather(self, parts: Dict[Slot, torch.Tensor], axes: Axes,
                   dim: int) -> Dict[Slot, torch.Tensor]:
        """Tiled all-gather: every slot gets its group's tiles along
        ``axes`` concatenated on ``dim``, in index order."""
        if self.axis_size(axes) == 1:
            return dict(parts)
        out = {}
        for grp, members in self.groups(axes):
            def fn(ordered, grp=grp):
                if _grad(ordered):
                    return list(_AllGather.apply(grp, dim, *ordered))
                return _fan_out(grp, grp.all_gather(ordered, dim=dim))
            out.update(self._collective(members, parts, "all_gather", fn))
        return out

    def psum(self, parts: Dict[Slot, torch.Tensor], axes: Axes
             ) -> Dict[Slot, torch.Tensor]:
        """All-reduce: every slot gets its group's sum along ``axes``,
        added in index order (a rerun is bitwise the same)."""
        if self.axis_size(axes) == 1:
            return dict(parts)
        out = {}
        for grp, members in self.groups(axes):
            def fn(ordered, grp=grp):
                if _grad(ordered):
                    return list(_AllReduce.apply(grp, *ordered))
                return _fan_out(grp, grp.psum(ordered))
            out.update(self._collective(members, parts, "psum", fn))
        return out

    def psum_scatter(self, parts: Dict[Slot, torch.Tensor], axes: Axes,
                     dim: int) -> Dict[Slot, torch.Tensor]:
        """Tiled reduce-scatter: the group's sum along ``axes`` split in
        equal tiles on ``dim``, tile i to the group's i-th slot (no
        gradient)."""
        if self.axis_size(axes) == 1:
            return dict(parts)
        out = {}
        for grp, members in self.groups(axes):
            def fn(ordered, grp=grp):
                return grp.psum_scatter(ordered, dim)
            out.update(self._collective(members, parts, "psum_scatter", fn))
        return out

    def view(self, slot: Optional[Slot] = None) -> "SlotView":
        """One slot's program of this mesh (``SlotView``): the dry run
        plans a slot, not the whole mesh."""
        return SlotView(self, tuple(slot) if slot is not None
                        else self.slots[0])


def _grad(parts) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def _fan_out(grp: Group, t: torch.Tensor, copy: bool = False):
    """``t`` (on the group's lead device) for each member: the tensor
    itself where the member shares its device (a copy of it with
    ``copy``, so that each member's result is its own autograd output)."""
    return [(t.clone() if copy and i else t) if d == t.device
            else t.to(d, non_blocking=True)
            for i, d in enumerate(grp.devices)]


class _AllReduce(torch.autograd.Function):
    """``Group.psum`` with one result per member; its backward pass sums
    the members' cotangents (a recorded psum) for every part."""

    @staticmethod
    def forward(ctx, grp, *parts):
        ctx.grp = grp
        return tuple(_fan_out(grp, grp.psum(list(parts)), copy=True))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_fan_out(ctx.grp, ctx.grp.psum(_filled_like(grads))))


def _filled_like(grads):
    """The cotangents, zeros for a member whose result went unused."""
    ref = next(g for g in grads if g is not None)
    return [torch.zeros_like(ref) if g is None else g for g in grads]


class _AllGather(torch.autograd.Function):
    """``Group.all_gather`` with one result per member; its backward pass
    reduce-scatters the members' cotangents (a recorded psum_scatter)
    onto the parts."""

    @staticmethod
    def forward(ctx, grp, dim, *parts):
        ctx.grp, ctx.dim = grp, dim
        return tuple(_fan_out(grp, grp.all_gather(list(parts), dim=dim),
                              copy=True))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.grp.psum_scatter(_filled_like(grads),
                                                  ctx.dim))


class SlotView(Mesh):
    """One slot of ``mesh``, for planning its program on ``meta``: the
    mesh's axes, sizes and shard ranges, but only ``slot`` runs. A
    collective records the call the slot takes part in (its group's
    index and parts, all of the slot's shape) and stands in for the
    other members with the slot's own part: ``all_gather`` concatenates
    copies of it, ``psum`` and ``psum_scatter`` copy it (or its tile). The
    stand-ins keep the shapes and the autograd graph, so a planned
    backward runs too; their values mean nothing, which on ``meta`` they
    do not have."""

    def __init__(self, mesh: Mesh, slot: Slot):
        super().__init__(mesh.axis_sizes, mesh.axis_names, None)
        self.full = mesh
        self.slots = [tuple(slot)]

    def __repr__(self):
        return f"SlotView({self.full!r}, slot {self.slots[0]})"

    def _group(self, axes: Axes) -> Group:
        slot = self.slots[0]
        return next(g for g, members in self.full.groups(axes)
                    if slot in members)

    def _stand_in(self, parts, axes, fn):
        if self.axis_size(axes) == 1:
            return dict(parts)
        slot = self.slots[0]
        return {slot: fn(self._group(axes), self.axis_size(axes),
                         parts[slot])}

    def all_gather(self, parts, axes, dim):
        return self._stand_in(parts, axes, lambda g, n, p: _GatherStandIn.apply(
            g, n, dim, p))

    def psum(self, parts, axes):
        return self._stand_in(parts, axes, lambda g, n, p: _SumStandIn.apply(
            g, n, p))

    def psum_scatter(self, parts, axes, dim):
        def fn(g, n, p):
            g._note("psum_scatter", [p] * n)
            return p.narrow(dim, 0, p.shape[dim] // n).clone()
        return self._stand_in(parts, axes, fn)


class _SumStandIn(torch.autograd.Function):
    """A planned psum: recorded with the slot's part for every member, the
    part's copy as the result; the backward pass records the psum of the
    cotangents."""

    @staticmethod
    def forward(ctx, grp, n, p):
        ctx.grp, ctx.n = grp, n
        grp._note("psum", [p] * n)
        return p.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.grp._note("psum", [g] * ctx.n)
        return None, None, g.clone()


class _GatherStandIn(torch.autograd.Function):
    """A planned all-gather: the slot's part concatenated ``n`` times; the
    backward pass records the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, grp, n, dim, p):
        ctx.grp, ctx.n, ctx.dim = grp, n, dim
        grp._note("all_gather", [p] * n)
        return torch.cat([p] * n, dim=dim)

    @staticmethod
    def backward(ctx, g):
        ctx.grp._note("psum_scatter", [g] * ctx.n)
        return None, None, None, g.narrow(
            ctx.dim, 0, g.shape[ctx.dim] // ctx.n).clone()


def _mesh_devices(devices, n: int):
    """The slots' devices: the card (every slot on it) unless ``devices``
    names others; raises with no GPU."""
    if devices is None:
        return (resolve_device(None),)
    if isinstance(devices, (str, torch.device)):
        return (resolve_device(devices),)
    return tuple(resolve_device(d) for d in devices)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: 16 × 16 ('data', 'model'), or
    2 × 16 × 16 ('pod', 'data', 'model'), every slot on the card unless
    ``devices`` says otherwise (one device, or one per slot)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, _mesh_devices(devices, math.prod(shape)))


def make_debug_mesh(n_data: int = 4, n_model: int = 2, devices=None) -> Mesh:
    """Small ('data', 'model') mesh, every slot on the card unless
    ``devices`` says otherwise."""
    return Mesh((n_data, n_model), ("data", "model"),
                _mesh_devices(devices, n_data * n_model))


def make_pp_topology(block: int, data: int = 1, devices=None):
    """The placement ``run_pp(topology=...)`` takes: ``block`` groups of
    ``data`` slots each."""
    from repro_torch.core.topology import Topology
    return Topology(block=block, data=data, devices=devices)


def make_pp_mesh(block: int, data: int = 1, devices=None):
    """The reference's 2-D ('block', 'data') mesh builder; in the port the
    same ``Topology`` (its groups and slots stand in for the mesh)."""
    return make_pp_topology(block, data, devices)
