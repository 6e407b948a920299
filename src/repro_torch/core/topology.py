"""The 2-D device topology of a Posterior Propagation run (port of
``repro.core.topology``).

The paper's combined system has two levels of parallelism:

  * block level — same-phase PP blocks run concurrently on separate
    device groups, with no collective between groups;
  * intra-block level — one block's Gibbs chain is itself distributed
    over the ``data`` shards of its group (rows of U sharded; the
    freshly sampled factor or the item statistics exchanged each sweep,
    ``core.distributed``).

    Topology(block=2, data=2)      # 4 slots: 2 groups of 2 shards
      group 0: devices[0:2]  — runs blocks, each chain sharded 2-way
      group 1: devices[2:4]

The port is single-controller, as the reference is: one process drives
every slot. A slot is a (device, stream) pair and a device may repeat,
so one GPU holds several groups and several shards of a group, each slot
on its own CUDA stream. There is no mesh: ``Group`` holds a group's
ordered slots and the collectives over them (``all_gather``, ``psum``,
``psum_scatter``, ``broadcast``) — tensor ops where slots share a device,
peer copies (``torch.cuda.comm``) where they do not.

Every executor consumes the same object: the sharded executor splits a
bucket's batch over the groups, the async executor round-robins ready
blocks over them, the streaming executor keeps one window per group, and
at ``data > 1`` each block's chain runs ``distributed.run_gibbs_stacked_2d``
on its group's slots. Collectives run inside a group only ('data'); a
phase boundary is the only thing that crosses groups ('block').
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

BLOCK_AXIS = "block"
DATA_AXIS = "data"


def visible_devices() -> Tuple[torch.device, ...]:
    """Every visible GPU, or the CPU when there is none."""
    if torch.cuda.is_available():
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Topology:
    """Placement of a PP run on ``block × data`` slots.

    block:   device groups — how many blocks run concurrently.
    data:    shards per group — how many slots one block's chain spans.
    devices: the slots' devices (length block·data, grouped row-major:
             group g = devices[g·data:(g+1)·data]); a device may repeat.
             Default: the visible devices, round-robin."""
    block: int = 1
    data: int = 1
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if self.block < 1 or self.data < 1:
            raise ValueError(f"topology axes must be >= 1, got "
                             f"block={self.block} data={self.data}")
        n = self.block * self.data
        if self.devices is None:
            vis = visible_devices()
            devs = tuple(vis[k % len(vis)] for k in range(n))
        else:
            devs = tuple(_as_device(d) for d in self.devices)
        if len(devs) != n:
            raise ValueError(f"topology {self.block}x{self.data} needs "
                             f"{n} devices, got {len(devs)}")
        object.__setattr__(self, "devices", devs)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def default(data: int = 1) -> "Topology":
        """One group per visible device, ``data`` slots each on it."""
        vis = visible_devices()
        return Topology(block=len(vis), data=data,
                        devices=tuple(d for d in vis for _ in range(data)))

    @staticmethod
    def from_spec(spec) -> "Topology":
        """Coerce run_pp-style specs: a Topology, None (``default``), a
        ``(block, data)`` pair, or a device sequence (one single-slot
        group per device)."""
        if spec is None:
            return Topology.default()
        if isinstance(spec, Topology):
            return spec
        if isinstance(spec, (list, tuple)) and spec and not all(
                isinstance(x, int) for x in spec):
            devs = tuple(spec)
            return Topology(block=len(devs), data=1, devices=devs)
        if isinstance(spec, (list, tuple)) and len(spec) == 2:
            b, d = spec
            return Topology(block=int(b), data=int(d))
        raise ValueError(f"{spec!r} is not a PP topology (expected a "
                         f"Topology, None, a (block, data) pair or a "
                         f"device sequence)")

    # -- groups -------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.block * self.data

    def group(self, g: int) -> Tuple[torch.device, ...]:
        """Devices of group ``g``'s slots, in shard order."""
        if not 0 <= g < self.block:
            raise ValueError(f"group {g} outside 0..{self.block - 1}")
        return self.devices[g * self.data:(g + 1) * self.data]

    def groups(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """All device groups, in block-axis order."""
        return tuple(self.group(g) for g in range(self.block))

    def slots(self, g: int) -> "Group":
        """Group ``g``'s slots and collectives (fresh streams per call:
        an executor builds its groups once per run)."""
        return Group(g, self.group(g))

    def without_groups(self, dead) -> "Topology":
        """The surviving sub-topology after dropping device groups
        ``dead`` (e.g. ``TopologyDegradedError.dead_groups``): same
        ``data`` width, the remaining groups in canonical order. Block
        posteriors are placement-independent, so a run checkpointed before
        the degradation resumes bitwise on the survivors."""
        dead = {int(g) for g in dead}
        bad = dead - set(range(self.block))
        if bad:
            raise ValueError(f"unknown group(s) {sorted(bad)} "
                             f"(topology has {self.block} group(s))")
        alive = [g for g in range(self.block) if g not in dead]
        if not alive:
            raise ValueError("cannot drop every device group")
        devs = tuple(d for g in alive for d in self.group(g))
        return Topology(block=len(alive), data=self.data, devices=devs)

    def describe(self) -> str:
        names = sorted({str(d) for d in self.devices})
        return (f"topology {self.block}x{self.data} "
                f"({self.block} group(s) x {self.data} shard(s) on "
                f"{', '.join(names)})")


class CollectiveCall(NamedTuple):
    """One collective a ``Group`` was asked for: the public method, the
    group's index and slot devices, and the shapes of the parts. ``op``
    is one of broadcast, all_gather, psum, psum_scatter; ``dtypes`` the
    parts' dtypes (``"float32"``, …)."""
    op: str
    group: int
    devices: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...] = ()


# lists recording collective calls now (``record_collectives``)
_RECORDERS: List[List[CollectiveCall]] = []


@contextlib.contextmanager
def record_collectives():
    """``with record_collectives() as calls:`` — every ``Group``
    collective called inside, in order, for the analyzer's
    'collective-confinement' pass. Recorded at the public methods only, so
    a ``psum_scatter`` counts once, not also as the psum it reduces with."""
    calls: List[CollectiveCall] = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


class Group:
    """One device group: its ordered 'data' slots, a CUDA stream per slot
    (created on first use; none on the CPU) and the collectives over the
    slots. Slot 0 leads: the chain's replicated work (hyperparameters,
    accumulators, predictions) runs on its stream, and every collective
    delivers there.

    Shard work runs fork-join: ``fork`` makes each slot stream wait for
    the lead stream, the shards run on their streams, ``join`` makes the
    lead stream wait for all of them. A buffer made on one side is read
    on the other only inside such a bracket, so the caching allocator
    never hands it out while a read is pending."""

    def __init__(self, index: int, devices: Sequence[torch.device]):
        self.index = int(index)
        self.devices = tuple(_as_device(d) for d in devices)
        self.lead = self.devices[0]
        self._streams: Optional[List] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def cuda(self) -> bool:
        return self.lead.type == "cuda"

    @property
    def streams(self) -> List:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]
        return self._streams

    def on(self, s: int = 0):
        """Context that runs the enclosed work on slot ``s``'s stream."""
        st = self.streams[s]
        return (torch.cuda.stream(st) if st is not None
                else contextlib.nullcontext())

    def fork(self):
        """Each slot stream waits for the lead device's current stream."""
        if not self.cuda:
            return
        lead = torch.cuda.current_stream(self.lead)
        for st in self.streams:
            if st is not None and st != lead:
                st.wait_stream(lead)

    def join(self):
        """The lead device's current stream waits for every slot."""
        if not self.cuda:
            return
        lead = torch.cuda.current_stream(self.lead)
        for st in self.streams:
            if st is not None and st != lead:
                lead.wait_stream(st)

    # -- collectives (results on the lead slot unless stated) ---------------

    def _same(self) -> bool:
        return all(d == self.lead for d in self.devices)

    def _note(self, op: str, parts: Sequence[torch.Tensor]):
        if _RECORDERS:
            call = CollectiveCall(op, self.index,
                                  tuple(str(d) for d in self.devices),
                                  tuple(tuple(p.shape) for p in parts),
                                  tuple(str(p.dtype).replace("torch.", "")
                                        for p in parts))
            for calls in _RECORDERS:
                calls.append(call)

    def broadcast(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every slot's device (the same tensor where it already
        lies there)."""
        self._note("broadcast", (x,))
        if self._same():
            return [x] * self.size
        uniq = list(dict.fromkeys(self.devices))
        if all(d.type == "cuda" for d in uniq):
            copies = dict(zip(uniq, torch.cuda.comm.broadcast(
                x, devices=[d.index for d in uniq])))
        else:
            copies = {d: x.to(d, non_blocking=True) for d in uniq}
        return [copies[d] for d in self.devices]

    def _gather_to_lead(self, parts):
        return [p if p.device == self.lead else
                p.to(self.lead, non_blocking=True) for p in parts]

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int = -2) -> torch.Tensor:
        """Concatenate the slots' tiles in shard order (tiled all_gather),
        on the lead slot."""
        self._note("all_gather", parts)
        if not self._same() and all(p.is_cuda for p in parts):
            return torch.cuda.comm.gather(list(parts), dim=dim,
                                          destination=self.lead.index)
        return torch.cat(self._gather_to_lead(parts), dim=dim)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The slots' partial sums added in fixed shard order on the lead
        slot, so a rerun is bitwise the same."""
        self._note("psum", parts)
        return self._psum(parts)

    def _psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        parts = self._gather_to_lead(parts)
        out = parts[0] + parts[1] if len(parts) > 1 else parts[0].clone()
        for p in parts[2:]:
            out.add_(p)
        return out

    def psum_scatter(self, parts: Sequence[torch.Tensor],
                     dim: int) -> List[torch.Tensor]:
        """Tiled reduce-scatter: the sum of the slots' partials, split in
        ``size`` equal tiles along ``dim``, tile s on slot s's device."""
        self._note("psum_scatter", parts)
        total = self._psum(parts)
        n = total.shape[dim]
        if n % self.size:
            raise ValueError(f"psum_scatter: dim of {n} is not a multiple "
                             f"of {self.size} shards")
        tiles = torch.split(total, n // self.size, dim=dim)
        return [t if d == self.lead else t.to(d, non_blocking=True)
                for t, d in zip(tiles, self.devices)]
