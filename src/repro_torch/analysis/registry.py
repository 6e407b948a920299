"""Pass registry + artifact containers of the static invariant analyzer
(port of ``repro.analysis.registry``).

A ``Pass`` couples a name with the artifact kind it understands and a
``run(artifact) -> [Violation]`` function. Passes register themselves at
import time (``repro_torch.analysis`` imports every pass module), so
``analyze(artifact)`` always sees the full registry.

The artifact kinds are the port's own: a jaxpr and HLO text have no torch
counterpart, so what one call ran is recorded instead.

  ops    an op trace (``optrace.record``): every aten op and hand-written
         kernel one call ran — replaces the reference's ``jaxpr``;
  comm   a recorded collective trace (``core.topology.record_collectives``)
         — replaces the confinement half of ``hlo``;
  reuse  the streaming window's plane hand-outs — replaces the donation
         half of ``hlo``;
  trace, graph, plan   as in the reference.

Artifacts are plain dataclasses carrying exactly what the passes need;
none of them import engine or chain types, so the analyzer stays a leaf of
the dependency graph and ``core.engine`` calls into it (graph validation
before dispatch) without a cycle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Violation:
    """One invariant breach: which pass fired, on what artifact, what went
    wrong, and how to fix it (the fix hint is part of the contract)."""
    pass_name: str
    artifact: str
    message: str
    fix_hint: str

    def as_dict(self) -> Dict[str, str]:
        return {"pass": self.pass_name, "artifact": self.artifact,
                "message": self.message, "fix_hint": self.fix_hint}

    def __str__(self):
        return (f"[{self.pass_name}] {self.artifact}: {self.message}\n"
                f"    fix: {self.fix_hint}")


KINDS = ("ops", "comm", "reuse", "trace", "graph", "plan")


@dataclass(frozen=True)
class Pass:
    """A named analysis over one artifact kind."""
    name: str
    kind: str                                   # one of KINDS
    doc: str
    run: Callable[[Any], List[Violation]]


_REGISTRY: Dict[str, Pass] = {}


def register(p: Pass) -> Pass:
    if p.kind not in KINDS:
        raise ValueError(f"pass {p.name!r}: unknown artifact kind {p.kind!r} "
                         f"(expected one of {KINDS})")
    if p.name in _REGISTRY:
        raise ValueError(f"duplicate pass name {p.name!r}")
    _REGISTRY[p.name] = p
    return p


def get_pass(name: str) -> Pass:
    if name not in _REGISTRY:
        raise KeyError(f"unknown pass {name!r} "
                       f"(registered: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def passes(kind: Optional[str] = None) -> List[Pass]:
    """All registered passes, optionally filtered to one artifact kind."""
    ps = sorted(_REGISTRY.values(), key=lambda p: p.name)
    return ps if kind is None else [p for p in ps if p.kind == kind]


def analyze(artifact) -> List[Violation]:
    """Run every registered pass of ``artifact.kind`` and concatenate the
    violations."""
    return [v for p in passes(artifact.kind) for v in p.run(artifact)]


# ---------------------------------------------------------------------------
# Artifact containers
# ---------------------------------------------------------------------------


@dataclass
class OpArtifact:
    """What one call ran (``optrace.OpRecord`` entries, in order).
    ``bytes_budget`` is the largest single new buffer the call may
    allocate, from block dims (``op_passes.materialization_budget``); None
    skips the materialization pass."""
    label: str
    ops: Sequence[Any]
    bytes_budget: Optional[int] = None
    allow_f64: bool = False
    kind: str = field(default="ops", init=False)


@dataclass
class CommArtifact:
    """The collectives one chain called (``core.topology.CollectiveCall``
    entries) over ``sweeps`` sweeps, its comm mode (keys
    ``comm_passes.COLLECTIVE_BUDGETS``) and the topology's groups as
    ``(index, devices)`` pairs (None skips the group check)."""
    label: str
    calls: Sequence[Any]
    sweeps: int = 1
    comm: Optional[str] = None
    allowed_groups: Optional[Sequence[Tuple[int, Tuple[str, ...]]]] = None
    kind: str = field(default="comm", init=False)


@dataclass
class ReuseArtifact:
    """The streaming window's plane hand-outs over a run: ``handed`` holds
    one ``(group, storages)`` entry per chunk dispatch (the data pointers
    of the storages the chunk's planes live in), ``slots`` each group's
    slot storages as the window allocated them, one tuple per slot
    (``depth + 1``, plus those grown on rebalance)."""
    label: str
    handed: Sequence[Tuple[int, Tuple[int, ...]]]
    slots: Dict[int, Sequence[Tuple[int, ...]]]
    kind: str = field(default="reuse", init=False)


Coord = Tuple[int, int]


@dataclass
class TraceArtifact:
    """An executor's recorded event trace plus the dep map it ran
    against. Entries are ``(event, coord)`` or ``(event, coord, group)``.
    ``window_bound`` is the streaming occupancy cap G·W·(depth+1);
    ``reported_peak`` the executor's own high-water mark
    (``peak_window_blocks``)."""
    label: str
    trace: Sequence[Tuple]
    deps: Dict[Coord, Sequence[Coord]]
    window_bound: Optional[int] = None
    reported_peak: Optional[int] = None
    kind: str = field(default="trace", init=False)


@dataclass
class GraphArtifact:
    """A phase graph as a plain dep map (coord -> dep coords), with any
    pre-resolved coords (checkpoint resume) counted as satisfied."""
    label: str
    deps: Dict[Coord, Sequence[Coord]]
    resolved: Sequence[Coord] = ()
    kind: str = field(default="graph", init=False)


@dataclass
class PlanArtifact:
    """The executable-shape plan a partition + coalesce choice implies:
    one hashable signature per distinct chain shape, against a cap."""
    label: str
    signatures: Sequence[Any]
    cap: int = 8
    kind: str = field(default="plan", init=False)
