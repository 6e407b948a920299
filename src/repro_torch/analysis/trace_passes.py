"""Phase-graph validation (port of ``check_graph`` from
``repro.analysis.trace_passes`` and the ``Violation`` record of
``repro.analysis.registry``). The pass registry waits for the analyzer
port (ROADMAP §A)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

Coord = Tuple[int, int]


@dataclass(frozen=True)
class Violation:
    """One invariant breach: which pass fired, on what artifact, what went
    wrong, and how to fix it."""
    pass_name: str
    artifact: str
    message: str
    fix_hint: str

    def as_dict(self) -> Dict[str, str]:
        return {"pass": self.pass_name, "artifact": self.artifact,
                "message": self.message, "fix_hint": self.fix_hint}


def check_graph(deps: Dict[Coord, Sequence[Coord]],
                resolved: Sequence[Coord] = (),
                label: str = "phase-graph") -> List[Violation]:
    """Cycle / unreachable-block / dangling-dep detection on a dep map —
    ``run_phase_graph`` refuses to start on a graph that cannot drain."""
    out = []
    done = set(resolved)
    dangling = {}
    for c, ds in deps.items():
        missing = [d for d in ds if d not in deps and d not in done]
        if missing:
            dangling[c] = missing
            out.append(Violation(
                "graph-validation", label,
                f"{c} depends on {missing} which are neither in the "
                f"graph nor pre-resolved",
                "a pruned/mistyped dep can never resolve — prune the "
                "dependent too or fix the prior_from coords"))
    # Kahn drain: whatever never becomes ready is cyclic or blocked
    pending = {c: [d for d in ds if d not in done]
               for c, ds in deps.items()}
    ready = [c for c, ds in pending.items() if not ds]
    while ready:
        c = ready.pop()
        done.add(c)
        for s, ds in pending.items():
            if c in ds:
                ds.remove(c)
                if not ds and s not in done and s not in ready:
                    ready.append(s)
    stuck = sorted(c for c in deps if c not in done and c not in dangling)
    if stuck:
        out.append(Violation(
            "graph-validation", label,
            f"blocks {stuck[:6]}{'...' if len(stuck) > 6 else ''} can "
            f"never become ready (dependency cycle)",
            "the PP phase DAG is acyclic by construction (deps point to "
            "strictly earlier phases) — a cycle means prior_from coords "
            "were rewired; re-derive the graph from build_phase_graph"))
    return out
