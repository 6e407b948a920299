"""Dispatch/resolve-trace passes and phase-graph validation (port of
``repro.analysis.trace_passes``): the ``happens-before``,
``window-occupancy`` and ``graph-validation`` passes.

The executor trace schema (``core.engine.Executor``): barrier executors
record ``(event, coord)``, the overlapped ones ``(event, coord, group)``:

  ("dispatch", c[, g])    the block's chain was handed to the device
  ("expire", c[, g])      the watchdog expired the in-flight attempt
  ("redispatch", c[, g])  the expired attempt was dispatched again
  ("resolve", c[, g])     the block's outcome passed the commit guard

and the reference's multi-group events ("quarantine", "steal",
"speculate", "cancel"), which the passes check as the reference does.

Happens-before contract per coord: dispatch first; every dep resolved
before it; expire only while in flight; redispatch only after an
expire; exactly one resolve, last. An expire followed directly by
resolve is the degraded/terminal-retire path and is legal.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

from repro_torch.analysis.registry import (Coord, GraphArtifact, Pass,
                                           TraceArtifact, Violation,
                                           register)

_EVENTS = ("dispatch", "expire", "redispatch", "resolve",
           "quarantine", "steal", "speculate", "cancel")


def _entries(trace):
    """Normalize (ev, c) / (ev, c, g) entries to (ev, c, g-or-None)."""
    for entry in trace:
        ev, c = entry[0], entry[1]
        yield ev, c, (entry[2] if len(entry) > 2 else None)


def _happens_before(art: TraceArtifact) -> List[Violation]:
    """Every dep resolves before its dependent dispatches; watchdog
    re-dispatch is totally ordered with the expired attempt; every block
    resolves exactly once; no work reaches a quarantined group;
    speculative twins collapse via cancel; steal targets are staged."""
    out = []
    dispatched: Set[Coord] = set()
    resolved: Set[Coord] = set()
    expired: Set[Coord] = set()
    inflight: Dict[Coord, int] = {}
    twins: Dict[Coord, int] = {}        # open speculative pairs per coord
    quarantined: Set[int] = set()

    def bad(msg, hint):
        out.append(Violation("happens-before", art.label, msg, hint))

    def check_group(ev, c, g):
        if g is not None and g in quarantined:
            bad(f"{c} {ev} to quarantined group {g}",
                "a quarantined group is drained and must receive no "
                "further work — route dispatch/steal/speculation "
                "through health.healthy() only")

    for ev, c, g in _entries(art.trace):
        if ev == "dispatch":
            if c in dispatched:
                bad(f"{c} dispatched twice without an intervening expire",
                    "re-dispatch must go through the watchdog protocol: "
                    "record ('expire', c) before the second attempt "
                    "(a quarantine-released STAGED block was never "
                    "dispatched, so its later launch is a first "
                    "dispatch)")
            missing = [d for d in art.deps.get(c, ()) if d not in resolved]
            if missing:
                bad(f"{c} dispatched before dep(s) {missing} resolved",
                    "a block's propagated priors come from its deps — "
                    "gate dispatch on _dep_state readiness, never on "
                    "phase position alone")
            check_group(ev, c, g)
            dispatched.add(c)
            inflight[c] = inflight.get(c, 0) + 1
        elif ev == "expire":
            if not inflight.get(c) or c in resolved:
                bad(f"{c} expired while not in flight",
                    "the watchdog may only expire a dispatched, "
                    "unresolved attempt")
            inflight[c] = max(0, inflight.get(c, 0) - 1)
            expired.add(c)
        elif ev == "redispatch":
            if c not in expired:
                bad(f"{c} redispatched without an expired attempt",
                    "watchdog re-dispatch must be totally ordered with "
                    "the expiry it replaces: record ('expire', c) first")
            check_group(ev, c, g)
            expired.discard(c)
            inflight[c] = inflight.get(c, 0) + 1
        elif ev == "speculate":
            if not inflight.get(c):
                bad(f"{c} speculated while not in flight",
                    "speculative re-dispatch hedges a LIVE straggler — "
                    "twin only blocks with an unresolved in-flight "
                    "attempt")
            check_group(ev, c, g)
            inflight[c] = inflight.get(c, 0) + 1
            twins[c] = twins.get(c, 0) + 1
        elif ev == "cancel":
            if not twins.get(c):
                bad(f"{c} cancelled without an open speculative twin",
                    "cancel collapses a speculate pair — record "
                    "('speculate', c, g) before either side may cancel")
            twins[c] = max(0, twins.get(c, 0) - 1)
            inflight[c] = max(0, inflight.get(c, 0) - 1)
        elif ev == "steal":
            if inflight.get(c):
                bad(f"{c} stolen while in flight",
                    "steal targets must be STAGED blocks — an in-flight "
                    "block's handles live on the victim group and "
                    "cannot move; wait for expiry or speculation")
            if c in resolved:
                bad(f"{c} stolen after resolving",
                    "a resolved block has left the scheduler — the "
                    "steal scanned a stale staged slot")
            check_group(ev, c, g)
        elif ev == "quarantine":
            if g is None:
                bad(f"quarantine event for {c} carries no group",
                    "quarantine is a group-level event: record "
                    "('quarantine', trigger_coord, g)")
            elif g in quarantined:
                bad(f"group {g} quarantined twice",
                    "a quarantined group stays quarantined — "
                    "note_expiry must not re-trip on a drained group")
            else:
                quarantined.add(g)
        elif ev == "resolve":
            if c not in dispatched:
                bad(f"{c} resolved without a dispatch",
                    "every outcome must come from a recorded dispatch — "
                    "a resolve out of nowhere means the executor "
                    "committed a stale or foreign buffer")
            if c in resolved:
                bad(f"{c} resolved twice",
                    "double commit: the commit guard must run exactly "
                    "once per block")
            if twins.get(c):
                bad(f"{c} resolved with an open speculative twin",
                    "a speculative resolve must cancel its twin: record "
                    "('cancel', c, loser_group) for the losing side "
                    "before committing the deterministic winner")
            expired.discard(c)     # terminal retire of an expired attempt
            inflight[c] = max(0, inflight.get(c, 0) - 1)
            resolved.add(c)
        else:
            bad(f"unknown trace event {ev!r} for {c}",
                f"executor traces may only contain {_EVENTS}")
    for c in art.deps:
        if c not in resolved:
            bad(f"{c} never resolved",
                "the run ended with an unresolved block — the executor "
                "dropped an in-flight handle or lost a retire path")
    for c in sorted(expired):
        bad(f"{c} left with an expired attempt neither redispatched nor "
            f"retired",
            "an expiry must be followed by a redispatch or a terminal "
            "retire before the run ends")
    for c in sorted(k for k, n in twins.items() if n):
        bad(f"{c} left with an uncollapsed speculative twin",
            "every speculate pair must end in exactly one cancel — the "
            "run finished with both twins still live")
    return out


def _window_occupancy(art: TraceArtifact) -> List[Violation]:
    """In-flight (and staged) blocks never exceed the streaming window
    bound G·W·(depth+1)."""
    if art.window_bound is None:
        return []
    out = []
    live: Dict[Coord, int] = {}
    peak = 0
    for ev, c, _ in _entries(art.trace):
        if ev in ("dispatch", "redispatch", "speculate"):
            live[c] = live.get(c, 0) + 1
        elif ev in ("resolve", "expire", "cancel"):
            live[c] = max(0, live.get(c, 0) - 1)
        peak = max(peak, sum(live.values()))
    if peak > art.window_bound:
        out.append(Violation(
            "window-occupancy", art.label,
            f"{peak} blocks in flight exceeds the window bound "
            f"{art.window_bound} (G*W*(depth+1))",
            "the streaming window must stay bounded for the flat-memory "
            "claim to hold — a chunk was dispatched without waiting for "
            "a window slot"))
    if art.reported_peak is not None and art.reported_peak > art.window_bound:
        out.append(Violation(
            "window-occupancy", art.label,
            f"executor-reported peak_window_blocks={art.reported_peak} "
            f"exceeds the bound {art.window_bound}",
            "staged + in-flight chunks together must fit "
            "G*W*(depth+1) blocks — the prefetch staged past its slot"))
    return out


register(Pass(
    "happens-before", "trace",
    "every dep resolves before its dependent dispatches; watchdog "
    "re-dispatch is totally ordered with the expired attempt; every "
    "block resolves exactly once; no work reaches a quarantined group; "
    "speculative twins collapse via cancel; steal targets are staged",
    _happens_before))

register(Pass(
    "window-occupancy", "trace",
    "in-flight (and staged) blocks never exceed the streaming window "
    "bound G*W*(depth+1)",
    _window_occupancy))


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


def _graph_validation(art: GraphArtifact) -> List[Violation]:
    return check_graph(art.deps, art.resolved, label=art.label)


register(Pass(
    "graph-validation", "graph",
    "the phase graph is acyclic, fully reachable, and every dep exists "
    "(in-graph or pre-resolved)",
    _graph_validation))
