"""Collective, reuse and plan passes: collective confinement with
per-comm-mode budgets, donation effectiveness, recompilation budget (port
of ``repro.analysis.hlo_passes``).

The reference counts collective instructions in a chain's HLO text, where
the sweep body appears once. The port counts the calls a chain made to its
``core.topology.Group`` (``record_collectives``) over a known number of
sweeps, so the per-sweep count is the total over the sweeps.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

from repro_torch.analysis.registry import (CommArtifact, Pass, PlanArtifact,
                                           ReuseArtifact, Violation, register)

# Per-comm-mode collective budgets per sweep, one to one with the
# reference's (all-gather -> all_gather, all-reduce -> psum, reduce-scatter
# -> psum_scatter; its psum of (Lambda, eta) lowers to 2 all-reduces as the
# port's makes 2 psum calls), plus one ``broadcast`` of V per U-step: the
# reference's shard_map gets a replicated V for free, a single-controller
# group copies it to its slots (``core.distributed._sharded_u_sampler``).
#   gather  — the U-step all-gathers the sampled U row shards.
#   psum    — the V-step psums its (Lambda, eta) partial statistics, plus
#             the U-step's gather.
#   scatter — the V-step psum-scatters the statistics and all-gathers the
#             sampled shard, plus the U-step's gather.
# comm=None (single-slot chains) allows NO collectives: same-phase blocks
# never talk.
COLLECTIVE_BUDGETS: Dict[Optional[str], Dict[str, int]] = {
    None: {},
    "gather": {"broadcast": 1, "all_gather": 1},
    "psum": {"broadcast": 1, "all_gather": 1, "psum": 2},
    "scatter": {"broadcast": 1, "all_gather": 2, "psum_scatter": 2},
}


def default_budget(comm: Optional[str]) -> Dict[str, int]:
    """The comm mode's per-sweep collective budget."""
    if comm not in COLLECTIVE_BUDGETS:
        raise ValueError(f"unknown comm mode {comm!r} "
                         f"(expected {sorted(COLLECTIVE_BUDGETS, key=str)})")
    return dict(COLLECTIVE_BUDGETS[comm])


def _collective_confinement(art: CommArtifact) -> List[Violation]:
    out = []
    # (1) every collective runs over one of the topology's groups: a group
    # built by hand (or spanning two groups' slots) crosses the block axis
    if art.allowed_groups is not None:
        allowed = {(int(g), tuple(d)) for g, d in art.allowed_groups}
        for c in art.calls:
            if (c.group, tuple(c.devices)) not in allowed:
                out.append(Violation(
                    "collective-confinement", art.label,
                    f"{c.op} over group {c.group} {list(c.devices)} is none "
                    f"of the topology's groups "
                    f"{[[g, list(d)] for g, d in sorted(allowed)]}",
                    "blocks never talk during a phase — run every "
                    "collective on Topology.slots(g) of the block's own "
                    "group"))
    # (2) per-comm-mode budget: the mode dictates which collectives a sweep
    # may call, and how many
    budget = default_budget(art.comm)
    sweeps = max(1, int(art.sweeps))
    for op, n in sorted(Counter(c.op for c in art.calls).items()):
        cap = budget.get(op, 0)
        if n > cap * sweeps:
            out.append(Violation(
                "collective-confinement", art.label,
                f"{n} {op} call(s) over {sweeps} sweep(s) "
                f"({n / sweeps:g} per sweep) in a comm={art.comm!r} chain "
                f"(budget {cap} per sweep)",
                f"comm={art.comm!r} allows only {budget or 'no collectives'}"
                f" per sweep — an extra collective means a factor update "
                f"is re-reducing stats it should keep shard-local "
                f"(see distributed.COMM_MODES)"))
    return out


register(Pass(
    "collective-confinement", "comm",
    "every collective runs over one of the topology's groups and the comm "
    "mode's per-sweep collective budget holds",
    _collective_confinement))


def _donation_effectiveness(art: ReuseArtifact) -> List[Violation]:
    """The counterpart of XLA's donation is the streaming window's
    explicit slot reuse: every plane a group's window hands a chain lives
    in one of that window's slot storages (``depth + 1``, plus the slots
    grown on rebalance), so distinct planes number at most its slots.
    Membership, not a count of distinct pointers: planes allocated per
    chunk and freed after it may come back at the same addresses. The
    reference's U0/V0 ``must_alias`` has no counterpart: the port's factor
    steps allocate each new U and V."""
    out = []
    stray: Dict[int, int] = {}
    chunks: Dict[int, int] = {}
    for g, key in art.handed:
        g = int(g)
        own = {p for slot in art.slots.get(g, ()) for p in slot}
        chunks[g] = chunks.get(g, 0) + 1
        stray[g] = stray.get(g, 0) + (not set(key) <= own)
    for g, n in sorted(stray.items()):
        if n:
            out.append(Violation(
                "donation-effectiveness", art.label,
                f"group {g}'s window handed {n} of its {chunks[g]} chunk(s) "
                f"planes outside its {len(art.slots.get(g, ()))} slot(s)",
                "a chunk's planes must be views of a window slot "
                "(_Window.planes) — fresh planes per chunk turn the flat "
                "streaming memory into one allocation per chunk"))
    return out


register(Pass(
    "donation-effectiveness", "reuse",
    "every plane the streaming window hands a chain lives in one of its "
    "slots (depth + 1 per group, plus those grown on rebalance) — buffers "
    "are recycled, never allocated per chunk",
    _donation_effectiveness))


def _recompilation_budget(art: PlanArtifact) -> List[Violation]:
    distinct = sorted({repr(s) for s in art.signatures})
    if len(distinct) <= art.cap:
        return []
    return [Violation(
        "recompilation-budget", art.label,
        f"plan implies {len(distinct)} distinct executable shapes "
        f"(cap {art.cap}): {distinct[:4]}{'...' if len(distinct) > 4 else ''}",
        "bucket blocks to shared shapes before dispatch — "
        "partition.coalesce_shapes merges near-size buckets under a "
        "max_waste bound, and BlockShapes.per_phase caps the grid at one "
        "shape per phase tag")]


register(Pass(
    "recompilation-budget", "plan",
    "a partition + coalesce_shapes plan implies at most `cap` distinct "
    "executable shapes",
    _recompilation_budget))
