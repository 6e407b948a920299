"""Pass-based static invariant analyzer for the PP engine (port of
``repro.analysis``).

The paper's performance claims rest on structural invariants —
communication confined within blocks, no materialized (N, M, K)
intermediates, buffers recycled, dependency-safe dispatch. This package is
their single enforcement layer: a registry of ``Pass`` objects, each
analyzing ONE artifact kind, that every executor and kernel enrolls in via
``launch/bmf_lint.py``. The pass names are the reference's; the artifact
kinds are the port's own (see ``registry``):

  ops    what one call ran (``optrace``): materialization budget, dtype
         promotion, host reads (``op_passes``)
  comm   the collectives a chain called (``core.topology``): confinement
         to the topology's groups and per-comm-mode budgets
         (``comm_passes``)
  reuse  the streaming window's plane hand-outs: donation effectiveness
         (``comm_passes``)
  trace  executor dispatch/resolve event traces: happens-before, window
         occupancy (``trace_passes``)
  graph  ``build_phase_graph`` output: cycles, unreachable blocks,
         dangling deps (``trace_passes``; the engine runs this pass before
         any dispatch)
  plan   ``partition`` + ``coalesce_shapes`` plans: recompilation budget
         (``comm_passes``)

``analyze(artifact)`` runs every registered pass of the artifact's kind
and returns the violations; ``guards`` holds the runtime complement
(``no_host_transfers``).
"""
from repro_torch.analysis.registry import (  # noqa: F401
    KINDS, CommArtifact, GraphArtifact, OpArtifact, Pass, PlanArtifact,
    ReuseArtifact, TraceArtifact, Violation, analyze, get_pass, passes,
    register,
)
from repro_torch.analysis import optrace       # noqa: F401
from repro_torch.analysis import op_passes     # noqa: F401  (registers passes)
from repro_torch.analysis import comm_passes   # noqa: F401
from repro_torch.analysis import trace_passes  # noqa: F401
from repro_torch.analysis import guards        # noqa: F401
