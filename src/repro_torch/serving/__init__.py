"""Posterior serving layer (port of ``repro.serving``): the trained
``PPResult`` as a live artifact.

  store    — ``PosteriorStore``: U/V moment summaries + S item-factor
             posterior sample slots, built from any executor's
             ``PPResult`` on its device.
  scoring  — the batched scoring path: gather → fold-in conditional →
             ``U_u @ V_meanᵀ`` (or a per-request posterior draw) →
             seen-item masking → stable top-k; plus ``scoring_budget``.
  router   — ``MicroBatchRouter``: coalesces requests under a latency
             budget into fixed shape-bucketed batches
             (``partition.coalesce_shapes`` over padded request shapes)
             and dispatches them to scoring workers.
"""
from repro_torch.serving.store import PosteriorStore               # noqa: F401
from repro_torch.serving.scoring import (                          # noqa: F401
    RequestBatch, score_topk, scoring_budget)
from repro_torch.serving.router import (                           # noqa: F401
    MicroBatchRouter, Request, ScoringWorker)
