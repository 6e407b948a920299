"""Runtime guards — the dynamic complements of the static passes (port of
``repro.analysis.guards``)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_host_transfers():
    """Fail loudly on any call inside the block that makes the host wait
    for the card (``torch.cuda.set_sync_debug_mode("error")``): the runtime
    twin of the 'host-callback' pass. The previous mode is restored on
    exit. The PP engine's contract is that a dispatch and the aggregation
    never read the card back:

        with guards.no_host_transfers():
            PP._aggregate_axis(part, posts, axis="row")

    Warm the path first: a first call's lazy initialisation may
    synchronize."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
