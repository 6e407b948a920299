"""Optimizer of the LLM training path: AdamW with global-norm clipping, and
learning-rate schedules (port of ``repro/optim``)."""
