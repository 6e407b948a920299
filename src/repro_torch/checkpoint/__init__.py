"""Host-side checkpoints of the port: pytrees of tensors and the phase
graph's per-block posterior store (``ckpt``)."""
