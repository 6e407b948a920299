"""Minitron-8B — width-pruned Nemotron-4. [arXiv:2407.14679]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    source="[arXiv:2407.14679]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=256_000,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
