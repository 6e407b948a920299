"""Llama-3-8B — dense, GQA kv=8, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="[arXiv:2407.21783]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    norm_eps=1e-5,
)
