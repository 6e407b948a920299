"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="[arXiv:2401.04088]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,            # per-expert
    vocab_size=32_000,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
)
