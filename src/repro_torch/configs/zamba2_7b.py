"""Zamba2-7B — hybrid: Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]

81 Mamba2 layers; a single weight-tied (shared) full-attention transformer
block follows every ``shared_attn_period`` Mamba2 layers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="[arXiv:2411.15242]",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,         # shared block is MHA (kv=32)
    head_dim=112,          # 3584 / 32
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_period=6,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
