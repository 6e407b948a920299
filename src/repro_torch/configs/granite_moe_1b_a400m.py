"""Granite-3.0-1B-A400M — fine-grained MoE, 32 experts top-8, per-expert
d_ff=512. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,              # per-expert
    vocab_size=49_155,
    n_experts=32,
    experts_per_token=8,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
