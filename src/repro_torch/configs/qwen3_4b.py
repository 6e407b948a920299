"""Qwen3-4B — dense, GQA, qk-norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B]",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)
