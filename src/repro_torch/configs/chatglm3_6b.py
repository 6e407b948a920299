"""ChatGLM3-6B — dense, GQA kv=2, 2d/partial RoPE (rotary applied to half the
head dim). [arXiv:2406.12793]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="[arXiv:2406.12793]",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=65_024,
    rope_partial=0.5,      # ChatGLM rotates half of head_dim ("RoPE 2d")
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
