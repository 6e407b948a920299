"""RWKV6-7B (Finch) — attention-free, data-dependent decay linear recurrence.
[arXiv:2404.05892]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="[arXiv:2404.05892]",
    n_layers=32,
    d_model=4096,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=14_336,
    vocab_size=65_536,
    wkv_head_dim=64,       # 64 wkv heads of size 64
    norm_eps=1e-5,
)
