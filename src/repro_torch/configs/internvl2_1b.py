"""InternVL2-1B — VLM: InternViT frontend (STUB per assignment carve-out;
``input_specs()`` provides patch embeddings (B, 256, d_model)) + Qwen2-0.5B
style LM backbone. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="[arXiv:2404.16821]",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    n_image_tokens=256,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
