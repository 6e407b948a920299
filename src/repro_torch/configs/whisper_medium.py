"""Whisper-medium — encoder-decoder; the mel + conv frontend is a stub:
a batch carries precomputed frame embeddings ``audio_embeds`` (B, 1500,
d_model). [arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="[arXiv:2212.04356]",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,    # encoder layers (whisper-medium: 24+24)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    n_audio_frames=1500,
    norm_eps=1e-5,
    tie_embeddings=True,
)
