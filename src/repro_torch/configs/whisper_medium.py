"""Whisper-medium — encoder-decoder audio transformer, conv frontend stubbed.

[arXiv:2212.04356] 24L d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096
vocab=51865. We implement 24 encoder + 24 decoder layers; the mel+conv
frontend is a stub providing (B, 1500, d_model) frame embeddings.
Positional encoding is sinusoidal-any-length (adaptation: the real model's
learned 448-position decoder embedding cannot express the assigned decode
shapes; noted in DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64, mlp_type="gelu",
    n_audio_frames=1500,
    source="Whisper [arXiv:2212.04356]",
)
