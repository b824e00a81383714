"""Qwen3-0.6B — dense, GQA + qk_norm.

[hf:Qwen/Qwen3-8B family] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, head_dim=128, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)
