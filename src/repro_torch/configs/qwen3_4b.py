"""Qwen3-4B — dense, GQA + qk_norm.

[hf:Qwen/Qwen3-8B family] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, head_dim=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)
