"""Qwen3-30B-A3B — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128e top-8, qk_norm, head_dim=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128, qk_norm=True,
    n_experts=128, topk=8, d_expert_ff=768, rope_theta=1e6,
    source="Qwen3-MoE [hf:Qwen/Qwen3-30B-A3B]",
)
