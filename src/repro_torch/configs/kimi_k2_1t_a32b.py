"""Kimi K2 — trillion-parameter MoE (paper-table scale).

[arXiv:2501.kimi2] 61L d_model=7168 64H (GQA kv=8 per assignment table)
expert d_ff=2048 vocab=163840, MoE 384e top-8. The real model uses MLA;
the assignment table pins GQA kv=8, which we follow.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    n_experts=384, topk=8, d_expert_ff=2048, rope_theta=1e6,
    source="Kimi K2 [arXiv:2501.kimi2]",
)
