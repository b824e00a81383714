"""InternVL2-2B — InternViT vision frontend (stubbed) + InternLM2-1.8B LM.

[arXiv:2404.16821] Backbone per assignment table: 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553. Vision tokens arrive as precomputed
projector-output embeddings (stub carve-out per assignment).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    rope_theta=1e6, n_vision_tokens=256,
    source="InternVL2 [arXiv:2404.16821]",
)
