"""RecurrentGemma-9B — Griffin: RG-LRU + local attention, pattern 1:2.

[arXiv:2402.19427] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Pattern unit (rec, rec, attn); local attention window 2048; lru width 4096.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    hybrid_pattern=("rec", "rec", "attn"), lru_width=4096, local_window=2048,
    rope_theta=1e4,
    source="RecurrentGemma / Griffin [arXiv:2402.19427]",
)
