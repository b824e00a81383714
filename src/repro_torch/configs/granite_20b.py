"""Granite-20B code model — llama-arch per assignment table, MQA (kv=1).

[arXiv:2405.04324] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    rope_theta=1e4,
    source="Granite Code [arXiv:2405.04324]",
)
