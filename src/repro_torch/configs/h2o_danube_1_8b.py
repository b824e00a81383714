"""H2O-Danube-1.8B — llama+mistral mix with native sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
SWA window 4096 (native => long_500k runs without a variant).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    attn_window=4096, rope_theta=1e4,
    source="H2O-Danube [arXiv:2401.16818]",
)
