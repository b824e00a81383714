"""Mamba2-370m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 48L d_model=1024 d_state=128 vocab=50280; expand=2
(d_inner=2048), headdim=64 (32 ssm heads), conv width 4, chunk 256.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, ssm_conv=4,
    source="Mamba2 / SSD [arXiv:2405.21060]",
)
