"""Granite-4.0-H-Micro — Mamba2 and attention layers, each followed by a
shared SwiGLU MLP.

[ibm-granite/granite-4.0-h-micro config.json, ``granitemoehybrid``]
40 layers in the config's ``layer_types`` order (5 mamba, attention, 9
mamba, attention, 9 mamba, attention, 9 mamba, attention, 4 mamba),
d_model 2048. Mamba2: expand 2 (d_inner 4096), 64 heads of 64, d_state
128, one group, conv 4 with a bias, chunk 256, no projection bias, gated
RMSNorm. Attention: 32 query and 8 KV heads of 64, no bias, no
positional encoding, softmax scale 0.015625. The shared MLP's width is
8192. Embeddings times 12, every mixer's and MLP's output times 0.22
before its residual add, logits divided by 8; RMSNorm eps 1e-5, tied
embeddings, vocabulary 100,352.

Not in the port's registry (`configs.REGISTRY` mirrors `repro`'s, which
has no such family): `DecoderLM` builds it from `CONFIG`, or from a
`GraniteConfig` cut to the benchmark's size.
"""
from dataclasses import dataclass
from typing import Tuple

from .base import ArchConfig

SOURCE = ("https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/"
          "main/config.json")
#: the published ``layer_types``
LAYER_TYPES = (("mamba",) * 5 + ("attention",) + ("mamba",) * 9
               + ("attention",) + ("mamba",) * 9 + ("attention",)
               + ("mamba",) * 9 + ("attention",) + ("mamba",) * 4)
KINDS = ("mamba", "attention")


@dataclass(frozen=True)
class GraniteConfig(ArchConfig):
    """`ArchConfig` with Granite-4.0-H's settings as fields: each layer's
    mixer, no rotary positions, the Mamba2 conv's bias, the softmax scale
    and the three multipliers. They are this class's alone: the paths
    every family shares (`models.lm`, `models.ssm`) read them with
    ``getattr`` and a default that leaves other models as they are."""
    layer_types: Tuple[str, ...] = ()
    use_rope: bool = False
    ssm_conv_bias: bool = True
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0

    def __post_init__(self):
        if len(self.layer_types) != self.n_layers or \
                set(self.layer_types) - set(KINDS):
            raise ValueError(f"granite: layer_types {self.layer_types} must "
                             f"give one of {KINDS} for each of the "
                             f"{self.n_layers} layers")

    @property
    def is_decoder_only(self) -> bool:
        return True

    @property
    def supports_long_context(self) -> bool:
        return False


CONFIG = GraniteConfig(
    name="granite-4.0-h-micro", family="granite",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=100352, norm_eps=1e-5, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, ssm_conv=4,
    layer_types=LAYER_TYPES, source=SOURCE)
