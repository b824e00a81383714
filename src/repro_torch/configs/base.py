"""Architecture configuration dataclasses (the port's copy of
`repro.configs.base`; tests/test_torch_lm.py holds the two equal).

Every assigned architecture gets a module in this package defining
``CONFIG = ArchConfig(...)`` with the exact assignment-table values and a
source citation. ``reduced()`` produces the CPU-smoke variant (<=2 layers,
d_model<=512, <=4 experts) mandated for per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""

    head_dim: Optional[int] = None  # default: d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # Sliding-window attention. None => full causal. For dense archs this is
    # only activated for the long_500k shape via `with_window` (see DESIGN.md).
    attn_window: Optional[int] = None
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    d_expert_ff: int = 0
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ---
    # pattern unit applied cyclically over layers; 'rec' = RG-LRU block,
    # 'attn' = local-attention block.
    hybrid_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 0

    # --- encoder-decoder (audio) ---
    n_enc_layers: int = 0
    n_audio_frames: int = 1500  # stubbed conv-frontend output length

    # --- VLM ---
    n_vision_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"

    # ----------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "ssm", "hybrid")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic natively (SSM / hybrid-local-attn / native SWA)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.attn_window is not None
        )

    def padded_vocab(self, multiple: int = 2048) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def with_window(self, window: int = 4096) -> "ArchConfig":
        """Sliding-window variant (used so dense archs can lower long_500k)."""
        return dataclasses.replace(self, attn_window=window)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, max(1, heads // 2)) if self.n_kv_heads else 0
        kw = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
            dtype="float32",
        )
        if self.family == "moe":
            kw.update(n_experts=4, topk=2, d_expert_ff=128)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(lru_width=d, local_window=32, n_layers=3)
        if self.family == "audio":
            kw.update(n_enc_layers=2, n_audio_frames=16)
        if self.family == "vlm":
            kw.update(n_vision_tokens=8)
        if self.attn_window:
            kw.update(attn_window=32)
        return self.replace(**kw)
