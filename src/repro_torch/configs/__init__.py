"""Config registry: ``--arch <id>`` resolution for every assigned arch (the
port's copy of `repro.configs`), and the DPFL paper's CNN."""
from . import (
    granite_20b,
    h2o_danube_1_8b,
    internvl2_2b,
    kimi_k2_1t_a32b,
    mamba2_370m,
    qwen3_0_6b,
    qwen3_4b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    whisper_medium,
)
from .base import ArchConfig
from .paper_cnn import CONFIG, CNNConfig

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        internvl2_2b,
        recurrentgemma_9b,
        qwen3_moe_30b_a3b,
        kimi_k2_1t_a32b,
        qwen3_4b,
        qwen3_0_6b,
        h2o_danube_1_8b,
        whisper_medium,
        mamba2_370m,
        granite_20b,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "CNNConfig", "CONFIG", "REGISTRY", "ARCH_IDS",
           "get_config"]
