"""Model zoo: the DPFL classifiers and, for the dense, moe, vlm, SSM and
hybrid families, the decoder-only LM built from its config
(`build_model`)."""
from ..configs.base import ArchConfig
from .classifier import MLP, PaperCNN, accuracy, xent_loss
from .common import dense_init
from .lm import DecoderLM


def build_model(cfg: ArchConfig, device=None, **kw) -> DecoderLM:
    """`repro.models.build_model` for the families the port serves and
    trains (dense, moe, vlm, SSM and hybrid); the audio family (`repro`'s
    ``WhisperModel``) raises ``NotImplementedError`` naming ROADMAP item
    14d-4, part 5."""
    return DecoderLM(cfg, device=device, **kw)


__all__ = ["build_model", "DecoderLM", "MLP", "PaperCNN", "accuracy",
           "dense_init", "xent_loss"]
