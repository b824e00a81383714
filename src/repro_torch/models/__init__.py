"""Model zoo: the DPFL classifiers and, built from its config
(`build_model`), the LM of every family: the decoder-only `DecoderLM`
(dense, moe, vlm, SSM and hybrid) and the audio family's encoder-decoder
`WhisperModel`."""
from ..configs.base import ArchConfig
from .classifier import MLP, PaperCNN, accuracy, xent_loss
from .common import dense_init
from .lm import DecoderLM
from .whisper import WhisperModel


def build_model(cfg: ArchConfig, device=None, **kw):
    """`repro.models.build_model`: the audio family's `WhisperModel` (which
    takes no ``attn_window`` and no ``mesh``, dropped as `repro` drops
    or ignores them), every other family's `DecoderLM` (``attn_window=``
    overrides the config's window, as in `repro`).

    The second positional parameter differs: `repro`'s is
    ``build_model(cfg, mesh)``, this one's ``build_model(cfg, device)``;
    every caller passes either by keyword."""
    if cfg.family == "audio":
        kw.pop("attn_window", None)
        kw.pop("mesh", None)
        return WhisperModel(cfg, device=device, **kw)
    return DecoderLM(cfg, device=device, **kw)


__all__ = ["build_model", "DecoderLM", "WhisperModel", "MLP", "PaperCNN",
           "accuracy", "dense_init", "xent_loss"]
