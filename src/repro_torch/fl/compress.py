"""Codecs for the compressed peer exchange (port of `repro.fl.compress`
on one device).

* ``identity``: lossless; normalizes to None, so a run with it runs the
  very code of a run without a codec.
* ``topk``: magnitude sparsification. Each client transmits the
  k = ceil(topk_frac * P) largest-|.| coordinates of its flattened
  params as (value, index) pairs; error-feedback (EF) residuals carry
  what was dropped into the next round.
* ``int8``: stochastic uniform quantization to ``quant_bits`` bits with
  a per-model fp32 scale (unbiased: E[decode] = input).

What travels each round is ``C(x_k + e_k)``. Receivers mix the decoded
peer models while every client keeps its own model exact (the Eq.-4
self term never moves, so it is never compressed), and the GGC refresh
probes the decoded peers: one download serves both. Bytes per download
are static per codec (`bytes_per_model`), Python-int arithmetic.

Not ported: the client-mesh branches of `compress_exchange` and
`sparse_mix_compressed` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import prng
from ..analysis.registry import exchange_site
from ..kernels import ops as _kops
from ..kernels.ref import densify_topk

CODECS = ("identity", "topk", "int8")


@dataclass(frozen=True)
class CompressionConfig:
    """Peer-exchange codec (`repro.fl.compress.CompressionConfig`).

    codec:          one of CODECS.
    topk_frac:      topk only: fraction of P transmitted, in (0, 1].
    quant_bits:     int8 only: wire bits per coordinate, in [2, 8]
                    (storage stays int8; bytes charge ``quant_bits``).
    error_feedback: lossy codecs only: carry the compression residual
                    into the next round's encode.
    """
    codec: str = "identity"
    topk_frac: float = 0.1
    quant_bits: int = 8
    error_feedback: bool = True

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"codec must be one of {CODECS}, "
                             f"got {self.codec!r}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")
        if not 2 <= self.quant_bits <= 8:
            raise ValueError(f"quant_bits must be in [2, 8], "
                             f"got {self.quant_bits}")


def lossless(cfg) -> bool:
    """True when ``cfg`` compresses nothing (None or identity)."""
    return cfg is None or cfg.codec == "identity"


def normalize(cfg):
    """None for a lossless codec, else ``cfg``: identity runs the code of
    the codec-free path."""
    return None if lossless(cfg) else cfg


def uses_ef(cfg) -> bool:
    return not lossless(cfg) and cfg.error_feedback


def topk_k(cfg, n_params: int) -> int:
    """Transmitted coordinates per model: ceil(frac * P), in [1, P]."""
    return max(1, min(n_params, int(math.ceil(cfg.topk_frac * n_params))))


def bytes_per_model(cfg, n_params: int) -> int:
    """Wire bytes of one transmitted model (None: raw fp32)."""
    if lossless(cfg):
        return 4 * n_params
    if cfg.codec == "topk":
        return 8 * topk_k(cfg, n_params)        # fp32 value + int32 index
    # int8: quant_bits per coordinate + one fp32 scale per model
    return (n_params * cfg.quant_bits + 7) // 8 + 4


# ------------------------------------------------------------------ codecs


def encode(cfg, x, key):
    """x: (N, P) client-stacked flattened params -> payload dict. ``key``
    feeds the int8 stochastic rounding (topk is deterministic)."""
    if cfg.codec == "topk":
        k = topk_k(cfg, x.shape[1])
        idx = torch.topk(x.abs(), k, dim=1).indices
        return {"vals": x.gather(1, idx), "idx": idx.to(torch.int32)}
    if cfg.codec == "int8":
        levels = (1 << (cfg.quant_bits - 1)) - 1
        scale = torch.clamp_min(x.abs().amax(dim=1) / levels, 1e-30)
        y = x / scale[:, None]                   # in [-levels, levels]
        lo = torch.floor(y)
        up = prng.uniform(key, x.shape) < (y - lo)
        q = torch.clamp(lo + up, -levels, levels)  # guards fp edges only
        return {"q": q.to(torch.int8), "scale": scale}
    raise ValueError(cfg.codec)


def decode(cfg, payload, n_params: int):
    """payload -> the dense (N, P) fp32 table a receiving peer rebuilds."""
    if cfg.codec == "topk":
        return densify_topk(payload["vals"], payload["idx"], n_params)
    if cfg.codec == "int8":
        return payload["q"].float() * payload["scale"][:, None]
    raise ValueError(cfg.codec)


def compress_exchange(cfg, flat, ef, key):
    """One round's transmit side: encode the error-compensated models.

    flat: (N, P); ef: (N, P) residuals, or None with EF off. Returns
    ``(payload, dec, new_ef)``: the wire payload, the decoded (N, P)
    models every receiver rebuilds, and the residuals ``xin - dec``
    (None when ``ef`` is)."""
    xin = flat + ef if ef is not None else flat
    payload = encode(cfg, xin, key)
    dec = decode(cfg, payload, flat.shape[1])
    new_ef = xin - dec if ef is not None else None
    return payload, dec, new_ef


# ------------------------------------------------------------------ mixing


@exchange_site(charges="caller")
def _mix_int8_offdiag(A_off, dec):
    """Off-diagonal Eq.-4 term for the int8 codec: the decoded models
    through the standard graph_mix kernel."""
    return _kops.graph_mix(A_off.contiguous(), dec.contiguous())


@exchange_site(charges="caller")
def mix_compressed(cfg, A, flat, payload, dec):
    """Eq.-4 mixing over compressed peers: the off-diagonal terms use the
    decoded payloads, the self term the client's exact local model (a
    client never downloads, or compresses, the model it holds). topk
    goes through `kernels.ops.compressed_graph_mix`, so the peers' dense
    (N, P) table is never built for the mix; int8 mixes ``dec``."""
    N = A.shape[0]
    diag = torch.diagonal(A)
    A_off = A * (1.0 - torch.eye(N, dtype=A.dtype, device=A.device))
    if cfg.codec == "topk":
        off = _kops.compressed_graph_mix(
            A_off.contiguous(), payload["vals"].contiguous(),
            payload["idx"].contiguous(), flat.shape[1])
    elif cfg.codec == "int8":
        off = _mix_int8_offdiag(A_off, dec)
    else:
        raise ValueError(cfg.codec)
    return off + diag[:, None] * flat


@exchange_site(charges="caller")
def sparse_mix_compressed(cfg, self_w, nbr_w, nbr_idx, flat, payload, dec):
    """Neighbor-list Eq.-4 mixing over compressed peers: the <= B
    selected peer rows are decoded payloads (``dec``, already rebuilt
    for the GGC probes), the self term the exact local model (the
    sparse_graph_mix kernel with ``W_peers = dec``). ``payload`` is the
    wire payload, which only the client-mesh exchange (not ported)
    reads."""
    del cfg, payload
    return _kops.sparse_graph_mix(
        self_w.float().contiguous(), nbr_w.float().contiguous(),
        nbr_idx.to(torch.int32).contiguous(), flat.contiguous(),
        dec.contiguous())
