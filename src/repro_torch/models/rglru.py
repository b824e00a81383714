"""RG-LRU recurrent blocks (Griffin / RecurrentGemma; port of
`repro.models.rglru`). [arXiv:2402.19427]

`linear_scan_ref` (the recurrence in plain PyTorch, step by step) lives
in `repro_torch.kernels.ref`, beside the other plain versions, and is
re-exported here under `repro`'s name. The prefill's recurrence runs
through `kernels.ops.rglru_scan`: the K6 kernel on the card,
`linear_scan_ref` on the CPU. Decode runs the plain one-step update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import linear_scan_ref  # noqa: F401  (repro's name)
from .common import dense_init, rms_norm
from .ssm import depthwise_causal_conv

Cache = Dict[str, torch.Tensor]

RGLRU_C = 8.0


def rglru(v: torch.Tensor, p, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence over v (B, S, W), in float32 whatever v's
    dtype; ``p`` holds wa, ba, wx, bx and lam (a `RecLayer`). Without h0
    the recurrence is `ops.rglru_scan` from a zero state (the prefill);
    with h0 (B, W) and one step it is the plain update ``a * h0 + b``
    (decode: `repro`'s one-step scan computes ``b + a * h0``, the same
    rounding), with more steps `ops.rglru_scan` from h0. Returns (out in
    v's dtype, h_last (B, W) float32)."""
    vf = v.float()
    r = torch.sigmoid(vf @ p.wa.float() + p.ba)
    i = torch.sigmoid(vf @ p.wx.float() + p.bx)
    log_a = -RGLRU_C * F.softplus(p.lam) * r                # (B, S, W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * vf)
    if h0 is not None and v.shape[1] == 1:
        h = a * h0[:, None, :] + gated
        h_last = h[:, 0]
    else:
        h, h_last = ops.rglru_scan(a, gated, h0)
    return h.to(v.dtype), h_last


def init_rec_block(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s recurrent-block init for ``key``, on the key's device. wa,
    ba, wx, bx and lam are float32 whatever ``dtype`` is, as in `repro`;
    w_out is drawn from ``key`` itself, not from one of its splits."""
    d, W = cfg.d_model, cfg.lru_width
    ks = prng.split(key, 6)
    dev = key.device
    # Lambda init so that a ~ U[0.9, 0.999]^c (Griffin's stable init)
    u = prng.uniform(ks[5], (W,), 0.9, 0.999)
    lam = torch.log(torch.exp(-torch.log(u) / RGLRU_C) - 1.0)  # softplus^-1
    return {
        "ln": torch.ones((d,), dtype=dtype, device=dev),
        "w_gate": dense_init(ks[0], (d, W), dtype),
        "w_lin": dense_init(ks[1], (d, W), dtype),
        "conv_w": dense_init(ks[2], (cfg.ssm_conv, W), dtype, scale=0.2),
        "wa": dense_init(ks[3], (W, W), torch.float32),
        "ba": torch.zeros((W,), dtype=torch.float32, device=dev),
        "wx": dense_init(ks[4], (W, W), torch.float32),
        "bx": torch.zeros((W,), dtype=torch.float32, device=dev),
        "lam": lam,
        "w_out": dense_init(key, (W, d), dtype),
    }


def rec_block(p, x: torch.Tensor, cfg: ArchConfig,
              cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Griffin recurrent block; x: (B, S, d), ``p`` a `RecLayer`. Without a
    cache (prefill) the recurrence is the K6 scan over the S steps and the
    block returns the serving cache {"h": (B, W) float32, "conv": (B, K-1,
    W)}, the last K-1 *pre*-conv rows of v (no SiLU after the conv, unlike
    the Mamba2 block); S < K-1 raises ``ValueError``, since that cache
    cannot be built (`repro` returns None there, and its decode then runs
    without state). With a cache (decode, S == 1) the block runs the plain
    one-step update and writes the cache in place. Returns (y, cache)."""
    S = x.shape[1]
    K = cfg.ssm_conv
    xn = rms_norm(x, p.ln, cfg.norm_eps)
    y = F.gelu(xn @ p.w_gate, approximate="tanh")
    v = xn @ p.w_lin

    if cache is None:
        if S < K - 1:
            raise ValueError(
                f"rec_block: a prefill of {S} tokens cannot fill the conv "
                f"cache of {K - 1} rows; prompts need >= {K - 1} tokens")
        conv_cache = v[:, S - (K - 1):, :].contiguous()
        out, h_last = rglru(depthwise_causal_conv(v, p.conv_w), p)
        cache = {"h": h_last, "conv": conv_cache}
    else:
        conv_in = torch.cat([cache["conv"], v], dim=1)      # (B, K, W)
        v_t = torch.einsum("bkw,kw->bw", conv_in, p.conv_w)[:, None]
        out, h_last = rglru(v_t, p, h0=cache["h"])
        cache["h"].copy_(h_last)
        cache["conv"].copy_(conv_in[:, 1:])

    return x + (y * out) @ p.w_out, cache


def init_rec_cache(cfg: ArchConfig, batch: int, dtype,
                   device=None) -> Cache:
    """An empty decode cache: a zero float32 state and zero conv rows."""
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }
