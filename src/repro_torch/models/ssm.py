"""Mamba2 (SSD, state-space duality) blocks (port of `repro.models.ssm`).
[arXiv:2405.21060]

`segsum` and `ssd_ref` (the chunked SSD scan in plain PyTorch) live in
`repro_torch.kernels.ref`, beside the other plain versions, and are
re-exported here under `repro`'s names. The prefill's scan runs through
`kernels.ops.ssd`: the K5 kernel on the card, `ssd_ref` on the CPU.
Decode runs `ssd_decode_step`, `repro`'s plain one-token update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import segsum, ssd_ref  # noqa: F401  (repro's names)
from .common import dense_init, rms_norm

Cache = Dict[str, torch.Tensor]


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor,
                    dlogA_t: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. h: (b, h, p, n); x_t: (b, h, p); dlogA_t:
    (b, h); B_t, C_t: (b, n). Returns (y_t (b, h, p), h')."""
    dec = torch.exp(dlogA_t)[..., None, None]
    h = h * dec + torch.einsum("bhp,bn->bhpn", x_t, B_t)
    y = torch.einsum("bhpn,bn->bhp", h, C_t)
    return y, h


# -------------------------------------------------------------- mamba2 block


def depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) -> the causal depthwise conv (B, S, C):
    out[:, t] = sum_k w[k] x[:, t - K + 1 + k] with zeros before the
    start, a cross-correlation as `repro`'s ``conv_general_dilated``
    computes it. Written as K shifted products in exact fp32 (no cuDNN,
    so no TF32)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * w[k]
    return out


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, SSM heads, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, H, conv_dim


def init_mamba_block(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s Mamba2 block init for ``key``, on the key's device. A_log,
    D and dt_bias are float32 whatever ``dtype`` is, as in `repro`."""
    d = cfg.d_model
    d_in, H, conv_dim = mamba_dims(cfg)
    ks = prng.split(key, 5)
    dev = key.device
    return {
        "ln": torch.ones((d,), dtype=dtype, device=dev),
        "in_proj": dense_init(ks[0], (d, 2 * d_in + 2 * cfg.ssm_state + H),
                              dtype),
        "conv_w": dense_init(ks[1], (cfg.ssm_conv, conv_dim), dtype,
                             scale=0.2),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(ks[2], (d_in, d), dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_in, H, _ = mamba_dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def mamba_block(p, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, S, d); ``p`` holds the block's weights under `repro`'s names
    (a `repro_torch.models.lm.MambaLayer`). Without a cache (prefill) the
    scan is `ops.ssd` over the S steps and the block returns the serving
    cache {"h": (B, H, hd, n) fp32, "conv": (B, K-1, conv_dim)}, the last
    K-1 *pre*-conv projections; S < K-1 raises ``ValueError``, since that
    cache cannot be built (`repro` returns None there, and its decode then
    runs without state). With a cache (decode, S == 1) the block runs
    `ssd_decode_step` and writes the cache in place. Returns (y, cache)."""
    B_, S, _ = x.shape
    d_in, H, _ = mamba_dims(cfg)
    n, hd, K = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
    xn = rms_norm(x, p.ln, cfg.norm_eps)
    zxbcdt = xn @ p.in_proj
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    dt = F.softplus(dt.float() + p.dt_bias)                 # (B, S, H)
    A = -torch.exp(p.A_log)                                 # (H,)

    if cache is None:
        if S < K - 1:
            raise ValueError(
                f"mamba_block: a prefill of {S} tokens cannot fill the "
                f"conv cache of {K - 1} rows; prompts need >= {K - 1} "
                f"tokens")
        conv_cache = xBC[:, S - (K - 1):, :].contiguous()
        xBC = F.silu(depthwise_causal_conv(xBC, p.conv_w))
        xs = xBC[..., :d_in].reshape(B_, S, H, hd)
        Bmat = xBC[..., d_in:d_in + n].float()
        Cmat = xBC[..., d_in + n:].float()
        x_dt = xs.float() * dt[..., None]
        y, h_last = ops.ssd(x_dt, dt * A, Bmat, Cmat, cfg.ssm_chunk)
        y = y + p.D[None, None, :, None] * xs.float()
        cache = {"h": h_last, "conv": conv_cache}
    else:
        conv_in = torch.cat([cache["conv"], xBC], dim=1)    # (B, K, C)
        xBC_t = F.silu(torch.einsum("bkc,kc->bc", conv_in, p.conv_w))
        # the conv state stores *pre*-conv projections, as the prefill's
        xs = xBC_t[:, :d_in].reshape(B_, H, hd)
        Bt = xBC_t[:, d_in:d_in + n].float()
        Ct = xBC_t[:, d_in + n:].float()
        dt1 = dt[:, 0]                                      # (B, H)
        y, h = ssd_decode_step(cache["h"], xs.float() * dt1[..., None],
                               dt1 * A, Bt, Ct)
        y = (y + p.D[None, :, None] * xs.float())[:, None]  # (B, 1, H, hd)
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_in[:, 1:])

    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.norm_w, cfg.norm_eps)
    return x + y @ p.out_proj, cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Cache:
    """An empty decode cache: a zero state and zero conv rows."""
    _, H, conv_dim = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, H, cfg.ssm_headdim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
