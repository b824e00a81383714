"""Shared neural building blocks of the LM substrate (port of
`repro.models.common`): init, RMS norm, rotary embeddings, the plain
grouped-query attention, the SwiGLU MLP and the chunked next-token
cross-entropy; for the audio family (`repro_torch.models.whisper`) the
LayerNorm, the sinusoidal positions and the tanh GELU.

Each computes what its `repro` counterpart computes, in the same layouts
(heads as (B, S, H, hd), dense weights as (in, out)), so weights and
activations carry between the packages unchanged. `attention_ref` is the
plain path of every attention call that has no kernel (ring-cache
decode) and the plain version of the K4 kernel
(`repro_torch.kernels.ref.flash_attention_ref`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import prng

# --------------------------------------------------------------------- init


def dense_init(key, shape, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """`repro.models.common.dense_init`: normal(key, shape) * scale, with
    scale 1/sqrt(fan_in) unless given."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (prng.normal(key, shape) * scale).to(dtype)


def embed_init(key, shape, dtype=torch.float32) -> torch.Tensor:
    """`repro.models.common.embed_init`: normal(key, shape) * 0.02."""
    return (prng.normal(key, shape) * 0.02).to(dtype)


# --------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in fp32, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """`repro.models.common.layer_norm`: over the last axis in fp32, the
    mean, then the mean of the squared centred values (two passes, as
    `repro` computes them, not ``F.layer_norm``'s one-pass statistics),
    scaled and shifted, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    x = xc * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the two halves of each head (not interleaved pairs), in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------- sinusoidal positions

#: XLA:CPU's float32 exp (jaxlib 0.9; its LLVM IR and the fused
#: multiply-adds of the compiled object): the input clamped to [LO, HI],
#: n = floor(x log2 e + 1/2) in [-127, 127], x - n ln 2 in two parts, a
#: degree-5 polynomial, times 2^n
_EXP_CLAMP = (-87.80000305175781, 88.80000305175781)
_EXP_LOG2E = 1.4426950216293335
_EXP_LN2 = (0.693359375, -0.00021219444170128554)
_EXP_POLY = (0.00019875691214110702, 0.001398199936375022,
             0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
             0.5)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp with the bits of XLA:CPU's, on the CPU and on CUDA
    (each fused multiply-add rounded once, `prng._fma`). ``torch.exp``
    differs from it by an ulp on some inputs, and the sinusoidal
    frequencies multiply that error by the position (1,499 at whisper's
    frames): 1.2e-4 in the embedding."""
    x = x.float().clamp(*_EXP_CLAMP)
    n = torch.floor(prng._fma(x, _EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = prng._fma(-n, _EXP_LN2[0], x)
    r = prng._fma(-n, _EXP_LN2[1], r)
    y = prng._fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        y = prng._fma(y, r, c)
    y = prng._fma(y, r * r, r) + 1.0
    # 2^n from its exponent bits, as XLA builds it
    return y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """`repro.models.common.sinusoidal_positions`: positions (..., S) ->
    (..., S, d_model) float32, [sin(p f), cos(p f)] with frequencies
    f_i = exp(-i ln(10000) / max(half - 1, 1)). The frequencies take
    XLA's exp bits (`xla_exp`); sin and cos are computed in float64 and
    rounded, within an ulp of the C library's float32 ones that `repro`
    calls."""
    half = d_model // 2
    arg = -torch.arange(half, dtype=torch.float32, device=positions.device) \
        * (math.log(10000.0) / max(half - 1, 1))
    ang = (positions[..., None].float() * xla_exp(arg)).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ----------------------------------------------------------------- attention

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_chunk: int = 1024) -> torch.Tensor:
    """Grouped-query attention with absolute-position masking.

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd)
    q_pos: (Sq,) or (B, Sq); kv_pos: (B, Sk) absolute positions, -1 =
    invalid (ring-buffer slots not yet written). window: tokens attend to
    positions in (q_pos - window, q_pos]. Masked scores are -1e30, so a
    row with no valid key averages all of them, as `repro`'s does.

    Products are exact fp32 products of the stored values, summed in
    fp32, as `repro`'s einsums with an fp32 accumulator compute them
    (bf16 operands are widened first: PyTorch has no portable fp32
    accumulator type for a bf16 product); the probabilities are rounded
    to v's dtype before the second product, as in `repro`.
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :].expand(B, Sq)
    qg = q.reshape(B, Sq, Hkv, rep, hd)
    kf, vf = k.float(), v.float()

    def chunk_attn(qc, qp):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qc.float(), kf) * scale
        mask = kv_pos[:, None, :] >= 0
        if causal:
            mask = mask & (kv_pos[:, None, :] <= qp[:, :, None])
        if window is not None:
            mask = mask & (kv_pos[:, None, :] > qp[:, :, None] - window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), vf)
        return o.to(q.dtype)

    if Sq > q_chunk and Sq % q_chunk == 0:
        out = torch.cat([chunk_attn(qc, qp) for qc, qp in
                         zip(qg.split(q_chunk, dim=1),
                             q_pos.split(q_chunk, dim=1))], dim=1)
    else:
        out = chunk_attn(qg, q_pos)
    return out.reshape(B, Sq, Hq, hd)


# ---------------------------------------------------------------------- mlp


def swiglu(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: x/2 (1 + tanh(sqrt(2/pi)
    (x + 0.044715 x^3))), one fused op."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------- loss


def chunked_softmax_xent(logits_fn, x: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, n_chunks: int = 8):
    """Next-token CE computed over sequence chunks to bound logits memory
    (`repro.models.common.chunked_softmax_xent`).

    logits_fn: (B, c, d) -> (B, c, V) (the unembedding); x: (B, S, d);
    labels: (B, S) int; mask: (B, S) {0, 1} float or bool. One chunk
    when S % n_chunks != 0. A Python loop over the chunks where `repro`
    runs ``lax.scan``; under autograd each chunk's fp32 logits are kept
    for the backward, as the scan keeps them.
    Returns (mean_loss, total_weight), fp32 scalars.
    """
    B, S, _ = x.shape
    if S % n_chunks != 0:
        n_chunks = 1
    c = S // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    wsum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xs, ls = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        ms = mask[:, i * c:(i + 1) * c].float()
        logits = logits_fn(xs).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, ls[..., None].long())[..., 0]
        nll = (lse - picked) * ms
        tot = tot + nll.sum()
        wsum = wsum + ms.sum()
    return tot / torch.clamp(wsum, min=1.0), wsum
