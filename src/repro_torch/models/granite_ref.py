"""A plain reference of Granite-4.0-H (``granitemoehybrid``, the dense
variant: no experts), for the tests that hold `DecoderLM`'s granite
family to it.

Plain ``torch`` in the weights' dtype (float32 in the tests), written
from the published description (the model's ``config.json`` and the
Transformers implementation of ``GraniteMoeHybridForCausalLM``): no
kernel of the port, no cache, no batching over clients, no JAX. Every
layer is ``x += r * mixer(rms(x))``, then ``x += r * mlp(rms(x))``, r
the ``residual_multiplier``; the mixer is Mamba2 or attention by the
layer's ``layer_types`` entry. Mamba2: in_proj to (z, xBC, dt), a
causal depthwise conv of ``ssm_conv`` taps plus its bias, SiLU, dt =
softplus(dt + dt_bias), A = -exp(A_log), the selective scan run step by
step (h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t + D x_t,
one group: B and C shared by every head), the gated RMSNorm
rms(y silu(z)) over all of d_inner, out_proj. Attention: GQA with no
positional encoding and the softmax scale ``attention_multiplier``. The
MLP is SwiGLU. Embeddings times ``embedding_multiplier``, logits (the
tied embedding's transpose) over ``logits_scaling``.

Departures from the published model, none of them in the mathematics:
the weights are the port's state dict (its names; (in, out) matrices,
the conv's taps as (K, conv_dim) where Transformers keeps (conv_dim, 1,
K), the same cross-correlation); the vocabulary is whatever rows
``tok_embed`` holds (the benchmark's slice); dt is not clamped (the
published ``time_step_limit`` is (0, inf), which clamps nothing).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def mamba(L: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The Mamba2 mixer of one layer's weights ``L`` on normed x (b, S, d)."""
    b, S, _ = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    n, hd, K = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
    H = d_in // hd
    zxbcdt = x @ L["in_proj"]
    z, xBC, dt = zxbcdt.split([d_in, d_in + 2 * n, H], dim=-1)
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(pad[:, k:k + S] * L["conv_w"][k] for k in range(K))
    if "conv_b" in L:
        conv = conv + L["conv_b"]
    xBC = F.silu(conv)
    xs, Bm, Cm = xBC.split([d_in, n, n], dim=-1)
    xs = xs.reshape(b, S, H, hd)
    dt = F.softplus(dt + L["dt_bias"])                       # (b, S, H)
    A = -torch.exp(L["A_log"])                               # (H,)
    h = x.new_zeros((b, H, hd, n))
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xs[:, t] * dt[:, t, :, None], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    y = torch.stack(ys, 1) + L["D"][:, None] * xs             # (b, S, H, hd)
    y = rms(y.reshape(b, S, d_in) * F.silu(z), L["norm_w"], cfg.norm_eps)
    return y @ L["out_proj"]


def attention(L: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Causal GQA of one layer's weights ``L`` on normed x (b, S, d): no
    positional encoding, scores times ``attention_multiplier``."""
    b, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ L["attn.wq"]).reshape(b, S, hq, hd)
    k = (x @ L["attn.wk"]).reshape(b, S, hkv, hd)
    v = (x @ L["attn.wv"]).reshape(b, S, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.attention_multiplier
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, S, hq * hd) \
        @ L["attn.wo"]


def logits(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """(b, S, V) logits of tokens (b, S) under ``params`` (a granite
    `DecoderLM`'s state dict) and ``cfg`` (its `GraniteConfig`)."""
    eps, r = cfg.norm_eps, cfg.residual_multiplier
    x = params["tok_embed"][tokens] * cfg.embedding_multiplier
    for i, kind in enumerate(cfg.layer_types):
        pre = f"layers.{i}."
        L = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        if kind == "mamba":
            x = x + mamba(L, rms(x, L["ln"], eps), cfg) * r
        else:
            x = x + attention(L, rms(x, L["ln1"], eps), cfg) * r
        h = rms(x, L["ln2"], eps)
        x = x + (F.silu(h @ L["wi_gate"]) * (h @ L["wi_up"])) @ L["wo_mlp"] \
            * r
    x = rms(x, params["final_norm"], eps)
    return x @ params["tok_embed"].T / cfg.logits_scaling


def loss(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens (b, T + 1)."""
    out = logits(params, cfg, tokens[:, :-1])
    return F.cross_entropy(out.flatten(0, 1), tokens[:, 1:].flatten())
