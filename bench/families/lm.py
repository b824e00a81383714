"""The LM family: DPFL over decoder-LM clients (the port's `DecoderLM` of
a dense Qwen3-style config: GQA with qk-norm, rotary positions, SwiGLU,
a tied head) on `bench.data.lm_federated_data`'s bigram corpora.

The program side is the LM example's glue, frozen here: a one-client
next-token loss and accuracy (`examples/lm_dpfl_torch.py` ``lm_loss``,
``lm_acc``) through `repro_torch.fl.engine.vmap_clients`, the model
built on "meta" with no activation recompute and one loss chunk, its
weights drawn on the device by the engine's init. The rest is the
yardstick: the model FLOPs a round counts, and `RefModel`, the plain
float64 transformer the check runs one client model at a time, with the
program's flat layout (the state dict's leaves in sorted-key order,
(in, out) weights).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import data as _data
from .papercnn import _margins

REF_BLOCK = 1
REWARD_BLOCK = 1


def arch(cfg: dict) -> dict:
    """The configuration's model under the port's `ArchConfig` names."""
    m = cfg["model"]
    return dict(
        name=cfg["name"], family="dense", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], head_dim=m["head_dim"], qk_norm=True,
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]),
        dtype=m["torch_dtype"])


def make_data(cfg: dict, seed: int):
    d = cfg["data"]
    return _data.lm_federated_data(
        seed, cfg["clients"], d["vocab"], d["seq_len"], d["n_seqs"],
        d["n_clusters"], tuple(d["split"]))


def lm_loss(model, batch):
    """One client's next-token cross-entropy over its (b, T + 1) tokens."""
    loss, _ = model.loss({"tokens": batch["x"]})
    return loss


def lm_acc(model, batch):
    """One client's next-token argmax accuracy."""
    from repro_torch.models.common import rms_norm

    toks = batch["x"]
    x = model._embed(toks[:, :-1])
    q_pos = torch.arange(x.shape[1], device=x.device)
    h, _ = model._apply_stack(x, q_pos)
    h = rms_norm(h, model.final_norm, model.cfg.norm_eps)
    return (model._logits(h).argmax(-1) == toks[:, 1:]).float().mean()


def make_engine(cfg: dict, data, device):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.fl.engine import FLEngine, vmap_clients
    from repro_torch.models import build_model

    model = build_model(ArchConfig(**arch(cfg)), device="meta",
                        remat="none", loss_chunks=1)
    return FLEngine(model, data, loss_fn=vmap_clients(model, lm_loss),
                    acc_fn=vmap_clients(model, lm_acc), device=device,
                    **cfg["train"])


# ------------------------------------------------------------------ FLOPs


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one sequence's forward (``seq_len`` positions): two
    per multiply-add of every projection, the MLP and the head, and the
    attention's two products over the causal pairs (4 hd a pair and
    head, as K4's ``work`` counts them)."""
    m, S = cfg["model"], cfg["data"]["seq_len"]
    d, hd = m["hidden_size"], m["head_dim"]
    hq, hkv, ff = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["intermediate_size"])
    per_layer = d * hq * hd * 2 + d * hkv * hd * 2 + 3 * d * ff
    linear = m["num_hidden_layers"] * per_layer + d * m["vocab_size"]
    attn = m["num_hidden_layers"] * 4 * hq * hd * S * (S + 1) // 2
    return 2 * linear * S + attn


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s in layout(cfg))


def round_flops(cfg: dict, omega_sizes: List[int]) -> float:
    """The model FLOPs one round counts: every sequence of every epoch of
    the local train (forward and backward: three forwards' worth, the
    embedding's input gradient included), four reward forwards on the
    validation split for each candidate of each Omega_k, one evaluation
    forward, and the Eq.-4 mix over Omega."""
    d = cfg["data"]
    N, bs = cfg["clients"], cfg["train"]["batch_size"]
    n_train, n_val = d["split"][0], d["split"][1] - d["split"][0]
    fwd = forward_flops(cfg)
    local = N * cfg["dpfl"]["tau_train"] * (n_train // bs) * bs * 3 * fwd
    greedy = 4 * sum(omega_sizes) * n_val * fwd
    evaluation = N * n_val * fwd
    mixing = 2 * n_params(cfg) * (N + sum(omega_sizes))
    return float(local + greedy + evaluation + mixing)


# -------------------------------------------------------------- reference


def layout(cfg: dict):
    """(key, shape) of each leaf in the flat row's order (sorted keys)."""
    m = cfg["model"]
    d, hd = m["hidden_size"], m["head_dim"]
    hq, hkv, ff = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["intermediate_size"])
    shapes = {"tok_embed": (m["vocab_size"], d), "final_norm": (d,)}
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        shapes.update({
            p + "ln1": (d,), p + "ln2": (d,),
            p + "attn.wq": (d, hq * hd), p + "attn.wk": (d, hkv * hd),
            p + "attn.wv": (d, hkv * hd), p + "attn.wo": (hq * hd, d),
            p + "attn.q_norm": (hd,), p + "attn.k_norm": (hd,),
            p + "wi_gate": (d, ff), p + "wi_up": (d, ff),
            p + "wo_mlp": (ff, d)})
    return [(k, shapes[k]) for k in sorted(shapes)]


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta: float):
    """Rotate the two halves of each head (b, S, H, hd) by position."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=x.dtype,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class RefModel:
    """The plain float64 decoder of the configuration, one model at a
    time over G stacked models."""

    def __init__(self, cfg: dict):
        self.m = cfg["model"]
        self.layout = layout(cfg)
        self.sizes = [math.prod(s) for _, s in self.layout]

    def unflatten(self, flat) -> Dict[str, torch.Tensor]:
        parts = torch.split(flat, self.sizes, dim=-1)
        return {k: part.reshape(flat.shape[:-1] + s)
                for (k, s), part in zip(self.layout, parts)}

    def flatten(self, params) -> torch.Tensor:
        G = params[self.layout[0][0]].shape[0]
        return torch.cat([params[k].reshape(G, -1) for k, _ in self.layout],
                         dim=1)

    def leaf_norms(self, flat) -> torch.Tensor:
        return torch.stack([part.norm(dim=-1) for part in
                            torch.split(flat, self.sizes, dim=-1)], dim=-1)

    @staticmethod
    def inputs(x, device) -> torch.Tensor:
        """(G, b, T + 1) token rows as int64 on ``device``."""
        return torch.as_tensor(np.asarray(x)).to(device, torch.int64)

    def _logits(self, p, toks):
        """One model's (b, T, V) logits of tokens (b, T + 1)."""
        m = self.m
        hq, hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                       m["head_dim"])
        eps, theta = float(m["rms_norm_eps"]), float(m["rope_theta"])
        x = p["tok_embed"][toks[:, :-1]]
        b, S, _ = x.shape
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for i in range(m["num_hidden_layers"]):
            L = {k[len(f"layers.{i}."):]: v for k, v in p.items()
                 if k.startswith(f"layers.{i}.")}
            h = _rms(x, L["ln1"], eps)
            q = _rope(_rms((h @ L["attn.wq"]).reshape(b, S, hq, hd),
                           L["attn.q_norm"], eps), theta)
            k = _rope(_rms((h @ L["attn.wk"]).reshape(b, S, hkv, hd),
                           L["attn.k_norm"], eps), theta)
            v = (h @ L["attn.wv"]).reshape(b, S, hkv, hd)
            k = k.repeat_interleave(hq // hkv, dim=2)
            v = v.repeat_interleave(hq // hkv, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, S, hq * hd)
            x = x + o @ L["attn.wo"]
            h = _rms(x, L["ln2"], eps)
            x = x + (F.silu(h @ L["wi_gate"]) * (h @ L["wi_up"])) @ L["wo_mlp"]
        x = _rms(x, p["final_norm"], eps)
        return x @ p["tok_embed"].T

    def loss(self, params, x, y) -> torch.Tensor:
        """(G,) mean next-token cross-entropy of each model on its token
        rows ``x`` (G, b, T + 1); ``y`` is unused."""
        out = []
        for g in range(x.shape[0]):
            p = {k: v[g] for k, v in params.items()}
            logits = self._logits(p, x[g])
            out.append(F.cross_entropy(logits.flatten(0, 1),
                                       x[g][:, 1:].flatten()))
        return torch.stack(out)

    def correct(self, params, x, y):
        """(sure, maybe), (G, b T) bool, of each next-token prediction."""
        sure, maybe = [], []
        for g in range(x.shape[0]):
            p = {k: v[g] for k, v in params.items()}
            s, m_ = _margins(self._logits(p, x[g]).flatten(0, 1),
                             x[g][:, 1:].flatten())
            sure.append(s)
            maybe.append(m_)
        return torch.stack(sure), torch.stack(maybe)
