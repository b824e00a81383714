"""The granite family: DPFL over Granite-4.0-H clients (the port's
`DecoderLM` of its granite family: Mamba2 and GQA mixers in the config's
``layer_types`` order, each followed by a shared SwiGLU MLP, no
positional encoding, the embedding, residual and logit multipliers, a
tied head) on `bench.corpus.bigram_federated_data`'s corpora.

The configuration file holds the published ``config.json``'s keys at its
top level, as the model's source gives them, with the cut ones changed:
``num_hidden_layers`` (the first layers of ``layer_types``, which stays
whole) and ``vocab_size`` (the ids are drawn from the slice, and the
loss and the argmax are over it), and ``torch_dtype``.

The program side is the LM glue (`bench.families.lm`'s one-client
next-token loss and accuracy) through `repro_torch.fl.engine.
vmap_clients`, the model built on "meta" with no activation recompute
and one loss chunk, its weights drawn on the device by the engine's
init, the engine's client chunk from the configuration's ``engine``
group. The rest is the
yardstick: the model FLOPs a round counts, and `RefModel`, the plain
float64 model the check runs one client model at a time (the SSD scan
in its chunked dual form, the attention as a masked softmax), with the
program's flat layout (the state dict's leaves in sorted-key order,
(in, out) weights). It imports nothing of the port.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import corpus
from .lm import lm_acc, lm_loss
from .papercnn import _margins

#: one client at a time in every stage of the reference (a client's
#: float64 model is 6.2 GB at the cell's size)
REF_BLOCK = 1
REWARD_BLOCK = 1


def _check_published(m: dict):
    """The published switches the port's granite family runs: one SSM
    group, heads of the published count, no experts, no biases."""
    heads = m["mamba_expand"] * m["hidden_size"] // m["mamba_d_head"]
    if m["mamba_n_groups"] != 1 or m["mamba_n_heads"] != heads or \
            m["num_local_experts"] or m["attention_bias"] or \
            m["mamba_proj_bias"]:
        raise ValueError("granite: the family runs one SSM group, "
                         "d_inner / d_head heads, no experts and no "
                         "projection biases")


def layer_types(m: dict):
    return tuple(m["layer_types"][:m["num_hidden_layers"]])


def arch(cfg: dict) -> dict:
    """The configuration's model under the port's `GraniteConfig` names."""
    m = cfg
    _check_published(m)
    return dict(
        name=cfg["name"], family="granite",
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m["hidden_size"] // m["num_attention_heads"],
        d_ff=m["shared_intermediate_size"], vocab_size=m["vocab_size"],
        norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]),
        rope_theta=float(m["rope_theta"]),
        ssm_state=m["mamba_d_state"], ssm_expand=m["mamba_expand"],
        ssm_headdim=m["mamba_d_head"], ssm_chunk=m["mamba_chunk_size"],
        ssm_conv=m["mamba_d_conv"], layer_types=layer_types(m),
        use_rope=m["position_embedding_type"] != "nope",
        ssm_conv_bias=bool(m["mamba_conv_bias"]),
        attention_multiplier=float(m["attention_multiplier"]),
        embedding_multiplier=float(m["embedding_multiplier"]),
        residual_multiplier=float(m["residual_multiplier"]),
        logits_scaling=float(m["logits_scaling"]), dtype=m["torch_dtype"])


def make_data(cfg: dict, seed: int):
    # a program without the granite family cannot run the cell: fail
    # before the inputs are made
    import repro_torch.configs.granite_4_0_h_micro  # noqa: F401

    d = cfg["data"]
    return corpus.bigram_federated_data(
        seed, cfg["clients"], cfg["vocab_size"], d["seq_len"], d["n_seqs"],
        d["n_clusters"], tuple(d["split"]), d["successors"], d["alpha"])


def make_engine(cfg: dict, data, device):
    from repro_torch.configs.granite_4_0_h_micro import GraniteConfig
    from repro_torch.fl.engine import FLEngine, vmap_clients
    from repro_torch.models import build_model

    if torch.device(device).type == "cuda":
        # the round's panels are 12.35 GB each, allocated and freed in
        # turn: grown segments keep the pool from fragmenting
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")
    model = build_model(GraniteConfig(**arch(cfg)), device="meta",
                        remat="none", loss_chunks=1)
    return FLEngine(model, data, loss_fn=vmap_clients(model, lm_loss),
                    acc_fn=vmap_clients(model, lm_acc), device=device,
                    client_chunk=cfg["engine"]["client_chunk"],
                    **cfg["train"])


# ------------------------------------------------------------------ FLOPs


def ssd_flops(m: dict, S: int) -> int:
    """The least FLOPs of one sequence's scan (`bench.work_k5.k5_work`'s
    count: the causal scores once for the heads, then per head the
    scores times x, the chunk states and the carried-in states)."""
    from ..work_k5 import k5_work

    H = m["mamba_expand"] * m["hidden_size"] // m["mamba_d_head"]
    return k5_work(1, S, H, m["mamba_d_head"], m["mamba_d_state"],
                   m["mamba_chunk_size"])[1]


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one sequence's forward (``seq_len`` positions): two
    per multiply-add of every projection, the conv, the MLPs and the
    head; the scan's (`ssd_flops`); the attention's two products over
    the causal pairs (4 hd a pair and head, as K4's ``work``)."""
    m, S = cfg, cfg["data"]["seq_len"]
    d, V, ff = m["hidden_size"], m["vocab_size"], \
        m["shared_intermediate_size"]
    hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = d // hq
    d_in, n = m["mamba_expand"] * d, m["mamba_d_state"]
    H = d_in // m["mamba_d_head"]
    conv_dim = d_in + 2 * n
    mlp = 3 * d * ff
    mamba = d * (2 * d_in + 2 * n + H) + m["mamba_d_conv"] * conv_dim \
        + d_in * d + mlp
    attn = d * hq * hd * 2 + d * hkv * hd * 2 + mlp
    kinds = layer_types(m)
    linear = kinds.count("mamba") * mamba + kinds.count("attention") * attn \
        + d * V
    pairs = 4 * hq * hd * S * (S + 1) // 2
    return 2 * linear * S + kinds.count("mamba") * ssd_flops(m, S) \
        + kinds.count("attention") * pairs


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s in layout(cfg))


def round_flops(cfg: dict, omega_sizes: List[int]) -> float:
    """The model FLOPs one round counts: every sequence of every epoch of
    the local train (forward and backward: three forwards' worth), four
    reward forwards on the validation split for each candidate of each
    Omega_k, one evaluation forward, and the Eq.-4 mix over Omega."""
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
    m = cfg
    d, V, ff = m["hidden_size"], m["vocab_size"], \
        m["shared_intermediate_size"]
    hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = d // hq
    d_in, n = m["mamba_expand"] * d, m["mamba_d_state"]
    H = d_in // m["mamba_d_head"]
    conv_dim = d_in + 2 * n
    shapes = {"tok_embed": (V, d), "final_norm": (d,)}
    for i, kind in enumerate(layer_types(m)):
        p = f"layers.{i}."
        shapes.update({p + "ln2": (d,), p + "wi_gate": (d, ff),
                       p + "wi_up": (d, ff), p + "wo_mlp": (ff, d)})
        if kind == "mamba":
            shapes.update({
                p + "ln": (d,), p + "in_proj": (d, 2 * d_in + 2 * n + H),
                p + "conv_w": (m["mamba_d_conv"], conv_dim),
                p + "A_log": (H,), p + "D": (H,), p + "dt_bias": (H,),
                p + "norm_w": (d_in,), p + "out_proj": (d_in, d)})
            if m["mamba_conv_bias"]:
                shapes[p + "conv_b"] = (conv_dim,)
        else:
            shapes.update({
                p + "ln1": (d,), p + "attn.wq": (d, hq * hd),
                p + "attn.wk": (d, hkv * hd), p + "attn.wv": (d, hkv * hd),
                p + "attn.wo": (hq * hd, d)})
    return [(k, shapes[k]) for k in sorted(shapes)]


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _scan(x, dA, B, C, L: int):
    """The SSD scan in its chunked dual form: x (b, l, h, p) already times
    dt, dA (b, l, h) the log decays, B and C (b, l, n) shared by the
    heads; zero initial state. Within a chunk, y_i = sum_{j <= i}
    exp(sum_{j < k <= i} dA_k) (C_i . B_j) x_j; across chunks the state
    h = sum_j exp(sum_{k > j} dA_k) x_j B_jᵀ is carried and read as
    exp(cumsum_i) C_i hᵀ."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    c = l // L
    xc = x.reshape(b, c, L, h, p)
    Bc, Cc = B.reshape(b, c, L, n), C.reshape(b, c, L, n)
    cs = dA.reshape(b, c, L, h).permute(0, 3, 1, 2).cumsum(-1)  # (b,h,c,L)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cs[..., :, None] - cs[..., None, :])
                      .masked_fill(~causal, float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bhcij,bcjhp->bcihp", decay * scores[:, None], xc)
    states = torch.einsum("bcjn,bhcj,bcjhp->bchpn", Bc,
                          torch.exp(cs[..., -1:] - cs), xc)
    carry = x.new_zeros((b, h, p, n))
    off = []
    for ci in range(c):
        off.append(torch.einsum("bin,bhi,bhpn->bihp", Cc[:, ci],
                                torch.exp(cs[:, :, ci]), carry))
        carry = carry * torch.exp(cs[:, :, ci, -1])[..., None, None] \
            + states[:, ci]
    return (y + torch.stack(off, 1)).reshape(b, l, h, p)


class RefModel:
    """The plain float64 Granite-4.0-H of the configuration, one model at
    a time over G stacked models (each moved to the tokens' device as it
    runs, so that a panel may wait on the host)."""

    def __init__(self, cfg: dict):
        self.m = cfg
        self.kinds = layer_types(cfg)
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

    def _mamba(self, L, x):
        m = self.m
        b, S, _ = x.shape
        d_in, n, K = m["mamba_expand"] * m["hidden_size"], \
            m["mamba_d_state"], m["mamba_d_conv"]
        hd = m["mamba_d_head"]
        H = d_in // hd
        z, xBC, dt = (x @ L["in_proj"]).split([d_in, d_in + 2 * n, H], -1)
        pad = F.pad(xBC, (0, 0, K - 1, 0))
        conv = sum(pad[:, k:k + S] * L["conv_w"][k] for k in range(K))
        if "conv_b" in L:
            conv = conv + L["conv_b"]
        xs, Bm, Cm = F.silu(conv).split([d_in, n, n], -1)
        xs = xs.reshape(b, S, H, hd)
        dt = F.softplus(dt + L["dt_bias"])
        y = _scan(xs * dt[..., None], dt * -torch.exp(L["A_log"]), Bm, Cm,
                  min(m["mamba_chunk_size"], S))
        y = (y + L["D"][:, None] * xs).reshape(b, S, d_in)
        return _rms(y * F.silu(z), L["norm_w"], float(m["rms_norm_eps"])) \
            @ L["out_proj"]

    def _attention(self, L, x):
        m = self.m
        b, S, d = x.shape
        hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
        hd = d // hq
        q = (x @ L["attn.wq"]).reshape(b, S, hq, hd)
        k = (x @ L["attn.wk"]).reshape(b, S, hkv, hd)
        v = (x @ L["attn.wv"]).reshape(b, S, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * \
            float(m["attention_multiplier"])
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(
            b, S, hq * hd) @ L["attn.wo"]

    def _logits(self, p, toks):
        """One model's (b, T, V) logits of tokens (b, T + 1)."""
        m = self.m
        eps, r = float(m["rms_norm_eps"]), float(m["residual_multiplier"])
        x = p["tok_embed"][toks[:, :-1]] * float(m["embedding_multiplier"])
        for i, kind in enumerate(self.kinds):
            pre = f"layers.{i}."
            L = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
            if kind == "mamba":
                x = x + self._mamba(L, _rms(x, L["ln"], eps)) * r
            else:
                x = x + self._attention(L, _rms(x, L["ln1"], eps)) * r
            h = _rms(x, L["ln2"], eps)
            x = x + (F.silu(h @ L["wi_gate"]) * (h @ L["wi_up"])) \
                @ L["wo_mlp"] * r
        x = _rms(x, p["final_norm"], eps)
        return x @ p["tok_embed"].T / float(m["logits_scaling"])

    def _one(self, params, g, device):
        """Model g of ``params`` on ``device``. The reference's products
        run with TF32 off (set here, where the check computes, and not
        when a model is built: the program may still be running)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {k: v[g].to(device) for k, v in params.items()}

    def loss(self, params, x, y) -> torch.Tensor:
        """(G,) mean next-token cross-entropy of each model on its token
        rows ``x`` (G, b, T + 1); ``y`` is unused."""
        out = []
        for g in range(x.shape[0]):
            logits = self._logits(self._one(params, g, x.device), x[g])
            out.append(F.cross_entropy(logits.flatten(0, 1),
                                       x[g][:, 1:].flatten()))
        return torch.stack(out)

    def correct(self, params, x, y):
        """(sure, maybe), (G, b T) bool, of each next-token prediction."""
        sure, maybe = [], []
        for g in range(x.shape[0]):
            s, m_ = _margins(self._logits(self._one(params, g, x.device),
                                          x[g]).flatten(0, 1),
                             x[g][:, 1:].flatten())
            sure.append(s)
            maybe.append(m_)
        return torch.stack(sure), torch.stack(maybe)
