"""Decoder-only language model, dense, MoE, VLM, SSM and hybrid families
(port of `repro.models.lm`): GQA with optional qk-norm, rotary
embeddings, sliding windows, ring-buffer KV caches, SwiGLU MLPs, top-k
MoE blocks (`repro_torch.models.moe`), a prefix of precomputed vision
embeddings (vlm, whose layers are dense), Mamba2 (SSD) blocks, RG-LRU
recurrent blocks interleaved with local attention (Griffin), Granite-4.0-H
layers (the granite family, `configs.granite_4_0_h_micro`: a Mamba2 or an
attention mixer without rotary positions in each layer's place of
``layer_types``, each followed by a shared SwiGLU MLP, with Granite's
embedding, residual and logit multipliers; not in `repro`) and a tied or
separate output head.

`DecoderLM` is an ``nn.Module`` that owns its weights: one `DenseLayer`,
`MoELayer`, `MambaLayer` or `RecLayer` module per layer, in execution
order, each holding `repro`'s per-layer leaves under `repro`'s names and
layouts ((in, out) dense weights). Its state dict is `repro`'s stacked
tree split by layer ("layers.3.attn.wq" is row 3 of
``params["layers"]["attn"]["wq"]``; a hybrid model's layer i is group g
of block bi of segment si, `hybrid_layout`;
`repro_torch.interop.lm_params_from_jax`). The prefill's attention runs
on the K4 kernel (`kernels.ops.flash_attention`), the SSM prefill's scan
on the K5 kernel (`kernels.ops.ssd`) and the recurrent blocks' prefill
on the K6 kernel (`kernels.ops.rglru_scan`); decode runs the plain
ring-cache `attention_ref` and the plain one-token SSD or RG-LRU updates,
as in `repro`, which has no decode kernel. The MoE blocks are plain
batched products, as in `repro`. Serving runs under
``torch.inference_mode()``. The weights take gradients: `DecoderLM.loss`
trains every family here, each kernel's forward and backward on the card
(K4's, K5's and K6's backwards behind their autograd Functions), the
router's load-balance loss summed over the MoE layers. The audio family
(`repro.models.whisper`) is `repro_torch.models.whisper`.

Built with a ("data", "model") ``mesh``
(`repro_torch.launch.mesh.make_mesh`, one process per shard), the model
serves on `repro`'s ``model`` axis: each MoE layer holds the rank's E / M
experts (expert parallelism, `repro_torch.models.moe.moe_apply`); with
``decode_cache_seqshard`` each attention cache holds the rank's C / M
ring slots, decode combining the ranks' partial softmaxes
(`attn_decode_seqshard`, flash-decoding), and without it (`repro`'s
default) each rank holds its rows' whole rings and decodes over them
alone. A rank runs its block of the batch on ``data`` (with
``moe_data_axes`` ("data",), `repro`'s default; with () the batch is
whole on every rank); every other weight is whole on every rank. The
mesh path serves and trains: `DecoderLM.loss` under a mesh is the whole
batch's, and its gradient on a rank is its block's part
(`repro_torch.launch.steps.make_train_step` sums them over ``data``).
``parallel_block`` is `repro`'s PaLM-style dense block: attention and
the MLP read one norm (ln1), and both sums are added to x.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.meta import RefusedValue
from ..sharding import collectives as coll
from ..sharding.rules import cache_leaf_spec, check_model_mesh, local_block
from .common import (NEG_INF, apply_rope, attention_ref,
                     chunked_softmax_xent, dense_init, embed_init, rms_norm,
                     swiglu)
from .moe import MoE, init_moe
from .rglru import init_rec_block, init_rec_cache, rec_block
from .ssm import (init_mamba_block, init_mamba_cache, mamba_block,
                  mamba_dims, mamba_mixer)

Cache = Dict[str, torch.Tensor]

# ----------------------------------------------------------------- attention


def init_attn(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s attention init for ``key``, on the key's device."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    ks = prng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, Hq * hd), dtype),
        "wk": dense_init(ks[1], (d, Hkv * hd), dtype),
        "wv": dense_init(ks[2], (d, Hkv * hd), dtype),
        "wo": dense_init(ks[3], (Hq * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=key.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=key.device)
    return p


def attn_decode_seqshard(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, cache: Cache,
                         q_pos: torch.Tensor, mesh,
                         window: Optional[int] = None) -> torch.Tensor:
    """Flash-decoding over a KV cache sharded on its sequence over the
    ``model`` axis (`repro`'s ``attn_decode_seqshard``, line for line):
    this rank holds ring slots ``[i Cl, (i + 1) Cl)`` of C = Cl M
    (i its ``model`` coordinate), writes the new row in place when the
    position's slot ``pos % C`` is its own, computes the partial softmax
    over its rows, and one `pmax` and two `psum`s over ``model`` (the
    (B, Hkv, rep) denominator and the (B, Hkv, rep, hd) numerator)
    combine the ranks'.

    q: (B, 1, Hq, hd); k_new, v_new: (B, 1, Hkv, hd); cache k, v: (B, Cl,
    Hkv, hd), pos (B, Cl), this rank's block; q_pos: (1,) the position
    (on the device: the write is a masked select, no host read).
    Returns (B, 1, Hq, hd)."""
    B, _, Hq, hd = q.shape
    Hkv = k_new.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    n_model = coll.axes_size(mesh, "model")
    i = coll.axis_index(mesh, "model")
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    Cl = ck.shape[1]
    pos = q_pos[0]
    lslot = pos % (Cl * n_model) - i * Cl
    in_range = (lslot >= 0) & (lslot < Cl)
    ls = lslot.clamp(0, Cl - 1)[None]
    # the slot's row replaced only where it is this rank's
    ck[:, ls] = torch.where(in_range, k_new, ck[:, ls])
    cv[:, ls] = torch.where(in_range, v_new, cv[:, ls])
    cp[:, ls] = torch.where(in_range, pos.to(cp.dtype), cp[:, ls])
    # partial attention over the local rows, products and sums in fp32
    qg = q.reshape(B, Hkv, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), ck.float()) * scale
    mask = (cp >= 0) & (cp <= pos)
    if window is not None:
        mask = mask & (cp > pos - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = coll.pmax(s.amax(dim=-1), mesh, "model")
    p_ = torch.exp(s - m[..., None])
    l_ = coll.psum(p_.sum(dim=-1), mesh, "model")
    o = torch.einsum("bgrk,bkgd->bgrd", p_.to(cv.dtype).float(), cv.float())
    o = coll.psum(o, mesh, "model") / l_.clamp_min(1e-30)[..., None]
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


def attn_apply(p: "Attention", x: torch.Tensor, cfg: ArchConfig,
               q_pos: torch.Tensor, cache: Optional[Cache] = None,
               window: Optional[int] = None,
               cache_len: Optional[int] = None, seqshard=None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d). q_pos: (S,) int64 absolute positions (decode: (1,)).
    cache: {"k": (B, C, Hkv, hd), "v": ..., "pos": (B, C)} ring buffer or
    None. Without ``cfg.use_rope`` (`GraniteConfig`'s switch; other
    configurations have none and take rotary positions) no rotary
    positions; with ``cfg.attention_multiplier`` (Granite's too; else
    hd^-1/2) the softmax scale is that number. Without
    a cache, the positions are ``arange(S)`` and the attention is the K4
    kernel; given ``cache_len`` it also returns the
    ring cache the prefill leaves (`cache_from_prefill`, from the K and V
    computed here: `repro` computes them a second time for the cache, the
    same values). With a cache, the new rows go to slots ``q_pos % C``,
    written in place, and the attention is `attention_ref` over the ring;
    ``seqshard`` (a mesh) at S = 1 runs `attn_decode_seqshard` over this
    rank's block of the ring instead. Returns (out (B, S, d), cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq).reshape(B, S, Hq, hd)
    k = (x @ p.wk).reshape(B, S, Hkv, hd)
    v = (x @ p.wv).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if getattr(cfg, "use_rope", True):
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    scale = getattr(cfg, "attention_multiplier", None)
    if scale is not None:
        # every attention path scales the scores by hd^-1/2: q carries the
        # rest (Granite's 0.015625 * 8 = 2^-3, exact)
        q = q * (scale * math.sqrt(hd))

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        if cache_len is not None:
            cache = cache_from_prefill(k, v, q_pos, cache_len, window)
    elif seqshard is not None and S == 1:
        out = attn_decode_seqshard(q, k, v, cache, q_pos, seqshard, window)
    else:
        # an indexed assignment (index_put_) has a batching rule, which
        # index_copy_ has not: a decode under torch.func.vmap writes the
        # ring without the per-slice fallback
        slot = q_pos % cache["k"].shape[1]
        cache["k"][:, slot] = k
        cache["v"][:, slot] = v
        cache["pos"][:, slot] = q_pos.to(cache["pos"].dtype)
        out = attention_ref(q, cache["k"], cache["v"], q_pos, cache["pos"],
                            causal=True, window=window)
    return out.reshape(B, S, Hq * hd) @ p.wo, cache


def init_attn_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                    window: Optional[int] = None, device=None) -> Cache:
    """An empty ring cache of C = min(cache_len, window) slots (pos -1)."""
    C = min(cache_len, window) if window else cache_len
    hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, C, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, C, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, C), -1, dtype=torch.int32, device=device),
    }


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                       cache_len: int, window: Optional[int] = None) -> Cache:
    """Build a ring cache of C = min(cache_len, window) slots from
    full-sequence prefill keys and values: all S rows followed by empty
    slots when C >= S, else the last C rows, position i at slot i % C."""
    B, S = k.shape[0], k.shape[1]
    C = min(cache_len, window) if window else cache_len
    if C >= S:
        pad = C - S
        return {
            "k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
            "pos": torch.cat([
                q_pos[None].expand(B, S).to(torch.int32),
                torch.full((B, pad), -1, dtype=torch.int32,
                           device=k.device)], dim=1)}
    # keep the last C entries at their ring slots: row S - C + t goes to
    # slot (S - C + t) % C = (S % C + t) % C, a roll by S % C
    shift = S % C
    idx = torch.arange(S - C, S, dtype=torch.int32, device=k.device)
    return {"k": torch.roll(k[:, S - C:], shift, dims=1),
            "v": torch.roll(v[:, S - C:], shift, dims=1),
            "pos": torch.roll(idx, shift).repeat(B, 1)}


# ------------------------------------------------------------- layer blocks


def init_dense_layer(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s dense-layer init for ``key``, on the key's device."""
    d = cfg.d_model
    ks = prng.split(key, 4)
    return {
        "ln1": torch.ones((d,), dtype=dtype, device=key.device),
        "attn": init_attn(ks[0], cfg, dtype),
        "ln2": torch.ones((d,), dtype=dtype, device=key.device),
        "wi_gate": dense_init(ks[1], (d, cfg.d_ff), dtype),
        "wi_up": dense_init(ks[2], (d, cfg.d_ff), dtype),
        "wo_mlp": dense_init(ks[3], (cfg.d_ff, d), dtype),
    }


def init_moe_layer(key: torch.Tensor, cfg: ArchConfig, dtype,
                   mesh=None) -> Dict:
    """`repro`'s MoE-layer init for ``key``, on the key's device (with a
    mesh, the rank's experts alone: `init_moe`)."""
    d = cfg.d_model
    ks = prng.split(key, 2)
    return {
        "ln1": torch.ones((d,), dtype=dtype, device=key.device),
        "attn": init_attn(ks[0], cfg, dtype),
        "ln2": torch.ones((d,), dtype=dtype, device=key.device),
        "moe": init_moe(ks[1], cfg, dtype, mesh),
    }


def _weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """One layer's attention weights under `repro`'s names: wq (d, Hq*hd),
    wk and wv (d, Hkv*hd), wo (Hq*hd, d), and with qk_norm q_norm and
    k_norm (hd,)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = _weight((d, Hq * hd), dtype, device)
        self.wk = _weight((d, Hkv * hd), dtype, device)
        self.wv = _weight((d, Hkv * hd), dtype, device)
        self.wo = _weight((Hq * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _weight((hd,), dtype, device)
            self.k_norm = _weight((hd,), dtype, device)


class DenseLayer(nn.Module):
    """One dense layer's weights: ln1, attn, ln2 and the SwiGLU MLP
    (wi_gate, wi_up (d, d_ff), wo_mlp (d_ff, d))."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _weight((d,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _weight((d,), dtype, device)
        self.wi_gate = _weight((d, cfg.d_ff), dtype, device)
        self.wi_up = _weight((d, cfg.d_ff), dtype, device)
        self.wo_mlp = _weight((cfg.d_ff, d), dtype, device)


class MoELayer(nn.Module):
    """One MoE layer's weights: ln1, attn, ln2 and the experts (`MoE`:
    moe.router (d, E) float32, moe.we_gate, moe.we_up (E, d, f) and
    moe.we_down (E, f, d); E / M experts with a mesh)."""

    def __init__(self, cfg: ArchConfig, dtype, device, mesh=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _weight((d,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _weight((d,), dtype, device)
        self.moe = MoE(cfg, dtype, device, mesh)


class MambaLayer(nn.Module):
    """One Mamba2 block's weights: ln (d,), in_proj (d, 2 d_in + 2n + H),
    conv_w (K, conv_dim), A_log, D and dt_bias (H,) in float32 whatever
    the model's dtype (as in `repro`), norm_w (d_in,), out_proj
    (d_in, d); with ``cfg.ssm_conv_bias`` the conv's bias conv_b
    (conv_dim,)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_in, H, conv_dim = mamba_dims(cfg)
        self.ln = _weight((d,), dtype, device)
        self.in_proj = _weight((d, 2 * d_in + 2 * cfg.ssm_state + H), dtype,
                               device)
        self.conv_w = _weight((cfg.ssm_conv, conv_dim), dtype, device)
        if getattr(cfg, "ssm_conv_bias", False):
            self.conv_b = _weight((conv_dim,), dtype, device)
        self.A_log = _weight((H,), torch.float32, device)
        self.D = _weight((H,), torch.float32, device)
        self.dt_bias = _weight((H,), torch.float32, device)
        self.norm_w = _weight((d_in,), dtype, device)
        self.out_proj = _weight((d_in, d), dtype, device)


class GraniteMambaLayer(MambaLayer):
    """A Granite-4.0-H Mamba2 layer's weights: `MambaLayer`'s (``ln`` the
    input norm) and the shared MLP's: ln2, wi_gate, wi_up (d, d_ff),
    wo_mlp (d_ff, d). Its attention layers are `DenseLayer`s."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        d = cfg.d_model
        self.ln2 = _weight((d,), dtype, device)
        self.wi_gate = _weight((d, cfg.d_ff), dtype, device)
        self.wi_up = _weight((d, cfg.d_ff), dtype, device)
        self.wo_mlp = _weight((cfg.d_ff, d), dtype, device)


def init_granite_mamba_layer(key: torch.Tensor, cfg: ArchConfig,
                             dtype) -> Dict:
    """A `GraniteMambaLayer`'s init for ``key``: the Mamba2 block's from the
    first of two keys, the MLP's from the second (ln2 ones)."""
    ks = prng.split(key, 2)
    km = prng.split(ks[1], 3)
    d = cfg.d_model
    return {**init_mamba_block(ks[0], cfg, dtype),
            "ln2": torch.ones((d,), dtype=dtype, device=key.device),
            "wi_gate": dense_init(km[0], (d, cfg.d_ff), dtype),
            "wi_up": dense_init(km[1], (d, cfg.d_ff), dtype),
            "wo_mlp": dense_init(km[2], (cfg.d_ff, d), dtype)}


class RecLayer(nn.Module):
    """One RG-LRU recurrent block's weights: ln (d,), w_gate and w_lin
    (d, W), conv_w (K, W), wa and wx (W, W), ba, bx and lam (W,), these
    five float32 whatever the model's dtype (as in `repro`), w_out (W, d).
    No MLP, as in `repro`."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, W = cfg.d_model, cfg.lru_width
        self.ln = _weight((d,), dtype, device)
        self.w_gate = _weight((d, W), dtype, device)
        self.w_lin = _weight((d, W), dtype, device)
        self.conv_w = _weight((cfg.ssm_conv, W), dtype, device)
        self.wa = _weight((W, W), torch.float32, device)
        self.ba = _weight((W,), torch.float32, device)
        self.wx = _weight((W, W), torch.float32, device)
        self.bx = _weight((W,), torch.float32, device)
        self.lam = _weight((W,), torch.float32, device)
        self.w_out = _weight((W, d), dtype, device)


def hybrid_segments(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """`repro`'s ``_hybrid_segments``: (pattern unit, groups) pairs, the
    whole unit repeated n_layers // len(unit) times, then the first
    n_layers % len(unit) blocks of it once."""
    unit = cfg.hybrid_pattern
    n_groups, rem = divmod(cfg.n_layers, len(unit))
    segs = [(unit, n_groups)]
    if rem:
        segs.append((unit[:rem], 1))
    return segs


def hybrid_layout(cfg: ArchConfig) -> List[Tuple[int, int, int, str]]:
    """(segment si, group g, block bi, kind) of each layer of a hybrid
    model, in execution order: layer i holds `repro`'s
    ``params["segments"][si][f"b{bi}"]`` row g. recurrentgemma-9b's 38
    layers are 12 groups of (rec, rec, attn), then one (rec, rec)."""
    return [(si, g, bi, kind)
            for si, (unit, n) in enumerate(hybrid_segments(cfg))
            for g in range(n) for bi, kind in enumerate(unit)]


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


class DecoderLM(nn.Module):
    """Decoder-only LM of the dense, moe, vlm, SSM, hybrid or granite
    family. The
    weights are allocated uninitialised on ``device`` (default cuda;
    "meta" allocates nothing); `init` draws them, or
    ``load_state_dict(params, assign=True)`` takes a state dict
    (`repro_torch.interop.lm_params_from_jax`), without a copy, on that
    state's device. ``remat``, ``loss_chunks`` and ``moe_impl`` are
    `repro`'s: under "full" each layer of `loss` runs under activation
    recompute (``torch.utils.checkpoint``), "none" keeps every
    activation; the loss's cross-entropy runs over ``loss_chunks`` chunks
    of the sequence; the MoE layers dispatch by capacity ("capacity") or
    dropless ("ragged", `repro_torch.models.moe`). ``attn_window`` is
    `repro`'s too: the attention window of every attention layer, over
    ``cfg.attn_window``, and the hybrid's ``local_window`` only where
    both are None.

    ``mesh``, a ("data", "model") `launch.mesh.make_mesh` mesh of one
    process per shard, is `repro`'s ``mesh``, with its
    ``moe_data_axes`` and ``decode_cache_seqshard``: under
    ``moe_data_axes`` ("data",) the rank's batch rows are its block on
    ``data`` (the batch must split over it), under () the whole batch;
    each MoE layer holds the rank's experts (`moe.expert_block`; its
    init draws only those); with ``decode_cache_seqshard`` each
    attention ring holds the rank's C / M slots (C must split over M),
    without it the whole ring. `prefill` takes the whole batch and keeps
    the rank's rows; `init_cache`, the returned logits and caches, and
    `decode_step`'s tokens are the rank's blocks. `loss` takes the whole
    batch too and returns the whole batch's loss. ``parallel_block``
    (`repro`'s, off by default) makes each dense block (the dense, vlm
    and hybrid families' attention layers; not the MoE's) PaLM-style:
    ``x + attn(ln1(x)) + mlp(ln1(x))``, ln2 unused."""

    def __init__(self, cfg: ArchConfig, vocab_pad_multiple: int = 1,
                 device=None, remat: str = "full", loss_chunks: int = 8,
                 moe_impl: str = "capacity", mesh=None,
                 attn_window: Optional[int] = None,
                 moe_data_axes=("data",),
                 decode_cache_seqshard: bool = False,
                 parallel_block: bool = False):
        super().__init__()
        if remat not in ("full", "none"):
            raise ValueError(f"remat {remat!r} is not 'full' or 'none'")
        if moe_impl not in ("capacity", "ragged"):
            raise ValueError(f"moe_impl {moe_impl!r} is not 'capacity' or "
                             f"'ragged'")
        if tuple(moe_data_axes) not in (("data",), ()):
            raise ValueError(f"moe_data_axes {tuple(moe_data_axes)} is not "
                             f"('data',) or (): a model's mesh has one "
                             f"batch axis")
        if mesh is not None:
            check_model_mesh(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.moe_data_axes = tuple(moe_data_axes)
        self.decode_cache_seqshard = decode_cache_seqshard
        self.parallel_block = parallel_block
        self.remat = remat
        self.loss_chunks = loss_chunks
        self.moe_impl = moe_impl
        self.window = attn_window if attn_window is not None \
            else cfg.attn_window
        if cfg.family == "hybrid" and cfg.local_window and \
                self.window is None:
            self.window = cfg.local_window
        self.vp = cfg.padded_vocab(vocab_pad_multiple) \
            if vocab_pad_multiple > 1 else cfg.vocab_size
        self.dtype = getattr(torch, cfg.dtype)
        device = torch.device("cuda" if device is None else device)
        d = cfg.d_model
        self.tok_embed = _weight((self.vp, d), self.dtype, device)
        self.final_norm = _weight((d,), self.dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((d, self.vp), self.dtype, device)
        if cfg.family == "hybrid":
            layers = [RecLayer if kind == "rec" else DenseLayer
                      for *_, kind in hybrid_layout(cfg)]
        elif cfg.family == "granite":
            layers = [GraniteMambaLayer if kind == "mamba" else DenseLayer
                      for kind in cfg.layer_types]
        else:
            layers = [{"ssm": MambaLayer,
                       "moe": functools.partial(MoELayer, mesh=mesh)}.get(
                cfg.family, DenseLayer)] * cfg.n_layers
        self.layers = nn.ModuleList(layer(cfg, self.dtype, device)
                                    for layer in layers)

    # ------------------------------------------------------------ params
    def init(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Draw `repro`'s init for ``key`` (its key tree: ``split(key, 4)``,
        the layers from ``split(ks[2], n_layers)``, or a hybrid model's
        group g of block bi of segment si from ``split(fold_in(ks[2],
        si * 16 + bi), groups)[g]``; a granite model's layer i, of either
        kind, from ``split(ks[2], n_layers)[i]``) on the key's device, make
        it the module's weights and return the state dict. Build the model on
        "meta" first, so that the weights exist once. The port's normal
        sampler may differ from jax's by a few ulps
        (`repro_torch.prng.normal`). Under a mesh each MoE layer draws
        only the rank's experts: those rows of the whole draw."""
        cfg, dtype = self.cfg, self.dtype
        ks = prng.split(key, 4)
        params = {
            "tok_embed": embed_init(ks[0], (self.vp, cfg.d_model), dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=key.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(ks[1], (cfg.d_model, self.vp),
                                           dtype)
        if cfg.family == "hybrid":
            segs = hybrid_segments(cfg)
            for i, (si, g, bi, kind) in enumerate(hybrid_layout(cfg)):
                keys = prng.split(prng.fold_in(ks[2], si * 16 + bi),
                                  segs[si][1])
                layer_init = init_rec_block if kind == "rec" \
                    else init_dense_layer
                params.update(_flatten(layer_init(keys[g], cfg, dtype),
                                       f"layers.{i}."))
        elif cfg.family == "granite":
            keys = prng.split(ks[2], cfg.n_layers)
            for i, kind in enumerate(cfg.layer_types):
                layer_init = init_granite_mamba_layer if kind == "mamba" \
                    else init_dense_layer
                params.update(_flatten(layer_init(keys[i], cfg, dtype),
                                       f"layers.{i}."))
        else:
            layer_init = {"ssm": init_mamba_block,
                          "moe": functools.partial(init_moe_layer,
                                                   mesh=self.mesh)}.get(
                cfg.family, init_dense_layer)
            keys = prng.split(ks[2], cfg.n_layers)
            for i in range(cfg.n_layers):
                params.update(_flatten(layer_init(keys[i], cfg, dtype),
                                       f"layers.{i}."))
        self.load_state_dict(params, assign=True)
        return self.state_dict()

    # ------------------------------------------------------------ blocks
    def _block(self, layer: nn.Module, x: torch.Tensor, q_pos: torch.Tensor,
               cache: Optional[Cache] = None,
               cache_len: Optional[int] = None):
        """One layer (`repro`'s ``_block``): a Mamba2 or RG-LRU block, whose
        cache does not depend on ``cache_len`` or the positions, a dense
        or an MoE block. Returns (x, cache, the router's load-balance
        loss: an fp32 scalar for an MoE block, else None). A granite
        layer is `_granite_block`."""
        if self.cfg.family == "granite":
            return (*self._granite_block(layer, x, q_pos, cache, cache_len),
                    None)
        if isinstance(layer, MambaLayer):
            return (*mamba_block(layer, x, self.cfg, cache), None)
        if isinstance(layer, RecLayer):
            return (*rec_block(layer, x, self.cfg, cache), None)
        cfg = self.cfg
        xn = rms_norm(x, layer.ln1, cfg.norm_eps)
        h, cache = attn_apply(
            layer.attn, xn, cfg, q_pos, cache, self.window,
            cache_len=cache_len,
            seqshard=self.mesh if self.decode_cache_seqshard else None)
        if self.parallel_block and not isinstance(layer, MoELayer):
            m = swiglu(xn, layer.wi_gate, layer.wi_up, layer.wo_mlp)
            return x + h + m, cache, None
        x = x + h
        xn = rms_norm(x, layer.ln2, cfg.norm_eps)
        if isinstance(layer, MoELayer):
            mo, aux = layer.moe(xn, cfg, self.moe_impl, mesh=self.mesh,
                                data_axes=self.moe_data_axes)
            return x + mo, cache, aux
        return x + swiglu(xn, layer.wi_gate, layer.wi_up, layer.wo_mlp), \
            cache, None

    def _granite_block(self, layer: nn.Module, x: torch.Tensor,
                       q_pos: torch.Tensor, cache: Optional[Cache] = None,
                       cache_len: Optional[int] = None):
        """A Granite-4.0-H layer: its mixer (Mamba2 or attention) on the
        normed input, then the shared SwiGLU MLP on the normed sum, each
        output times ``residual_multiplier`` before its residual add.
        Returns (x, cache)."""
        cfg = self.cfg
        rm = cfg.residual_multiplier
        if isinstance(layer, MambaLayer):
            h, cache = mamba_mixer(layer, rms_norm(x, layer.ln, cfg.norm_eps),
                                   cfg, cache)
        else:
            h, cache = attn_apply(
                layer.attn, rms_norm(x, layer.ln1, cfg.norm_eps), cfg, q_pos,
                cache, self.window, cache_len=cache_len,
                seqshard=self.mesh if self.decode_cache_seqshard else None)
        x = x + h * rm
        m = swiglu(rms_norm(x, layer.ln2, cfg.norm_eps), layer.wi_gate,
                   layer.wi_up, layer.wo_mlp)
        return x + m * rm, cache

    def _apply_stack(self, x: torch.Tensor, q_pos: torch.Tensor,
                     caches: Optional[List[Cache]] = None):
        """Run all layers, with one cache per layer (updated in place) or
        none. Returns (x, caches)."""
        for i, layer in enumerate(self.layers):
            x, _, _ = self._block(layer, x, q_pos,
                                  None if caches is None else caches[i])
        return x, caches

    def _apply_stack_train(self, x: torch.Tensor, q_pos: torch.Tensor):
        """All layers, without caches, each under activation recompute when
        ``remat`` is "full" and grad mode is on: its forward runs again in
        the backward pass (a second K4 launch per attention layer).
        Returns (x, the MoE layers' load-balance losses summed in layer
        order from an fp32 0, as `repro`'s scan carries them)."""
        remat = self.remat == "full" and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            if remat:
                x, _, a = checkpoint(self._block, layer, x, q_pos,
                                     use_reentrant=False)
            else:
                x, _, a = self._block(layer, x, q_pos)
            if a is not None:
                aux = aux + a
        return x, aux

    def _apply_stack_prefill(self, x: torch.Tensor, q_pos: torch.Tensor,
                             cache_len: int):
        """Prefill pass that builds each layer's serving cache."""
        caches = []
        for layer in self.layers:
            x, cache, _ = self._block(layer, x, q_pos, cache_len=cache_len)
            caches.append(cache)
        return x, caches

    # ------------------------------------------------------------- embed/out
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.tok_embed)
        # Granite's multipliers are `GraniteConfig`'s alone
        scale = getattr(self.cfg, "embedding_multiplier", 1.0)
        return x * scale if scale != 1.0 else x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.tok_embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = x @ head
        scale = getattr(self.cfg, "logits_scaling", 1.0)
        if scale != 1.0:
            logits = logits / scale
        if self.vp != self.cfg.vocab_size:
            mask = torch.arange(self.vp, device=x.device) < self.cfg.vocab_size
            logits = torch.where(mask, logits, NEG_INF)
        return logits

    # ---------------------------------------------------------------- loss
    def loss(self, batch: Dict[str, torch.Tensor]):
        """batch: {"tokens": (B, T+1) int[, "mask": (B, T+1)][, "vision":
        (B, Nv, d), the vlm family's]}. Next-token cross-entropy over the
        T positions (weighted by ``mask[:, 1:]``), plus
        ``router_aux_coef`` times the router's load-balance loss summed
        over the MoE layers (0 without them), `repro`'s
        ``DecoderLM.loss``. A vlm model runs the vision embeddings (cast
        to the model's dtype) before the tokens, their positions with
        label 0 and mask 0. Returns (loss, {"ce": ..., "aux": ...}), fp32
        scalars. Under a mesh ``batch`` is the whole batch: the rank runs
        its rows (the batch must split over ``data``), and the loss is
        the whole batch's, the rows' weighted sums and weights summed over
        ``data`` (`collectives.psum_replicated`), so its gradient on the
        rank is the rank's rows' part of the whole batch's gradient."""
        cfg = self.cfg
        split = self.mesh is not None and bool(self.moe_data_axes)
        if split:
            D = coll.axes_size(self.mesh, "data")
            if batch["tokens"].shape[0] % D:
                raise RefusedValue(f"batch {batch['tokens'].shape[0]} does "
                                   f"not split over the data axis ({D} "
                                   f"shards)")
            batch = {k: self._rows(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        x = self._embed(tokens[:, :-1])
        labels = tokens[:, 1:]
        if "mask" in batch:
            mask = batch["mask"][:, 1:].float()
        else:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=x.device)
        if cfg.family == "vlm":
            vis = batch["vision"].to(x.dtype)
            B, Nv = vis.shape[0], vis.shape[1]
            x = torch.cat([vis, x], dim=1)
            labels = torch.cat([labels.new_zeros((B, Nv)), labels], dim=1)
            mask = torch.cat([mask.new_zeros((B, Nv)), mask], dim=1)
        q_pos = torch.arange(x.shape[1], device=x.device)
        x, aux = self._apply_stack_train(x, q_pos)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        ce, wsum = chunked_softmax_xent(self._logits, x, labels, mask,
                                        n_chunks=self.loss_chunks)
        if split:
            tot = coll.psum_replicated(
                torch.stack([ce * torch.clamp(wsum, min=1.0), wsum]),
                self.mesh, "data")
            ce = tot[0] / torch.clamp(tot[1], min=1.0)
        return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def _shards(self, batch: int, cache_len: int) -> Tuple[int, int]:
        """(D, M): the shards of the batch (the ``data`` axis, under
        ``moe_data_axes`` ("data",)) and of each ring's C = min(cache_len,
        window) slots (the ``model`` axis, under
        ``decode_cache_seqshard``), 1 where not split. Raises
        ``ValueError`` where the batch or C does not split."""
        if self.mesh is None:
            return 1, 1
        D = coll.axes_size(self.mesh, "data") if self.moe_data_axes else 1
        M = coll.axes_size(self.mesh, "model") \
            if self.decode_cache_seqshard else 1
        C = min(cache_len, self.window) if self.window else cache_len
        if batch % D:
            raise RefusedValue(f"batch {batch} does not split over the data "
                               f"axis ({D} shards)")
        if C % M:
            raise RefusedValue(f"a ring of {C} slots does not split over the "
                               f"model axis ({M} shards)")
        return D, M

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the batch (dim 0) on ``data``."""
        if self.mesh is None or not self.moe_data_axes:
            return x
        return local_block(x, ("data",), self.mesh)

    def init_cache(self, batch: int, cache_len: int) -> List[Cache]:
        """One empty cache per layer: a ring of ``cache_len`` slots
        (attention), {"h": (B, H, hd, n) fp32, "conv": (B, K-1, conv_dim)}
        zeros (Mamba2) or {"h": (B, W) fp32, "conv": (B, K-1, W)} zeros
        (RG-LRU). Under a mesh, this rank's block (`repro`'s
        ``cache_specs(shard_seq_model=decode_cache_seqshard)``): B / D rows
        of the whole ``batch`` and C / M slots of each ring (`_shards`)."""
        device = self.tok_embed.device
        D, M = self._shards(batch, cache_len)
        batch //= D
        C = min(cache_len, self.window) if self.window else cache_len

        def one(layer):
            if isinstance(layer, MambaLayer):
                return init_mamba_cache(self.cfg, batch, self.dtype, device)
            if isinstance(layer, RecLayer):
                return init_rec_cache(self.cfg, batch, self.dtype, device)
            return init_attn_cache(self.cfg, batch, C // M, self.dtype,
                                   None, device)
        return [one(layer) for layer in self.layers]

    def _cut_ring(self, cache: Cache) -> Cache:
        """This rank's C / M slots of a whole attention ring (copied, so
        the whole ring is freed)."""
        return {name: local_block(leaf, cache_leaf_spec(
            name, leaf.dim(), None, "model"), self.mesh).clone()
            for name, leaf in cache.items()}

    def prefill(self, tokens: torch.Tensor,
                vision: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None):
        """tokens: (B, S); a vlm model's ``vision`` (B, Nv, d) runs first,
        at positions 0..Nv-1 (the tokens then at Nv..Nv+S-1; other
        families ignore it, as `repro`'s). Returns (last-position logits
        (B, V), one cache per layer: a ring of ``cache_len`` slots
        (attention; default all the positions) or the SSM or RG-LRU state
        and conv rows, which ``cache_len`` does not size). An SSM or
        hybrid prompt shorter than ``ssm_conv - 1`` tokens raises
        ``ValueError`` (`mamba_block`, `rec_block`). Under a mesh the
        tokens (and vision) are the whole batch: the rank runs its rows,
        and returns their logits and its block of each cache
        (`init_cache`), the ring built whole, then cut."""
        S = tokens.shape[1] + (vision.shape[1] if (
            self.cfg.family == "vlm" and vision is not None) else 0)
        M = self._shards(tokens.shape[0], cache_len or S)[1]
        tokens = self._rows(tokens)
        x = self._embed(tokens)
        if self.cfg.family == "vlm" and vision is not None:
            x = torch.cat([self._rows(vision).to(x.dtype), x], dim=1)
        q_pos = torch.arange(S, device=x.device)
        x, caches = self._apply_stack_prefill(x, q_pos, cache_len or S)
        if M > 1:
            caches = [self._cut_ring(c) if "k" in c else c for c in caches]
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x[:, -1:, :])[:, 0], caches

    def decode_step(self, caches: List[Cache], token: torch.Tensor,
                    pos: int):
        """token: (B, 1) int64 on the model's device; pos: the position
        (a host int, so the step makes no device-to-host copy; the
        recurrent blocks do not read it). Writes the caches in place (the
        ring's slot, or the state and conv rows); returns (logits (B, V),
        caches). Under a mesh, the token, caches and logits are the
        rank's rows (`prefill`), and with ``decode_cache_seqshard`` each
        attention layer runs `attn_decode_seqshard`."""
        x = self._embed(token)
        q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        x, caches = self._apply_stack(x, q_pos, caches)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0], caches
