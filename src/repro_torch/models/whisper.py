"""Whisper-style encoder-decoder, the audio family (port of
`repro.models.whisper`). [arXiv:2212.04356]

The mel-spectrogram and conv front end are a stub, as in `repro`: the
encoder takes precomputed frame embeddings (B, n_audio_frames, d_model).
Positions are sinusoidal (`common.sinusoidal_positions`), added to the
frames and to the token embeddings (from 0). Each encoder layer is
LayerNorm, non-causal self-attention, LayerNorm and a tanh-GELU MLP with
biases; each decoder layer adds a cross-attention over the encoder's
output between its causal self-attention and its MLP. The attention has
no biases and ``n_heads`` heads for q, k and v alike (the config's
``n_kv_heads`` is not read). The output head is tied to ``tok_embed``.

`WhisperModel` is an ``nn.Module`` that owns its weights under `repro`'s
names and layouts: "enc_layers.{i}.attn.wq" is row i of `repro`'s
``params["enc_layers"]["attn"]["wq"]``, "dec_layers.{i}.cross_attn.wk"
row i of ``params["dec_layers"]["cross_attn"]["wk"]``, "enc_norm.w" is
``params["enc_norm"]["w"]`` (`repro_torch.interop.lm_params_from_jax`).
Every attention whose keys are one whole K/V tensor at aligned positions
runs on the K4 kernel (`kernels.ops.flash_attention`): the encoder's
(non-causal, over the frames), the decoder's self-attention in the loss
and the prefill (causal; the prefill's ring cache is built from the same
K and V) and every cross-attention (non-causal, the frames as keys).
Decode's self-attention over the ring is the plain `attention_ref`, as
in every family. As in `repro`, the cross-attention's K and V are
computed from the encoder's output at every call, in decode too, so a
decode state is (enc_out, caches).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ArchConfig
from ..kernels import ops
from .common import (NEG_INF, attention_ref, chunked_softmax_xent,
                     dense_init, embed_init, gelu_tanh, layer_norm,
                     sinusoidal_positions)
from .lm import Cache, _flatten, _weight, cache_from_prefill

# ------------------------------------------------------------------ weights


def init_attn(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s ``_init_attn``: wq, wk, wv (d, H hd) and wo (H hd, d) from
    ``split(key, 4)``, H = n_heads for all four, no biases."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    ks = prng.split(key, 4)
    return {"wq": dense_init(ks[0], (d, H * hd), dtype),
            "wk": dense_init(ks[1], (d, H * hd), dtype),
            "wv": dense_init(ks[2], (d, H * hd), dtype),
            "wo": dense_init(ks[3], (H * hd, d), dtype)}


def init_mlp(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s ``_init_mlp``: wi (d, d_ff) and wo (d_ff, d) from
    ``split(key, 2)``, zero biases bi and bo."""
    ks = prng.split(key, 2)
    dev = key.device
    return {"wi": dense_init(ks[0], (cfg.d_model, cfg.d_ff), dtype),
            "bi": torch.zeros((cfg.d_ff,), dtype=dtype, device=dev),
            "wo": dense_init(ks[1], (cfg.d_ff, cfg.d_model), dtype),
            "bo": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}


def init_ln(cfg: ArchConfig, dtype, device) -> Dict:
    return {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def init_enc_layer(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s ``_init_enc_layer``: attn and mlp from ``split(key, 2)``."""
    ks = prng.split(key, 2)
    return {"ln1": init_ln(cfg, dtype, key.device),
            "attn": init_attn(ks[0], cfg, dtype),
            "ln2": init_ln(cfg, dtype, key.device),
            "mlp": init_mlp(ks[1], cfg, dtype)}


def init_dec_layer(key: torch.Tensor, cfg: ArchConfig, dtype) -> Dict:
    """`repro`'s ``_init_dec_layer``: self_attn, cross_attn and mlp from
    ``split(key, 3)``."""
    ks = prng.split(key, 3)
    return {"ln1": init_ln(cfg, dtype, key.device),
            "self_attn": init_attn(ks[0], cfg, dtype),
            "ln2": init_ln(cfg, dtype, key.device),
            "cross_attn": init_attn(ks[1], cfg, dtype),
            "ln3": init_ln(cfg, dtype, key.device),
            "mlp": init_mlp(ks[2], cfg, dtype)}


class LayerNorm(nn.Module):
    """A LayerNorm's weight ``w`` and bias ``b`` (d,)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.w = _weight((cfg.d_model,), dtype, device)
        self.b = _weight((cfg.d_model,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.w, self.b)


class MHA(nn.Module):
    """One attention's weights: wq, wk, wv (d, H hd), wo (H hd, d)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        self.wq = _weight((d, H * hd), dtype, device)
        self.wk = _weight((d, H * hd), dtype, device)
        self.wv = _weight((d, H * hd), dtype, device)
        self.wo = _weight((H * hd, d), dtype, device)


class MLP(nn.Module):
    """wi (d, d_ff), bi (d_ff,), wo (d_ff, d), bo (d,): tanh-GELU."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.wi = _weight((cfg.d_model, cfg.d_ff), dtype, device)
        self.bi = _weight((cfg.d_ff,), dtype, device)
        self.wo = _weight((cfg.d_ff, cfg.d_model), dtype, device)
        self.bo = _weight((cfg.d_model,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_tanh(x @ self.wi + self.bi) @ self.wo + self.bo


class EncoderLayer(nn.Module):
    """ln1, attn, ln2, mlp."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg, dtype, device)
        self.attn = MHA(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class DecoderLayer(nn.Module):
    """ln1, self_attn, ln2, cross_attn, ln3, mlp."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg, dtype, device)
        self.self_attn = MHA(cfg, dtype, device)
        self.ln2 = LayerNorm(cfg, dtype, device)
        self.cross_attn = MHA(cfg, dtype, device)
        self.ln3 = LayerNorm(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


# ---------------------------------------------------------------- attention


def _heads(x: torch.Tensor, w: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, d) @ (d, H hd) as (B, S, H, hd)."""
    return (x @ w).reshape(x.shape[0], x.shape[1], cfg.n_heads,
                           cfg.resolved_head_dim)


def _mha(p: MHA, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
         causal: bool):
    """`repro`'s ``_mha`` without a cache: q from xq, k and v from xkv, at
    aligned positions, on the K4 kernel. Returns (out (B, Sq, d), k, v)."""
    q, k, v = _heads(xq, p.wq, cfg), _heads(xkv, p.wk, cfg), \
        _heads(xkv, p.wv, cfg)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out.flatten(2) @ p.wo, k, v


# -------------------------------------------------------------------- model


class WhisperModel(nn.Module):
    """The audio family's encoder-decoder (`repro`'s ``WhisperModel``).
    The weights are allocated uninitialised on ``device`` (default cuda;
    "meta" allocates nothing); `init` draws them, or
    ``load_state_dict(params, assign=True)`` takes a state dict. Its
    interface is `DecoderLM`'s, with the frames beside the tokens:
    ``loss({"frames", "tokens"})``, ``prefill(tokens, frames,
    cache_len)`` -> (logits, (enc_out, caches)) and ``decode_step((enc_out,
    caches), token, pos)``. ``remat`` "full" runs each encoder and decoder
    layer of `loss` under activation recompute; ``loss_chunks`` and
    ``vocab_pad_multiple`` are `repro`'s."""

    def __init__(self, cfg: ArchConfig, vocab_pad_multiple: int = 1,
                 device=None, remat: str = "full", loss_chunks: int = 8):
        super().__init__()
        if remat not in ("full", "none"):
            raise ValueError(f"remat {remat!r} is not 'full' or 'none'")
        self.cfg = cfg
        self.remat = remat
        self.loss_chunks = loss_chunks
        self.vp = cfg.padded_vocab(vocab_pad_multiple) \
            if vocab_pad_multiple > 1 else cfg.vocab_size
        self.dtype = getattr(torch, cfg.dtype)
        device = torch.device("cuda" if device is None else device)
        self.tok_embed = _weight((self.vp, cfg.d_model), self.dtype, device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, self.dtype, device)
            for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, self.dtype, device)
            for _ in range(cfg.n_layers))
        self.enc_norm = LayerNorm(cfg, self.dtype, device)
        self.dec_norm = LayerNorm(cfg, self.dtype, device)

    # ------------------------------------------------------------ params
    def init(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Draw `repro`'s init for ``key`` bit for bit (``split(key, 4)``:
        the encoder layers from ``split(ks[0], n_enc_layers)``, the
        decoder layers from ``split(ks[1], n_layers)``, tok_embed from
        ks[2]) on the key's device, make it the module's weights and
        return the state dict. Build the model on "meta" first, so that
        the weights exist once."""
        cfg, dtype = self.cfg, self.dtype
        ks = prng.split(key, 4)
        params = {"tok_embed": embed_init(ks[2], (self.vp, cfg.d_model),
                                          dtype)}
        for name, layer_init, k, n in (
                ("enc_layers", init_enc_layer, ks[0], cfg.n_enc_layers),
                ("dec_layers", init_dec_layer, ks[1], cfg.n_layers)):
            keys = prng.split(k, n)
            for i in range(n):
                params.update(_flatten(layer_init(keys[i], cfg, dtype),
                                       f"{name}.{i}."))
        for name in ("enc_norm", "dec_norm"):
            params.update(_flatten(init_ln(cfg, dtype, key.device),
                                   f"{name}."))
        self.load_state_dict(params, assign=True)
        return self.state_dict()

    def _remat(self) -> bool:
        return self.remat == "full" and torch.is_grad_enabled()

    # ----------------------------------------------------------- encoder
    def _enc_block(self, layer: EncoderLayer, x: torch.Tensor):
        xn = layer.ln1(x)
        h, _, _ = _mha(layer.attn, xn, xn, self.cfg, causal=False)
        x = x + h
        return x + layer.mlp(layer.ln2(x))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, d), the stubbed front end's output. Sinusoidal
        positions added, the encoder layers (non-causal K4), then the
        final LayerNorm; (B, T, d) in the model's dtype."""
        T = frames.shape[1]
        pos = torch.arange(T, device=frames.device)
        x = frames + sinusoidal_positions(pos, self.cfg.d_model).to(
            frames.dtype)
        remat = self._remat()
        for layer in self.enc_layers:
            x = checkpoint(self._enc_block, layer, x, use_reentrant=False) \
                if remat else self._enc_block(layer, x)
        return self.enc_norm(x)

    # ----------------------------------------------------------- decoder
    def _dec_block(self, layer: DecoderLayer, x: torch.Tensor,
                   enc_out: torch.Tensor, q_pos: torch.Tensor,
                   cache: Optional[Cache] = None,
                   cache_len: Optional[int] = None):
        """One decoder layer (`repro`'s ``_dec_stack`` body). Without a
        cache the self-attention is K4 (causal, positions ``arange(S)``),
        and given ``cache_len`` the ring cache of the prefill is built
        from its K and V; with a cache the new rows go to slots ``q_pos %
        C`` (in place) and the attention is `attention_ref` over the ring.
        The cross-attention is K4 over ``enc_out`` (non-causal). Returns
        (x, cache)."""
        cfg = self.cfg
        p = layer.self_attn
        xn = layer.ln1(x)
        if cache is None:
            h, k, v = _mha(p, xn, xn, cfg, causal=True)
            if cache_len is not None:
                cache = cache_from_prefill(k, v, q_pos, cache_len)
        else:
            q, k, v = _heads(xn, p.wq, cfg), _heads(xn, p.wk, cfg), \
                _heads(xn, p.wv, cfg)
            slot = q_pos % cache["k"].shape[1]
            cache["k"][:, slot] = k
            cache["v"][:, slot] = v
            cache["pos"][:, slot] = q_pos.to(cache["pos"].dtype)
            h = attention_ref(q, cache["k"], cache["v"], q_pos, cache["pos"],
                              causal=True).flatten(2) @ p.wo
        x = x + h
        h, _, _ = _mha(layer.cross_attn, layer.ln2(x), enc_out, cfg,
                       causal=False)
        x = x + h
        return x + layer.mlp(layer.ln3(x)), cache

    def _dec_embed(self, tokens: torch.Tensor,
                   q_pos: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.tok_embed)
        return x + sinusoidal_positions(q_pos, self.cfg.d_model).to(x.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        logits = x @ self.tok_embed.T
        if self.vp != self.cfg.vocab_size:
            mask = torch.arange(self.vp, device=x.device) < self.cfg.vocab_size
            logits = torch.where(mask, logits, NEG_INF)
        return logits

    # -------------------------------------------------------------- loss
    def loss(self, batch: Dict[str, torch.Tensor]):
        """batch: {"frames": (B, T, d), "tokens": (B, S+1) int}. The
        frames encoded (cast to the model's dtype), then next-token
        cross-entropy over the S positions, every one weighted 1 (as
        `repro`'s, which reads no mask). Returns (ce, {"ce": ce, "aux":
        0}), fp32 scalars."""
        enc_out = self.encode(batch["frames"].to(self.dtype))
        tokens = batch["tokens"]
        q_pos = torch.arange(tokens.shape[1] - 1, device=tokens.device)
        x = self._dec_embed(tokens[:, :-1], q_pos)
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
        remat = self._remat()
        for layer in self.dec_layers:
            if remat:
                x, _ = checkpoint(self._dec_block, layer, x, enc_out, q_pos,
                                  use_reentrant=False)
            else:
                x, _ = self._dec_block(layer, x, enc_out, q_pos)
        x = self.dec_norm(x)
        ce, _ = chunked_softmax_xent(self._logits, x, labels, mask,
                                     n_chunks=self.loss_chunks)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    # ----------------------------------------------------------- serving
    def init_cache(self, batch: int, cache_len: int) -> List[Cache]:
        """One empty ring of ``cache_len`` slots per decoder layer: k, v
        (B, C, H, hd) zeros, pos (B, C) -1."""
        cfg, device = self.cfg, self.tok_embed.device
        H, hd = cfg.n_heads, cfg.resolved_head_dim

        def one():
            return {"k": torch.zeros((batch, cache_len, H, hd),
                                     dtype=self.dtype, device=device),
                    "v": torch.zeros((batch, cache_len, H, hd),
                                     dtype=self.dtype, device=device),
                    "pos": torch.full((batch, cache_len), -1,
                                      dtype=torch.int32, device=device)}
        return [one() for _ in self.dec_layers]

    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor,
                cache_len: Optional[int] = None):
        """tokens: (B, S); frames: (B, T, d). Encodes the frames, runs the
        decoder over the tokens at positions 0..S-1 and builds each
        layer's ring of max(cache_len or S, S) slots (`repro`'s rule).
        Returns (last-position logits (B, V), (enc_out, caches))."""
        enc_out = self.encode(frames.to(self.dtype))
        S = tokens.shape[1]
        q_pos = torch.arange(S, device=tokens.device)
        x = self._dec_embed(tokens, q_pos)
        cache_len = max(cache_len or S, S)
        caches = []
        for layer in self.dec_layers:
            x, cache = self._dec_block(layer, x, enc_out, q_pos,
                                       cache_len=cache_len)
            caches.append(cache)
        x = self.dec_norm(x)
        return self._logits(x[:, -1:, :])[:, 0], (enc_out, caches)

    def decode_step(self, state: Tuple[torch.Tensor, List[Cache]],
                    token: torch.Tensor, pos: int):
        """state: (enc_out, caches); token: (B, 1) int64 on the model's
        device; pos: the position (a host int, so the step makes no
        device-to-host copy). Writes the rings in place; recomputes the
        cross-attention's K and V from enc_out, as `repro` does. Returns
        (logits (B, V), (enc_out, caches))."""
        enc_out, caches = state
        q_pos = torch.full((1,), pos, dtype=torch.int64, device=token.device)
        x = self._dec_embed(token, q_pos)
        for layer, cache in zip(self.dec_layers, caches):
            x, _ = self._dec_block(layer, x, enc_out, q_pos, cache)
        x = self.dec_norm(x)
        return self._logits(x)[:, 0], (enc_out, caches)
