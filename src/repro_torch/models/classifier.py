"""Classifier models for the federated-learning experiments, batched over
a leading model axis.

``PaperCNN`` is the paper's CIFAR10 model (App. F.3.2): 2 conv + pool
layers, 2 fully-connected layers and an output head. ``MLP`` is the
cheap substitute the fast tests use. Port of `repro.models.classifier`.

Parameters keep `repro`'s names and layouts (HWIO conv weights, (in, out)
dense weights) so a flat row is the same vector in both packages. Every
forward takes a stack of G models (each leaf has a leading G axis) and a
stack of G input batches, ``x`` of shape (G, B, ...), and returns
(G, B, n_classes): G is the clients during local training and the
clients times the greedy's reward probes during a GGC refresh. The
dense layers run as batched matmuls. PaperCNN's convolution stack takes
one of two routes, by whether a gradient will be taken: where grad mode
is on and an input or a parameter needs a gradient (local training),
one grouped convolution a layer (``groups=G``,
`repro_torch.kernels.ref.cnn_features_ref`), which autograd
differentiates; else (the reward probes, evaluation, kNN-Per's
embeddings) `repro_torch.kernels.ops.cnn_features`, K7 on the card and
the same grouped convolutions on the CPU. ``features`` is the
penultimate activations (kNN-Per's embedding), and ``logits`` is the
output head on them; ``HEAD_KEYS`` names the head that FedRep keeps
local.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import prng
from ..kernels import ops, ref
from .common import dense_init

Params = Dict[str, torch.Tensor]


def _dense(h, w, b):
    """h: (G, B, in); w: (G, in, out); b: (G, out)."""
    return torch.bmm(h, w) + b[:, None, :]


class PaperCNN:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, key) -> Params:
        """One model's parameters (no model axis), `repro`'s init, on the
        key's device."""
        c = self.cfg
        ks = prng.split(key, 5)
        sz = c.image_size
        sz = (sz - 4) // 2       # conv5 + pool
        sz = (sz - 4) // 2       # conv5 + pool
        flat = sz * sz * c.c2
        dev = ks.device

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=dev)

        return {
            "conv1_w": dense_init(ks[0], (5, 5, c.in_channels, c.c1),
                                  scale=0.1),
            "conv1_b": zeros(c.c1),
            "conv2_w": dense_init(ks[1], (5, 5, c.c1, c.c2), scale=0.1),
            "conv2_b": zeros(c.c2),
            "fc1_w": dense_init(ks[2], (flat, c.fc1)),
            "fc1_b": zeros(c.fc1),
            "fc2_w": dense_init(ks[3], (c.fc1, c.fc2)),
            "fc2_b": zeros(c.fc2),
            "out_w": dense_init(ks[4], (c.fc2, c.n_classes)),
            "out_b": zeros(c.n_classes),
        }

    def features(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Penultimate activations (G, B, fc2): the convs, pools and both
        hidden dense layers; x: (G, B, H, W, C) float32 (NHWC per
        model)."""
        conv = (x, params["conv1_w"], params["conv1_b"], params["conv2_w"],
                params["conv2_b"])
        # each model's activations flattened in NHWC order, as repro does
        if torch.is_grad_enabled() and any(t.requires_grad for t in conv):
            h = ref.cnn_features_ref(*conv)
        else:
            h = ops.cnn_features(*conv)
        h = F.relu(_dense(h, params["fc1_w"], params["fc1_b"]))
        return F.relu(_dense(h, params["fc2_w"], params["fc2_b"]))

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (G, B, H, W, C) float32 (NHWC per model)."""
        return _dense(self.features(params, x), params["out_w"],
                      params["out_b"])

    # body/head split used by FedRep
    HEAD_KEYS = ("out_w", "out_b")


class MLP:
    """Small MLP on flattened features; used for fast FL tests."""

    def __init__(self, in_dim: int, hidden: int, n_classes: int):
        self.in_dim, self.hidden, self.n_classes = in_dim, hidden, n_classes

    def init(self, key) -> Params:
        ks = prng.split(key, 3)
        dev = ks.device

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=dev)

        return {
            "w1": dense_init(ks[0], (self.in_dim, self.hidden)),
            "b1": zeros(self.hidden),
            "w2": dense_init(ks[1], (self.hidden, self.hidden)),
            "b2": zeros(self.hidden),
            "out_w": dense_init(ks[2], (self.hidden, self.n_classes)),
            "out_b": zeros(self.n_classes),
        }

    def features(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Penultimate activations (G, B, hidden); x: (G, B, in_dim)."""
        h = F.relu(_dense(x, params["w1"], params["b1"]))
        return F.relu(_dense(h, params["w2"], params["b2"]))

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (G, B, in_dim)."""
        return _dense(self.features(params, x), params["out_w"],
                      params["out_b"])

    HEAD_KEYS = ("out_w", "out_b")


def xent_loss(model, params: Params, batch) -> torch.Tensor:
    """batch: {"x": (G, B, ...), "y": (G, B) int64}. Mean cross-entropy
    per model: (G,)."""
    logits = model.logits(params, batch["x"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["y"][..., None])[..., 0]
    return nll.mean(dim=-1)


def accuracy(model, params: Params, batch) -> torch.Tensor:
    """Per-model accuracy (G,); ties in the logits go to the first
    maximum, as ``jnp.argmax`` does."""
    logits = model.logits(params, batch["x"])
    hit = torch.argmax(logits, dim=-1) == batch["y"]
    return hit.float().mean(dim=-1)
