"""The PaperCNN family: clients of the DPFL paper's CIFAR-10 model
(arXiv:2406.06520 App. F.3.2: two 5x5 VALID convolutions with 2x2 max
pools, two hidden dense layers and the output head, ReLU) on
`bench.data.make_federated_classification` images.

The program side builds the port's `FLEngine` over `repro_torch`'s
`PaperCNN`. The rest is the yardstick: the model FLOPs a round counts,
and `RefModel`, the plain float64 model the check runs (convolutions as
an unfold and a product, a model per client), with the program's flat
layout (leaves in sorted-key order, HWIO convolutions, (in, out) dense
weights: `repro`'s layout).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import data as _data
from ..reference import TIE

#: client blocks of the reference's train, mix and evaluation, and of its
#: reward forwards (four probe models a client)
REF_BLOCK = 100
REWARD_BLOCK = 25


def make_data(cfg: dict, seed: int):
    d = dict(cfg["data"])
    d["image_shape"] = tuple(d["image_shape"])
    return _data.make_federated_classification(seed=seed,
                                               n_clients=cfg["clients"], **d)


def make_engine(cfg: dict, data, device):
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import PaperCNN

    return FLEngine(PaperCNN(CNNConfig(**cfg["model"])), data,
                    device=device, **cfg["train"])


# ------------------------------------------------------------------ FLOPs


def _layers(m: dict):
    """(name, multiply-adds per image) of each conv and dense layer, in
    order."""
    s, out = m["image_size"], []
    cin = m["in_channels"]
    for name, cout in (("conv1", m["c1"]), ("conv2", m["c2"])):
        s = s - 4
        out.append((name, s * s * cout * 25 * cin))
        s //= 2
        cin = cout
    dims = [s * s * cin, m["fc1"], m["fc2"], m["n_classes"]]
    for name, (a, b) in zip(("fc1", "fc2", "out"), zip(dims, dims[1:])):
        out.append((name, a * b))
    return out


def forward_flops(m: dict) -> int:
    """Model FLOPs of one image's forward: two per multiply-add of the
    convolutions and dense layers."""
    return sum(2 * macs for _, macs in _layers(m))


def train_flops(m: dict) -> int:
    """One image's forward and backward: the forward, the weight
    gradients (a forward's worth) and the input gradients of every layer
    but the first (the images take none)."""
    fwd = forward_flops(m)
    first = 2 * _layers(m)[0][1]
    return 3 * fwd - first


def n_params(m: dict) -> int:
    return sum(math.prod(s) for _, s in layout(m))


def round_flops(cfg: dict, omega_sizes: List[int]) -> float:
    """The model FLOPs one round counts: every sample of every epoch of the
    local train (forward and backward), four reward forwards on the
    validation set for each candidate of each Omega_k, one evaluation
    forward, and the Eq.-4 mix over Omega (a multiply-add a weight of
    each client's row and its candidates' rows)."""
    m, d = cfg["model"], cfg["data"]
    N, bs = cfg["clients"], cfg["train"]["batch_size"]
    steps = cfg["dpfl"]["tau_train"] * (d["n_train"] // bs)
    local = N * steps * bs * train_flops(m)
    greedy = 4 * sum(omega_sizes) * d["n_val"] * forward_flops(m)
    evaluation = N * d["n_val"] * forward_flops(m)
    mixing = 2 * n_params(m) * (N + sum(omega_sizes))
    return float(local + greedy + evaluation + mixing)


# -------------------------------------------------------------- reference


def layout(m: dict):
    """(key, shape) of each leaf in the flat row's order (sorted keys)."""
    s = ((m["image_size"] - 4) // 2 - 4) // 2
    shapes = {
        "conv1_w": (5, 5, m["in_channels"], m["c1"]), "conv1_b": (m["c1"],),
        "conv2_w": (5, 5, m["c1"], m["c2"]), "conv2_b": (m["c2"],),
        "fc1_w": (s * s * m["c2"], m["fc1"]), "fc1_b": (m["fc1"],),
        "fc2_w": (m["fc1"], m["fc2"]), "fc2_b": (m["fc2"],),
        "out_w": (m["fc2"], m["n_classes"]), "out_b": (m["n_classes"],)}
    return [(k, shapes[k]) for k in sorted(shapes)]


def _conv(h, w, b):
    """VALID convolution of G models at once: h (G, B, C, H, W), w (G, kh,
    kw, C, O) HWIO, b (G, O), as an unfold and a batched product."""
    G, B, C, H, W = h.shape
    kh, kw, _, O = w.shape[1:]
    cols = F.unfold(h.reshape(G * B, C, H, W), (kh, kw))   # (GB, C kh kw, L)
    cols = cols.reshape(G, B, C * kh * kw, -1)
    wm = w.permute(0, 3, 1, 2, 4).reshape(G, C * kh * kw, O)
    out = torch.einsum("gbkl,gko->gbol", cols, wm) + b[:, None, :, None]
    return out.reshape(G, B, O, H - kh + 1, W - kw + 1)


def _pool(h):
    G, B = h.shape[:2]
    return F.max_pool2d(h.flatten(0, 1), 2).unflatten(0, (G, B))


class RefModel:
    """The plain float64 PaperCNN over G stacked models."""

    def __init__(self, cfg: dict):
        self.layout = layout(cfg["model"])
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
        """(G, B, H, W, C) images as float64 on ``device``."""
        return torch.as_tensor(np.asarray(x)).to(device, torch.float64)

    def logits(self, params, x):
        """x: (G, B, H, W, C) float64 -> (G, B, classes)."""
        h = x.permute(0, 1, 4, 2, 3)
        h = _pool(F.relu(_conv(h, params["conv1_w"], params["conv1_b"])))
        h = _pool(F.relu(_conv(h, params["conv2_w"], params["conv2_b"])))
        # flatten each image's activations in NHWC order
        h = h.permute(0, 1, 3, 4, 2).flatten(2)
        for name in ("fc1", "fc2"):
            h = F.relu(torch.einsum("gbi,gio->gbo", h, params[name + "_w"])
                       + params[name + "_b"][:, None])
        return torch.einsum("gbi,gio->gbo", h, params["out_w"]) \
            + params["out_b"][:, None]

    def loss(self, params, x, y) -> torch.Tensor:
        """(G,) mean cross-entropy of each model on its batch."""
        logp = torch.log_softmax(self.logits(params, x), dim=-1)
        return -logp.gather(-1, y[..., None])[..., 0].mean(-1)

    def correct(self, params, x, y):
        """(sure, maybe), (G, B) bool: the label's logit leads every other
        by more than `TIE` of the logits' scale, or lies within it."""
        return _margins(self.logits(params, x), y)


def _margins(logits, y):
    lab = logits.gather(-1, y[..., None])[..., 0]
    other = logits.scatter(-1, y[..., None], float("-inf")).amax(-1)
    tie = TIE * logits.abs().amax(-1).clamp_min(1.0)
    lead = lab - other
    return lead > tie, lead.abs() <= tie
