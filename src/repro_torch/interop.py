"""Carry weights from `repro` (JAX) into the port.

The port keeps `repro`'s flat layout exactly: the leaves of a parameter
dict in ``ravel_pytree`` order (sorted keys), each raveled in its JAX
layout (HWIO conv weights, (in, out) dense weights). So a row of a
(N, P) table of one package is the same model in the other, and weights
cross as numpy arrays with no reshuffling. An LM's stacked layer tree
becomes the port's per-layer state dict (`lm_params_from_jax`), and back
(`lm_params_to_jax`). Takes and gives numpy, not JAX arrays: this module
imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.lm import hybrid_layout, hybrid_segments


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """A `repro` parameter dict (as numpy arrays; a client axis may lead)
    -> the same dict of float32 tensors on ``device`` (default cuda)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device)
            for k, v in sorted(params.items())}


def flat_from_jax(flat: np.ndarray, device=None) -> torch.Tensor:
    """A `repro` flat table ((N, P) rows or one (P,) row) -> a float32
    tensor on ``device`` (default cuda), row for row."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.tensor(np.asarray(flat), dtype=torch.float32,
                        device=device)


#: per family, the layer leaves (dotted paths within a layer) that are
#: float32 in `repro` whatever ``cfg.dtype``: the Mamba2 block's scalars
#: (`repro.models.ssm.init_mamba_block`), the RG-LRU block's gate
#: weights and decay (`repro.models.rglru.init_rec_block`) and the MoE
#: router (`repro.models.moe.init_moe`)
FLOAT32_LEAVES = {"ssm": ("A_log", "D", "dt_bias"),
                  "hybrid": ("wa", "ba", "wx", "bx", "lam"),
                  "moe": ("moe.router",)}
#: the families whose trees `lm_params_from_jax` and `lm_params_to_jax`
#: carry: vlm's tree is the dense one, moe's stacks its layers as dense
#: does, with a "moe" subtree in place of the MLP
LM_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def lm_params_from_jax(params: Mapping, cfg, device=None
                       ) -> Dict[str, torch.Tensor]:
    """A `repro` ``DecoderLM`` parameter tree of the dense, moe, vlm, SSM
    or hybrid family (`LM_FAMILIES`), as numpy arrays -> the state dict of
    the port's `repro_torch.models.lm.DecoderLM` ("tok_embed",
    "final_norm", ["lm_head"], "layers.{i}.ln1", "layers.{i}.attn.wq",
    ..., "layers.{i}.moe.router", ..., "layers.{i}.in_proj", ...), in
    ``cfg.dtype`` on ``device`` (default cuda), except the leaves that
    `repro` keeps in float32 whatever the dtype (`FLOAT32_LEAVES`).
    Dense, moe, vlm and SSM trees stack every leaf under ``"layers"``
    over a leading n_layers axis; a hybrid tree's leaf
    ``params["segments"][si][f"b{bi}"][name][g]`` becomes
    ``layers.{i}.{name}`` for the layer i at (si, g, bi)
    (`repro_torch.models.lm.hybrid_layout`)."""
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"lm_params_from_jax: the {cfg.family} "
                                  f"family is not ported")
    device = torch.device("cuda") if device is None else torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    float32 = FLOAT32_LEAVES.get(cfg.family, ())

    def put(a, name=""):
        keep = name in float32
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=torch.float32 if keep else dtype)

    def leaves(tree, prefix=""):
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                yield from leaves(leaf, f"{prefix}{name}.")
            else:
                yield f"{prefix}{name}", np.asarray(leaf)

    stacks = "segments" if cfg.family == "hybrid" else "layers"
    out = {name: put(a) for name, a in params.items() if name != stacks}
    if cfg.family == "hybrid":
        segs = params["segments"]
        for i, (si, g, bi, _) in enumerate(hybrid_layout(cfg)):
            for name, a in leaves(segs[si][f"b{bi}"]):
                out[f"layers.{i}.{name}"] = put(a[g], name)
        return out
    for name, a in leaves(params["layers"]):
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"lm_params_from_jax: layers.{name} has "
                             f"{a.shape[0]} rows for {cfg.n_layers} layers")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = put(a[i], name)
    return out


def lm_params_to_jax(state: Mapping[str, torch.Tensor], cfg
                     ) -> Dict[str, object]:
    """The inverse of `lm_params_from_jax`: a state dict of the port's
    `DecoderLM` -> `repro`'s ``DecoderLM`` parameter tree, every leaf a
    float32 numpy array on the host: "tok_embed", "final_norm",
    ["lm_head"], and ``"layers"`` (dense, moe, vlm, SSM) holding each
    leaf stacked over the layers, or ``"segments"`` (hybrid) holding
    ``[si][f"b{bi}"]`` leaves stacked over the groups. Saved with
    `repro_torch.checkpoint.save_pytree`, it is a file that
    `repro.checkpoint.load_pytree` reads into `repro`'s tree."""
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"lm_params_to_jax: the {cfg.family} "
                                  f"family is not ported")

    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def nest(leaves: Dict[str, np.ndarray]) -> Dict:
        tree: Dict = {}
        for name, a in leaves.items():
            *path, last = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = a
        return tree

    out: Dict[str, object] = {k: arr(v) for k, v in state.items()
                              if not k.startswith("layers.")}
    per_layer: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        if k.startswith("layers."):
            _, i, name = k.split(".", 2)
            per_layer.setdefault(int(i), {})[name] = v
    if cfg.family == "hybrid":
        layout = hybrid_layout(cfg)
        segs = [dict() for _ in hybrid_segments(cfg)]
        for i, (si, g, bi, _) in enumerate(layout):
            block = segs[si].setdefault(f"b{bi}", {})
            for name, v in per_layer[i].items():
                block.setdefault(name, []).append(arr(v))
        out["segments"] = [{b: nest({n: np.stack(rows)
                                     for n, rows in block.items()})
                            for b, block in seg.items()} for seg in segs]
        return out
    if sorted(per_layer) != list(range(cfg.n_layers)):
        raise ValueError(f"lm_params_to_jax: layers {sorted(per_layer)} "
                         f"for {cfg.n_layers} layers")
    out["layers"] = nest({name: np.stack([arr(per_layer[i][name])
                                          for i in range(cfg.n_layers)])
                          for name in per_layer[0]})
    return out
