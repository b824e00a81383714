"""Carry weights from `repro` (JAX) into the port.

The port keeps `repro`'s flat layout exactly: the leaves of a parameter
dict in ``ravel_pytree`` order (sorted keys), each raveled in its JAX
layout (HWIO conv weights, (in, out) dense weights). So a row of a
(N, P) table of one package is the same model in the other, and weights
cross as numpy arrays with no reshuffling. An LM's stacked layer tree
becomes the port's per-layer state dict (`lm_params_from_jax`). Takes
numpy, not JAX arrays: this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


#: Mamba2 block leaves that are float32 in `repro` whatever ``cfg.dtype``
#: (`repro.models.ssm.init_mamba_block`)
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


def lm_params_from_jax(params: Mapping, cfg, device=None
                       ) -> Dict[str, torch.Tensor]:
    """A `repro` ``DecoderLM`` parameter tree of the dense or SSM family, as
    numpy arrays (every leaf under ``"layers"`` stacked over a leading
    n_layers axis) -> the state dict of the port's
    `repro_torch.models.lm.DecoderLM` ("tok_embed", "final_norm",
    ["lm_head"], "layers.{i}.ln1", "layers.{i}.attn.wq", ...,
    "layers.{i}.in_proj", ...), in ``cfg.dtype`` on ``device`` (default
    cuda), except the SSM leaves that `repro` keeps in float32 whatever
    the dtype (`FLOAT32_LEAVES`)."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"lm_params_from_jax: the {cfg.family} "
                                  f"family is not ported")
    device = torch.device("cuda") if device is None else torch.device(device)
    dtype = getattr(torch, cfg.dtype)

    def put(a, name=""):
        keep = cfg.family == "ssm" and name in FLOAT32_LEAVES
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=torch.float32 if keep else dtype)

    def leaves(tree, prefix=""):
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                yield from leaves(leaf, f"{prefix}{name}.")
            else:
                yield f"{prefix}{name}", np.asarray(leaf)

    out = {name: put(a) for name, a in params.items() if name != "layers"}
    for name, a in leaves(params["layers"]):
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"lm_params_from_jax: layers.{name} has "
                             f"{a.shape[0]} rows for {cfg.n_layers} layers")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = put(a[i], name)
    return out
