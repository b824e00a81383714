"""Carry weights from `repro` (JAX) into the port.

The port keeps `repro`'s flat layout exactly: the leaves of a parameter
dict in ``ravel_pytree`` order (sorted keys), each raveled in its JAX
layout (HWIO conv weights, (in, out) dense weights). So a row of a
(N, P) table of one package is the same model in the other, and weights
cross as numpy arrays with no reshuffling. Takes numpy, not JAX arrays:
this module imports no JAX.
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
