"""Threefry-2x32 keys and the samplers the reference needs, frozen.

A copy of the parts of `src/repro_torch/prng.py` (itself bitwise
``jax.random`` with ``jax_threefry_partitionable=True``) that the
benchmark's reference uses to work out the round's random choices again:
``PRNGKey``, ``fold_in``, ``split``, 32-bit ``random_bits``, float32
``uniform`` and ``permutation``. Frozen here so that a later change to
the program cannot move the yardstick. A key is a uint32 pair held in an
int64 tensor of shape ``(..., 2)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of count pairs (x1, x2) under key (k1, k2);
    int64 tensors (or ints) holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    y0 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y0) & MASK
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y0 = (y0 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, y0


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds: the high word is 0)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch of keys ``(..., 2)``."""
    data = data & MASK if isinstance(data, torch.Tensor) else int(data) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``(..., 2)`` -> ``(..., num, 2)``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                          idx & MASK)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: keys ``(..., 2)`` -> ``(..., *shape)``
    int64 holding uint32 values (an element's counter is its flat index)."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                          idx & MASK)
    return (b1 ^ b2).reshape(tuple(key.shape[:-1]) + shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on [0, 1): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    return torch.clamp_min(fbits.to(torch.int32).view(torch.float32) - 1.0,
                           0.0)


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: keys ``(..., 2)`` -> ``(..., n)``
    int64, stable sorts on fresh 32-bit sort keys."""
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        lead + (n,))
    for _ in range(_shuffle_rounds(n)):
        ks = split(key, 2)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()
