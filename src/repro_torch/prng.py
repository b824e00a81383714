"""Threefry-2x32 keys and samplers, bitwise equal to ``jax.random``.

The port draws every stochastic decision of Algorithm 1 (minibatch
orders, candidate orders, greedy coin flips) from the same key tree as
`repro`, so the two packages make the same random choices and differ only
by floating-point noise. The spec is jax 0.9's own source with
``jax_threefry_partitionable=True``:

* ``jax/_src/prng.py`` ``threefry_seed`` (key from an integer seed),
  ``_threefry2x32_lowering`` (the hash), ``_threefry_split_foldlike``,
  ``threefry_fold_in``, ``_threefry_random_bits_partitionable``
  (32-bit bits are ``bits1 ^ bits2``) and ``iota_2x32_shape``;
* ``jax/_src/random.py`` ``_uniform`` and ``permutation`` -> ``_shuffle``
  (stable sorts on fresh 32-bit keys).

A key is a uint32 pair held in an int64 tensor of shape ``(..., 2)``;
every add and rotate is masked with ``& 0xFFFFFFFF``. Every function
vectorises over the leading batch of keys, so one call draws, say, a
refresh's N x N coin flips on the device.
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
    """The Threefry-2x32 hash of count pairs (x1, x2) under key (k1, k2).
    All arguments are int64 tensors (or ints) holding uint32 values and
    broadcast together; returns the two uint32 output words."""
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
    """``jax.random.fold_in`` over a batch of keys ``(..., 2)``; ``data``
    is an int or an int64 tensor broadcasting against ``key[..., 0]``."""
    if isinstance(data, torch.Tensor):
        data = data & MASK
    else:
        data = int(data) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def _iota_2x32(shape: Sequence[int], device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``(..., 2)`` -> ``(..., num, 2)``.
    (The partitionable split is ``fold_in`` with the counts 0..num-1.)"""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: keys ``(..., 2)`` -> ``(..., *shape)``
    int64 holding uint32 values."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape, key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on [minval, maxval): the top 23 bits
    become the mantissa of a float in [1, 2), minus 1, scaled."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # bounds and span rounded to float32 as jax computes them; Python
    # scalars keep the call free of host-to-device copies
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 ``jax.random.normal``: sqrt(2) * erfinv(u), u uniform on
    (-1, 1). ``torch.erfinv`` and XLA's ``erf_inv`` are different
    polynomials, so values may differ from jax by a few ulps; parity tests
    carry the JAX init across (`repro_torch.interop`) instead."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * np.float32(np.sqrt(2))


def _shuffle_rounds(n: int) -> int:
    # jax/_src/random.py::_shuffle's static stop criterion (exponent 3)
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an int ``n``: keys
    ``(..., 2)`` -> ``(..., n)`` int64. Each round splits the key and
    stable-sorts the current order by fresh 32-bit sort keys."""
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        lead + (n,))
    for _ in range(_shuffle_rounds(n)):
        ks = split(key, 2)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        sort_keys = random_bits(sub, (n,))
        order = torch.sort(sort_keys, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()

