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
* ``jax/_src/random.py`` ``_uniform``, ``_randint`` and ``permutation``
  -> ``_shuffle`` (stable sorts on fresh 32-bit keys).

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


#: counters hashed at once, per key: a draw of more values is taken in
#: blocks of the flat counter range, so its int64 temporaries stay at a
#: few of this size (the (256,000, 4,096) embedding of recurrentgemma-9b
#: would otherwise need six 8.4 GB temporaries at a time)
BLOCK = 1 << 24


def _bits(k1, k2, start: int, stop: int) -> torch.Tensor:
    """32-bit draws of the flat counters [start, stop) under keys (k1, k2)
    of shape ``(..., 1)``: ``(..., stop - start)`` int64."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def _draw(key: torch.Tensor, shape: Sequence[int], fn, dtype):
    """``fn`` (elementwise) of the 32-bit draws of keys ``(..., 2)`` over
    ``shape``, in blocks of `BLOCK` counters per key. An element's counter
    is its flat index (``iota_2x32_shape``), so the blocks give the very
    bits of one whole draw."""
    shape = tuple(shape)
    n = math.prod(shape)
    lead = tuple(key.shape[:-1])
    k1, k2 = key[..., 0, None], key[..., 1, None]
    per = max(1, BLOCK // max(1, math.prod(lead)))
    if n <= per:
        return fn(_bits(k1, k2, 0, n)).reshape(lead + shape)
    out = torch.empty(lead + (n,), dtype=dtype, device=key.device)
    for start in range(0, n, per):
        stop = min(n, start + per)
        out[..., start:stop] = fn(_bits(k1, k2, start, stop))
    return out.reshape(lead + shape)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: keys ``(..., 2)`` -> ``(..., *shape)``
    int64 holding uint32 values."""
    return _draw(key, shape, lambda bits: bits, torch.int64)


def _uniform_from_bits(bits: torch.Tensor, lo: float,
                       span: float) -> torch.Tensor:
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * span + lo, lo)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on [minval, maxval): the top 23 bits
    become the mantissa of a float in [1, 2), minus 1, scaled."""
    # bounds and span rounded to float32 as jax computes them; Python
    # scalars keep the call free of host-to-device copies
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return _draw(key, shape, lambda bits: _uniform_from_bits(bits, lo, span),
                 torch.float32)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 ``jax.random.normal``: sqrt(2) * erfinv(u), u uniform on
    (-1, 1). ``torch.erfinv`` and XLA's ``erf_inv`` are different
    polynomials, so values may differ from jax by a few ulps; parity tests
    carry the JAX init across (`repro_torch.interop`) instead."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    sqrt2 = np.float32(np.sqrt(2))
    return _draw(key, shape, lambda bits: torch.erfinv(
        _uniform_from_bits(bits, lo, span)) * sqrt2, torch.float32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in its default
    int32 dtype, as int64 values: two 32-bit draws from ``split(key)``
    combined modulo the span in uint32 arithmetic, as jax 0.9's
    ``_randint`` computes them (every product and sum wraps at 2**32, so
    for a span above 2**16 the multiplier is 0 and the second draw alone
    decides). ``minval`` and ``maxval`` are ints in int32's range, which
    jax also demands of Python ints; keys ``(..., 2)`` -> ``(..., *shape)``."""
    lo_v, hi_v = int(minval), int(maxval)
    if not -(1 << 31) <= min(lo_v, hi_v) <= max(lo_v, hi_v) < 1 << 31:
        raise ValueError(f"randint: bounds {minval}, {maxval} leave int32")
    span = (hi_v - lo_v) & MASK if hi_v > lo_v else 1
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    # (higher % span) * mult < 2**32: mult is below span <= 2**16, or 0
    offset = (((higher % span) * mult + lower % span) & MASK) % span
    value = (lo_v + offset) & MASK
    return torch.where(value >= 1 << 31, value - (1 << 32), value)


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

