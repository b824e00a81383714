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
* ``jax/_src/random.py`` ``_uniform``, ``_normal_real``, ``_randint``
  and ``permutation`` -> ``_shuffle`` (stable sorts on fresh 32-bit keys);
* for ``normal``, XLA's float32 ``erf_inv`` as jaxlib 0.9 compiles it for
  the CPU (`erf_inv`).

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


def _draw(key: torch.Tensor, shape: Sequence[int], fn, dtype, rows=None):
    """``fn`` (elementwise) of the 32-bit draws of keys ``(..., 2)`` over
    ``shape``, in blocks of `BLOCK` counters per key. An element's counter
    is its flat index (``iota_2x32_shape``), so the blocks give the very
    bits of one whole draw. ``rows`` = (lo, hi) draws only rows lo..hi-1
    of the leading axis of ``shape``: the counters of those rows, so the
    bits of that slice of the whole draw (one client shard's rows)."""
    shape = out_shape = tuple(shape)
    first, n = 0, math.prod(shape)
    if rows is not None:
        lo, hi = rows
        out_shape = (hi - lo,) + shape[1:]
        first, n = lo * math.prod(shape[1:]), math.prod(out_shape)
    lead = tuple(key.shape[:-1])
    k1, k2 = key[..., 0, None], key[..., 1, None]
    per = max(1, BLOCK // max(1, math.prod(lead)))
    if n <= per:
        return fn(_bits(k1, k2, first, first + n)).reshape(lead + out_shape)
    out = torch.empty(lead + (n,), dtype=dtype, device=key.device)
    for start in range(0, n, per):
        stop = min(n, start + per)
        out[..., start:stop] = fn(_bits(k1, k2, first + start,
                                        first + stop))
    return out.reshape(lead + out_shape)


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
            minval: float = 0.0, maxval: float = 1.0,
            rows=None) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on [minval, maxval): the top 23 bits
    become the mantissa of a float in [1, 2), minus 1, scaled. ``rows``
    = (lo, hi): only those rows of the draw (`_draw`)."""
    # bounds and span rounded to float32 as jax computes them; Python
    # scalars keep the call free of host-to-device copies
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return _draw(key, shape, lambda bits: _uniform_from_bits(bits, lo, span),
                 torch.float32, rows)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a hardware fused multiply-add.
    The product of two float32 values is exact in float64; the float64 sum
    is made round-to-odd from its TwoSum error, so that its rounding to
    float32 is the only one that counts. Every op is IEEE on the CPU and on
    CUDA, so both give the same bits. ``b`` and ``c`` are float32 tensors
    or Python floats holding float32 values."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    cd = c.double() if isinstance(c, torch.Tensor) else c
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    bits = s.view(torch.int64)
    # rounded away from zero: truncate one ulp toward zero, then set the
    # last bit (round to odd)
    odd = torch.where((err < 0) != (s < 0), bits - 1, bits) | 1
    return torch.where(err != 0, odd, bits).view(torch.float64).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of x >= 0. ``torch.sqrt`` on the CPU
    misses by an ulp on about 0.6 % of float32 inputs (and of float64
    ones), so the float64 root is rounded to float32 and then moved to the
    neighbour whose midpoint test says so; the midpoints and their squares
    are exact in float64."""
    c = torch.sqrt(x.double()).float()
    up = torch.nextafter(c, torch.full_like(c, math.inf))
    down = torch.nextafter(c, torch.zeros_like(c))
    xd, cd = x.double(), c.double()
    hi = (cd + up.double()) * 0.5
    lo = (cd + down.double()) * 0.5
    c = torch.where(xd > hi * hi, up, c)
    return torch.where(xd < lo * lo, down, c)


# XLA:CPU's float32 log (Eigen's Cephes polynomial: x in [sqrt(1/2) - 1,
# sqrt(2) - 1] after the exponent split), as jaxlib 0.9's LLVM IR and
# x86 code for ``jax.random.normal`` compute it, fused multiply-adds
# included
_SQRTHF = _f32(0.707106781186547524)
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = 0.693359375
_MIN_NORMAL = _f32(1.17549435e-38)
# XLA's log1p below sqrt(2) - 1: y - y^2/2 + y^3 N(y)/D(y) (Cephes)
_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
# Giles' erf_inv: for w < 5 in w - 2.5, else in sqrt(w) - 3
_ERFINV_LO = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    2.1858087e-04, -1.25372503e-03, -4.17768164e-03, 0.246640727,
    1.50140941))
_ERFINV_HI = tuple(_f32(c) for c in (
    -2.00214257e-04, 1.00950558e-04, 1.34934322e-03, -3.67342844e-03,
    5.73950773e-03, -7.6224613e-03, 9.43887047e-03, 1.00167406,
    2.83297682))


def _log(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log for finite v > 0."""
    bits = torch.clamp_min(v, _MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [1/2, 1)
    small = m < _SQRTHF
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    z = x * x
    x3 = z * x
    p = [_fma(_fma(torch.full_like(x, _LOG_P[i]), x, _LOG_P[i + 1]), x,
              _LOG_P[i + 2]) for i in (0, 3, 6)]
    y = _fma(_fma(_fma(p[0], x3, p[1]), x3, p[2]), x3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, _fma(z, -0.5, x) + y)


def _log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p for y > -1."""
    y2 = y * y
    den = torch.ones_like(y)
    for c in _LOG1P_DEN:
        den = _fma(den, y, c)
    num = torch.full_like(y, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, y, c)
    small = y + _fma(y2, -0.5, (y * y2) * (num / den))
    return torch.where(y.abs() < _LOG1P_SMALL, small, _log(y + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jax.lax.erf_inv`` bit for bit (XLA:CPU): Giles' two
    polynomials in w = -log1p(-x^2), each Horner step one fused
    multiply-add, on XLA's own log1p and log; +-1 -> +-inf. Built only
    from integer views, IEEE adds, products, quotients and roots, each its
    own kernel, so the card gives the CPU's bits (``torch.log``,
    ``torch.log1p`` and ``torch.erfinv`` differ between the two)."""
    l = _log1p(-(x * x))
    central = l > -5.0
    t = torch.where(central, -2.5 - l, _sqrt(-l) - 3.0)

    def coeff(i):
        return torch.where(central, torch.full_like(t, _ERFINV_LO[i]),
                           torch.full_like(t, _ERFINV_HI[i]))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LO)):
        p = _fma(p, t, coeff(i))
    p = torch.where(x.abs() == 1.0, torch.full_like(p, math.inf), p)
    return x * p


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           rows=None) -> torch.Tensor:
    """float32 ``jax.random.normal`` bit for bit: sqrt(2) * erf_inv(u), u
    uniform on (-1, 1). ``rows`` = (lo, hi): only those rows of the draw
    (`_draw`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    sqrt2 = float(np.float32(np.sqrt(2)))
    return _draw(key, shape, lambda bits: erf_inv(
        _uniform_from_bits(bits, lo, span)) * sqrt2, torch.float32, rows)


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

