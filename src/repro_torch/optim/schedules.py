"""Learning-rate schedules (port of `repro.optim.schedules`).

A schedule maps a step count (a host int) to the learning rate as a
Python float holding a float32 value, so the rate never reads the device
and multiplies a float32 tensor exactly. It computes in float32 what
`repro`'s schedule computes inside the jitted train step, where XLA
folds the constants and fuses: a division by a constant becomes a
product with its float32 reciprocal, ``peak * step / warmup`` becomes
``step * (peak * (1 / warmup))``, and the cosine branch ends in one fused
multiply-add. The cosine is IEEE float64's, rounded to float32, where
XLA has its own float32 cosine: the two gave the same rates at every
step the tests try (tests/test_torch_train.py).
"""
from __future__ import annotations

import math

import torch

from ..prng import _fma


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(value: float):
    return lambda step: _f32(value).item()


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup from 0 to ``peak`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak`` at ``total_steps``."""
    def fn(step):
        step = _f32(step)
        warm = step * (_f32(peak) * (1 / _f32(max(warmup_steps, 1))))
        prog = torch.clamp((step - warmup_steps)
                           * (1 / _f32(max(total_steps - warmup_steps, 1))),
                           0.0, 1.0)
        angle = prog * _f32(math.pi)
        cos = _fma(_f32(math.cos(angle.item())) + 1,
                   _f32((1 - final_frac) * peak * 0.5),
                   _f32(final_frac * peak))
        return (warm if step < warmup_steps else cos).item()
    return fn
