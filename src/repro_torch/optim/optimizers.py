"""SGD and AdamW on dicts of tensors, with `apply_updates`, `global_norm`
and `clip_by_global_norm` (port of `repro.optim.optimizers`).

Functional, like `repro`'s: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller adds the
updates (`apply_updates`). The arithmetic follows `repro`'s order step
for step. The step count is a host int, so a learning-rate schedule
never reads the device.

Where `repro` returns new moments, AdamW and SGD write them into the
state's tensors in place: the port's stand-in for donating the old
state, which the caller must not reuse. Their updates are fresh tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed in `repro`'s leaf order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def clip_by_global_norm(tree: Params, max_norm: float):
    """Every leaf times min(1, max_norm / max(norm, 1e-9)); returns the
    clipped tree and the norm (a device scalar: no host sync)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, norm


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """``g += wd * p``; ``mu = m * mu + g``; ``update = -lr * mu`` (or
    ``-lr * (g + m * mu)`` with nesterov). Leaf by leaf, the momentum
    written into the state's tensors in place (as AdamW's moments), so
    that an update holds one panel of updates and one leaf of
    temporaries beside its inputs."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params):
        mu = ({k: torch.zeros_like(v) for k, v in params.items()}
              if momentum else None)
        return {"mu": mu, "count": 0}

    def update(grads: Params, state, params: Params):
        step_lr = lr_fn(state["count"])
        mu = state["mu"] if momentum else None
        updates = {}
        for k, g in grads.items():
            if weight_decay:
                g = g + weight_decay * params[k]
            if momentum:
                # m * mu + g, the same two roundings, in place
                m = mu[k].mul_(momentum).add_(g)
                g = g + momentum * m if nesterov else m
            updates[k] = -step_lr * g
        return updates, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with bias correction: ``count += 1`` (before the schedule is
    read); ``mu = b1 mu + (1 - b1) g``; ``nu = b2 nu + (1 - b2) g g``;
    ``u = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p]``, ``bc = 1 - b **
    count`` in ``state_dtype``; ``update = -lr(count) * u``. ``lr`` is a
    number or a schedule (`repro_torch.optim.schedules`). The moments are
    updated in place (module docstring)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params):
        return {"mu": {k: torch.zeros_like(p, dtype=state_dtype)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=state_dtype)
                       for k, p in params.items()},
                "count": 0}

    def update(grads: Params, state, params: Params):
        count = state["count"] + 1
        step_lr = lr_fn(count)
        # the bias corrections in state_dtype on the host, as Python floats
        # (exact in a state_dtype tensor's arithmetic)
        c = torch.tensor(count, dtype=state_dtype)
        bc1 = (1 - b1 ** c).item()
        bc2 = (1 - b2 ** c).item()
        updates = {}
        for k, g in grads.items():
            g = g.to(state_dtype)
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
            if weight_decay:
                u.add_(weight_decay * params[k].to(state_dtype))
            updates[k] = u.mul_(-step_lr)
        return updates, {"mu": state["mu"], "nu": state["nu"],
                         "count": count}

    return Optimizer(init, update)
