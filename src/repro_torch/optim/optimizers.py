"""SGD with momentum, weight decay and nesterov on stacked parameter
dicts (port of `repro.optim.optimizers.sgd`).

Functional, like `repro`'s: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller adds the
updates. The arithmetic follows `repro`'s order step for step:
``g += wd * p``; ``mu = m * mu + g``; ``update = -lr * mu`` (or
``-lr * (g + m * mu)`` with nesterov). The step count is a host int, so
a learning-rate schedule never reads the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params):
        mu = ({k: torch.zeros_like(v) for k, v in params.items()}
              if momentum else None)
        return {"mu": mu, "count": 0}

    def update(grads: Params, state, params: Params):
        step_lr = lr_fn(state["count"])
        if weight_decay:
            grads = {k: g + weight_decay * params[k] for k, g in grads.items()}
        if momentum:
            mu = {k: momentum * state["mu"][k] + g for k, g in grads.items()}
            eff = ({k: g + momentum * mu[k] for k, g in grads.items()}
                   if nesterov else mu)
        else:
            mu, eff = None, grads
        updates = {k: -step_lr * e for k, e in eff.items()}
        return updates, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)
