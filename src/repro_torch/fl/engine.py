"""Stacked-client federated simulation engine (port of `repro.fl.engine`).

All N client models live in one dict of tensors with a leading client
axis. Local training is one batched forward and backward over the N
clients per minibatch (grouped convolutions, batched matmuls); the
graph ops work on the flat (N, P) table, whose layout is `repro`'s
(`repro_torch.interop`). Data is uploaded to the device once, at
construction.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .. import prng
from ..models.classifier import accuracy as _acc
from ..models.classifier import xent_loss as _xent
from ..optim import Optimizer, sgd

Params = Dict[str, torch.Tensor]


class FLEngine:
    def __init__(self, model, data, lr: float = 0.05, momentum: float = 0.9,
                 weight_decay: float = 1e-3, batch_size: int = 16,
                 loss_fn: Optional[Callable] = None, device=None):
        """``device`` defaults to ``cuda``; nothing falls back to the CPU
        when there is no GPU (pass ``device="cpu"`` to run there).
        ``loss_fn(params, batch)`` maps a client-stacked batch to (N,)
        losses (default: the model's mean cross-entropy)."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            # IEEE fp32 everywhere: cuDNN would otherwise run the PaperCNN
            # convs in TF32 (about three decimal digits), and the greedy's
            # a/(a+b) coin flips amplify that noise into different graphs
            # (DESIGN.md §8); the reference accumulates in full fp32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model
        self.data = data
        self.batch_size = min(batch_size, data.train_x.shape[1])
        self.opt: Optimizer = sgd(lr, momentum=momentum,
                                  weight_decay=weight_decay)
        self.loss_fn: Callable = loss_fn or (lambda p, b: _xent(model, p, b))
        self.acc_fn: Callable = lambda p, b: _acc(model, p, b)
        self.p = self._put(data.p, torch.float32)
        # flat layout: leaves in sorted-key order (jax's ravel_pytree)
        example = model.init(prng.PRNGKey(0))
        self._keys = sorted(example)
        self._shapes = {k: tuple(example[k].shape) for k in self._keys}
        self._sizes = [math.prod(self._shapes[k]) for k in self._keys]
        self.n_params = sum(self._sizes)
        self.train_data = (self._put(data.train_x, torch.float32),
                           self._put(data.train_y, torch.int64))
        self.val_data = (self._put(data.val_x, torch.float32),
                         self._put(data.val_y, torch.int64))
        self.test_data = (self._put(data.test_x, torch.float32),
                          self._put(data.test_y, torch.int64))

    def _put(self, arr, dtype):
        return torch.as_tensor(arr).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------ plumbing
    def init_clients(self, key: torch.Tensor) -> Params:
        """Same init for all clients (paper Alg. 1: every local model starts
        from w)."""
        params = self.model.init(key.to(self.device))
        N = self.data.n_clients
        return {k: v[None].expand((N,) + v.shape).clone()
                for k, v in params.items()}

    def flatten(self, stacked: Params) -> torch.Tensor:
        """Client-stacked dict (leaves (N, ...)) -> (N, P) fp32 rows,
        leaves in sorted-key order."""
        N = stacked[self._keys[0]].shape[0]
        return torch.cat([stacked[k].reshape(N, -1) for k in self._keys],
                         dim=1)

    def unflatten(self, flat: torch.Tensor) -> Params:
        """(..., P) flat rows -> dict of (..., *leaf shape) views; exact
        inverse of `flatten`."""
        lead = flat.shape[:-1]
        parts = torch.split(flat, self._sizes, dim=-1)
        return {k: part.reshape(lead + self._shapes[k])
                for k, part in zip(self._keys, parts)}

    # ------------------------------------------------------------ training
    def _loss_and_grads(self, params: Params, batch, loss_fn: Callable):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = loss_fn(leaves, batch)
            # client parameters are disjoint, so the gradient of the sum
            # of per-client mean losses is each client's own gradient
            grads = torch.autograd.grad(loss.sum(),
                                        [leaves[k] for k in self._keys])
        return loss.detach(), dict(zip(self._keys, grads))

    def local_train(self, stacked: Params, key: torch.Tensor, epochs: int,
                    loss_fn: Optional[Callable] = None):
        """``epochs`` seeded epochs of minibatch SGD on every client.
        Returns (stacked', (N,) mean loss). Client i shuffles epoch e with
        ``split(split(key, N)[i], epochs)[e]`` and takes ``n // bs``
        minibatches, dropping the remainder; momentum starts from zero at
        every call (`repro.fl.engine.FLEngine.local_train`). ``loss_fn``
        (default ``self.loss_fn``) is the loss every step differentiates:
        FedProx and Ditto add their proximal term there."""
        return self.local_train_with_labels(stacked, key, epochs,
                                            self.train_data[1], loss_fn)

    # `repro`'s name for the same call (the un-jitted local train)
    train_fn = local_train

    def local_train_with_labels(self, stacked: Params, key: torch.Tensor,
                                epochs: int, ys: torch.Tensor,
                                loss_fn: Optional[Callable] = None):
        """`local_train` on the (N, n_train) label table ``ys`` in place of
        the clean labels (the label-flip attack): the same minibatches
        from the same key."""
        loss_fn = self.loss_fn if loss_fn is None else loss_fn
        x, y = self.train_data[0], ys
        N, n = y.shape
        bs = self.batch_size
        nb = n // bs
        ekeys = prng.split(prng.split(key.to(self.device), N), epochs)
        perms = prng.permutation(ekeys, n)[..., :nb * bs]  # (N, epochs, nb*bs)
        rows = torch.arange(N, device=self.device)[:, None]
        params = {k: v.detach().clone() for k, v in stacked.items()}
        opt_state = self.opt.init(params)
        epoch_losses = []
        for e in range(epochs):
            xe, ye = x[rows, perms[:, e]], y[rows, perms[:, e]]
            step_losses = []
            for b in range(nb):
                sl = slice(b * bs, (b + 1) * bs)
                loss, grads = self._loss_and_grads(
                    params, {"x": xe[:, sl], "y": ye[:, sl]}, loss_fn)
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     params)
                params = {k: params[k] + updates[k] for k in self._keys}
                step_losses.append(loss)
            epoch_losses.append(torch.stack(step_losses).mean(0))
        return params, torch.stack(epoch_losses).mean(0)

    # ------------------------------------------------------------- metrics
    @torch.no_grad()
    def _eval_split(self, stacked: Params, xs, ys):
        batch = {"x": xs, "y": ys}
        return self.acc_fn(stacked, batch), self.loss_fn(stacked, batch)

    def eval_val(self, stacked: Params):
        """Per-client validation metrics: ``(acc (N,), loss (N,))``, each
        client on its own validation split."""
        return self._eval_split(stacked, *self.val_data)

    def eval_test(self, stacked: Params):
        """Per-client test metrics, same contract as `eval_val`."""
        return self._eval_split(stacked, *self.test_data)

    def make_reward_fn(self):
        """reward(probes (K, Q, P), k_idx (K,)) -> (K, Q): the negative
        validation loss of client ``k_idx[i]`` at each of its Q probe
        models (Eq. 7), all K*Q models in one batched forward."""
        val_x, val_y = self.val_data

        @torch.no_grad()
        def reward(probes: torch.Tensor, k_idx: torch.Tensor):
            K, Q = probes.shape[:2]
            params = self.unflatten(probes.reshape(K * Q, -1))
            x = val_x[k_idx][:, None].expand((K, Q) + val_x.shape[1:])
            y = val_y[k_idx][:, None].expand((K, Q) + val_y.shape[1:])
            batch = {"x": x.reshape((K * Q,) + val_x.shape[1:]),
                     "y": y.reshape((K * Q,) + val_y.shape[1:])}
            return -self.loss_fn(params, batch).reshape(K, Q)

        return reward
