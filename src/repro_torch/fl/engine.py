"""Stacked-client federated simulation engine (port of `repro.fl.engine`).

All N client models live in one dict of tensors with a leading client
axis. Local training is one batched forward and backward over the N
clients per minibatch (grouped convolutions, batched matmuls); the
graph ops work on the flat (N, P) table, whose layout is `repro`'s
(`repro_torch.interop`). Data is uploaded to the device once, at
construction: float features as float32, token ids as int64.

`shard_clients` puts the client axis on a client mesh
(`repro_torch.launch.mesh`, one process per shard): the engine then holds
only its rank's rows of the data, and `init_clients`, `local_train` and
the ``eval_*`` functions work on those rows, while each client's key
stream stays its row of the global one. Only the graph ops cross ranks.

``loss_fn`` and ``acc_fn`` take client-stacked params and batches and
return (N,) values. `repro` vmaps a one-client function over the clients
instead; `vmap_clients` is that bridge here (``torch.func.vmap`` over
``torch.func.functional_call``), and it is how a one-client LM loss or
accuracy (``fn(module, batch)``) becomes the stacked contract. The engine
itself knows one contract only.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import obs as _obs
from .. import prng
from ..models.classifier import accuracy as _acc
from ..models.classifier import xent_loss as _xent
from ..optim import Optimizer, sgd

Params = Dict[str, torch.Tensor]


class _ClientCall(nn.Module):
    """``fn(module, batch)`` as a module's forward, so that
    ``functional_call`` can swap ``module``'s weights for one client's."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, batch, *args):
        return self.fn(self.module, batch, *args)


def vmap_clients(module: nn.Module, fn: Callable) -> Callable:
    """The one-client ``fn(module, batch, *args)`` (``module`` carrying
    one client's weights) over stacked clients:
    ``stacked_fn(params, batch, *args)``, with ``params`` keyed as
    ``module.state_dict()`` with a leading client axis and ``batch`` a
    pytree of tensors with the same leading axis, returns ``fn``'s
    outputs stacked on that axis; ``args`` reach every client as they
    are (a decode step's host position). It is ``torch.func.vmap`` over
    ``torch.func.functional_call`` of ``fn``, what `repro`'s ``jax.vmap
    (lambda p, x, y: ...)`` is. For a scalar ``fn`` (a loss, an
    accuracy) it is the engine's stacked contract, (N,) values, and
    gradients reach ``params`` through plain autograd (`FLEngine` takes
    ``torch.autograd.grad`` of the sum). K4 runs under the vmap on the
    folded client and batch axes (`repro_torch.kernels.flash_attention`).

    A module under activation recompute (a `DecoderLM` built with
    ``remat="full"``) is refused: ``torch.utils.checkpoint`` under vmap
    fails in the backward ("tensor may have escaped from inside a
    function being vmapped"). Build models for DPFL with
    ``remat="none"``; remat changes no value."""
    if getattr(module, "remat", None) == "full":
        raise ValueError(
            "vmap_clients: the module runs its layers under activation "
            "recompute (remat='full'), and torch.utils.checkpoint under "
            "torch.func.vmap fails in the backward; build it with "
            "remat='none'")
    call = _ClientCall(module, fn)

    def one(params: Params, batch, *args):
        return torch.func.functional_call(
            call, {f"module.{k}": v for k, v in params.items()},
            (batch,) + args)

    def stacked_fn(params: Params, batch, *args):
        return torch.func.vmap(one, in_dims=(0, 0) + (None,) * len(args))(
            params, batch, *args)

    return stacked_fn


class FLEngine:
    def __init__(self, model, data, lr: float = 0.05, momentum: float = 0.9,
                 weight_decay: float = 1e-3, batch_size: int = 16,
                 loss_fn: Optional[Callable] = None,
                 acc_fn: Optional[Callable] = None, device=None,
                 mesh=None, client_axes=None,
                 client_chunk: Optional[int] = None):
        """``device`` defaults to ``cuda``; nothing falls back to the CPU
        when there is no GPU (pass ``device="cpu"`` to run there).
        ``loss_fn(params, batch)`` and ``acc_fn(params, batch)`` map
        client-stacked params and batches to (N,) losses and accuracies
        (defaults: the classifier's mean cross-entropy and accuracy); a
        one-client function goes through `vmap_clients` first.
        `eval_val` and `eval_test` (so `run_dpfl`'s validation and test
        accuracies) use ``acc_fn``. ``mesh`` / ``client_axes``: as
        `shard_clients`. ``client_chunk``: the forward and backward of
        local training, evaluation, the greedy's reward probes and the
        GGC / BGGC refresh (`core.graph`'s ``client_chunk``) on this many
        clients at a time (None: all of the engine's rows at once). A
        client's values and the selections do not depend on it, except
        that on a card cuDNN picks its grouped-convolution algorithms by
        the group count, so a single-device run with the chunk a rank's
        N / D is the bit-for-bit twin of a client-mesh run. It bounds the
        working set to a chunk's activations and the greedy's decision
        state: LM clients of a billion weights need it. Their panels
        (gigabytes a row) are allocated and freed in turn, which
        fragments the caching allocator's pool until a round fails with
        memory to spare: run them with
        ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` (a setting of
        the whole process, which the engine leaves to it). On a card the
        engine turns TF32 off and cuDNN's deterministic algorithms on,
        for the whole process."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            # IEEE fp32 everywhere: cuDNN would otherwise run the PaperCNN
            # convs in TF32 (about three decimal digits), and the greedy's
            # a/(a+b) coin flips amplify that noise into different graphs
            # (DESIGN.md §8); the reference accumulates in full fp32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            # and the same bits on a rerun: cuDNN's default convolution
            # backward adds in a nondeterministic order, so two runs of
            # one config part within a round (tools/dpfl_repeat.py)
            torch.backends.cudnn.deterministic = True
        self.model = model
        self.data = data
        self.batch_size = min(batch_size, data.train_x.shape[1])
        self.opt: Optimizer = sgd(lr, momentum=momentum,
                                  weight_decay=weight_decay)
        self.loss_fn: Callable = loss_fn or (lambda p, b: _xent(model, p, b))
        self.acc_fn: Callable = acc_fn or (lambda p, b: _acc(model, p, b))
        self.p = self._put(data.p, torch.float32)
        # flat layout: leaves in sorted-key order (jax's ravel_pytree), read
        # from a module's own state dict (no draw; a `DecoderLM.init` would
        # also re-point its weights), else from an init drawn on the device
        example = (model.state_dict() if isinstance(model, nn.Module)
                   else model.init(prng.PRNGKey(0, device=self.device)))
        self._keys = sorted(example)
        self._shapes = {k: tuple(example[k].shape) for k in self._keys}
        self._sizes = [math.prod(self._shapes[k]) for k in self._keys]
        self.n_params = sum(self._sizes)
        # the constructor's ``client_chunk``; the verification twins
        # (chip_smoke.py, tools/dpfl_repeat.py, the tests) set it after
        # construction
        self._client_chunk: Optional[int] = client_chunk
        self.mesh = None
        self.client_axes = None
        #: the engine's rows of the client axis: all of them, or this
        #: rank's block under a client mesh
        self.rows = slice(0, data.n_clients)
        if mesh is not None:
            self.shard_clients(mesh, client_axes)
        else:
            self._upload()

    def _upload(self):
        """Put the engine's rows of the client data on the device, once."""
        d, r = self.data, self.rows
        self.train_data = (self._put_x(d.train_x[r]),
                           self._put(d.train_y[r], torch.int64))
        self.val_data = (self._put_x(d.val_x[r]),
                         self._put(d.val_y[r], torch.int64))
        self.test_data = (self._put_x(d.test_x[r]),
                          self._put(d.test_y[r], torch.int64))

    def _put(self, arr, dtype):
        return torch.as_tensor(arr).to(device=self.device, dtype=dtype)

    def _put_x(self, arr):
        """Features as float32; integer data (token ids) as int64, as
        `repro` keeps the array's dtype."""
        t = torch.as_tensor(arr)
        return self._put(t, torch.float32 if t.is_floating_point()
                         else torch.int64)

    # ----------------------------------------------------------- sharding
    def shard_clients(self, mesh, client_axes=None):
        """Put the client axis on ``client_axes`` of ``mesh`` (default:
        whichever of ('pod', 'data') it has), a
        `repro_torch.launch.mesh.make_client_mesh` mesh in this rank's
        process: the engine keeps this rank's block of N / D clients (D
        the product of the client axes' sizes; N must divide) and uploads
        only their data. ``p`` stays whole: the Eq.-4 weights name peers.
        Any model: the classifiers, or LM clients (an ``nn.Module`` with
        `vmap_clients`' loss and accuracy, which then map over the rank's
        rows). Returns the engine."""
        from ..sharding import collectives as coll

        ca = coll.client_axes_of(mesh, client_axes)
        n_shards = coll.num_shards(mesh, ca)
        N = self.data.n_clients
        if N % n_shards:
            raise ValueError(
                f"n_clients={N} not divisible by the {n_shards} client "
                f"shards of axes {ca}")
        n_loc = N // n_shards
        lo = coll.shard_index(mesh, ca) * n_loc
        self.mesh, self.client_axes = mesh, ca
        self.rows = slice(lo, lo + n_loc)
        self._upload()
        return self

    def whole(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """``x``, a table of the engine's clients on ``axis``, with that
        axis whole: ``x`` itself on one device, all-gathered from every
        shard under a client mesh (a collective: every rank calls it)."""
        if self.mesh is None:
            return x
        from ..sharding import collectives as coll

        rows = coll.all_gather_rows(x.movedim(axis, 0).contiguous(),
                                    self.mesh, self.client_axes)
        return rows.movedim(0, axis)

    @property
    def n_local(self) -> int:
        """Clients on this engine: N, or this rank's block under a mesh."""
        return self.rows.stop - self.rows.start

    # ------------------------------------------------------------ plumbing
    def init_clients(self, key: torch.Tensor) -> Params:
        """Same init for all clients (paper Alg. 1: every local model starts
        from w), on the engine's rows."""
        params = self.model.init(key.to(self.device))
        n = self.n_local
        return {k: v[None].expand((n,) + v.shape).clone()
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
    def _chunked(self, fn: Callable, params: Params, batch):
        """``fn(params, batch)`` -> a tuple of outputs (tensors or dicts
        of tensors on the client axis), on `_client_chunk` clients at a
        time, each chunk's outputs copied into their rows of the whole
        outputs as it comes (the bits of a concatenation, with one
        chunk's outputs live beside them)."""
        n, c = self.n_local, self._client_chunk
        if c is None or c >= n:
            return fn(params, batch)
        def whole(x):
            return x.new_empty((n,) + x.shape[1:])

        outs = None
        for i in range(0, n, c):
            part = fn({k: v[i:i + c] for k, v in params.items()},
                      {k: v[i:i + c] for k, v in batch.items()})
            if outs is None:
                outs = tuple({k: whole(x) for k, x in o.items()}
                             if isinstance(o, dict) else whole(o)
                             for o in part)
            for out, o in zip(outs, part):
                for k, x in (o.items() if isinstance(o, dict) else
                             [(None, o)]):
                    (out if k is None else out[k])[i:i + x.shape[0]] = x
            del part
        return outs

    def _loss_and_grads(self, params: Params, batch, loss_fn: Callable):
        # a loss other than the engine's own (FedProx's, which closes
        # over every row's reference) runs on all rows at once
        if loss_fn is not self.loss_fn:
            return self._loss_and_grads_once(params, batch, loss_fn)
        return self._chunked(
            lambda pp, bb: self._loss_and_grads_once(pp, bb, loss_fn),
            params, batch)

    def _loss_and_grads_once(self, params: Params, batch,
                             loss_fn: Callable):
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
        ``split(split(key, N)[i], epochs)[e]`` (N all the clients: under
        a mesh a rank takes its rows of the global split) and takes
        ``n // bs``
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
        from the same key. A ``loss_fn`` given here runs on all rows at
        once, whatever `_client_chunk` is."""
        loss_fn = self.loss_fn if loss_fn is None else loss_fn
        x, y = self.train_data[0], ys
        N, n = y.shape
        bs = self.batch_size
        nb = n // bs
        ekeys = prng.split(prng.split(key.to(self.device),
                                      self.data.n_clients)[self.rows], epochs)
        perms = prng.permutation(ekeys, n)[..., :nb * bs]  # (N, epochs, nb*bs)
        rows = torch.arange(N, device=self.device)[:, None]
        params = {k: v.detach().clone() for k, v in stacked.items()}
        opt_state = self.opt.init(params)
        epoch_losses = []
        for e in range(epochs):
            with _obs.span("local_train.gather"):
                xe, ye = x[rows, perms[:, e]], y[rows, perms[:, e]]
            step_losses = []
            for b in range(nb):
                sl = slice(b * bs, (b + 1) * bs)
                with _obs.span("local_train.loss_grad"):
                    loss, grads = self._loss_and_grads(
                        params, {"x": xe[:, sl], "y": ye[:, sl]}, loss_fn)
                _obs.count("local_train.steps")
                with _obs.span("local_train.update"):
                    updates, opt_state = self.opt.update(grads, opt_state,
                                                         params)
                    del grads
                    # leaf by leaf: one leaf of the old weights and of the
                    # updates outlives its own add
                    for k in self._keys:
                        params[k] = params[k] + updates.pop(k)
                step_losses.append(loss)
            epoch_losses.append(torch.stack(step_losses).mean(0))
        return params, torch.stack(epoch_losses).mean(0)

    # ------------------------------------------------------------- metrics
    @torch.no_grad()
    def _eval_split(self, stacked: Params, xs, ys):
        return self._chunked(lambda p, b: (self.acc_fn(p, b),
                                           self.loss_fn(p, b)),
                             stacked, {"x": xs, "y": ys})

    def eval_val(self, stacked: Params):
        """Per-client validation metrics: ``(acc (N,), loss (N,))``, each
        client on its own validation split."""
        return self._eval_split(stacked, *self.val_data)

    def eval_test(self, stacked: Params):
        """Per-client test metrics, same contract as `eval_val`."""
        return self._eval_split(stacked, *self.test_data)

    def make_reward_fn(self):
        """reward(probes (K, Q, P), k_idx (K,)) -> (K, Q): the negative
        validation loss of client ``k_idx[i]`` (a global id, of the
        engine's rows) at each of its Q probe models (Eq. 7), all K*Q
        models in one batched forward."""
        val_x, val_y = self.val_data
        lo = self.rows.start

        @torch.no_grad()
        def forward(probes: torch.Tensor, k_idx: torch.Tensor):
            K, Q = probes.shape[:2]
            c = self._client_chunk
            if c is not None and c < K:
                return torch.cat([forward(probes[i:i + c], k_idx[i:i + c])
                                  for i in range(0, K, c)])
            params = self.unflatten(probes.reshape(K * Q, -1))
            rows = k_idx - lo
            x = val_x[rows][:, None].expand((K, Q) + val_x.shape[1:])
            y = val_y[rows][:, None].expand((K, Q) + val_y.shape[1:])
            batch = {"x": x.reshape((K * Q,) + val_x.shape[1:]),
                     "y": y.reshape((K * Q,) + val_y.shape[1:])}
            return -self.loss_fn(params, batch).reshape(K, Q)

        def reward(probes: torch.Tensor, k_idx: torch.Tensor):
            with _obs.span("reward"):
                # the greedy's probe models, against the candidates' share
                # the scans tally (`core.graph`)
                _obs.count("ggc.probe_models",
                           probes.shape[0] * probes.shape[1])
                return forward(probes, k_idx)

        return reward
