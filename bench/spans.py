"""Spans and recorders the benchmark puts around the program's layers at
run time, from outside the program (no file of `src/` is edited).

`Spans.install` wraps the entry of each layer the per-layer metrics read:
the local train (``engine.local_train``), the reward forwards
(``engine.make_reward_fn``), the evaluation (``engine.eval_val``), the
GGC refresh (``core.dpfl.all_clients_graph`` and
``all_clients_graph_sparse``), the codec (``fl.compress.
compress_exchange``) and the kernel entries K1 (``kernels.graph_mix.
graph_mix``), K2 (``kernels.sparse_graph_mix.sparse_graph_mix``) and K4
(``kernels.flash_attention._forward`` and ``flash_attention_bwd``). The
engine's wrappers go on before the round step is built, which binds
them.

A wrapper does nothing but call through unless a flag is on:
``tracing`` opens a ``torch.profiler.record_function`` range named
``bench::<layer>`` around the call (and keeps the kernel calls' shapes,
which the rooflines read); ``recording`` keeps what the check compares
(the local train's first input panel, its output, its first gradient
and mean loss, every reward call, the validation accuracies): as host
copies where ``to_host`` is on (set-up, outside the program's no-sync
fence), else as copies on the device (a round runs inside the fence).
The timed window runs with ``recording`` off; the untraced run with both
off.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Callable, Dict, List

import torch

PREFIX = "bench::"


class Spans:
    def __init__(self):
        self.tracing = False
        self.recording = False
        self.to_host = False
        self.calls: Dict[str, List[dict]] = {"k1": [], "k2": [], "k4": [],
                                             "k4_bwd": []}
        self.record: Dict[str, list] = {}
        self._undo: List[Callable] = []

    def keep(self, x):
        """A copy of ``x`` that the program's later writes do not reach."""
        x = x.detach()
        return x.to("cpu", copy=True) if self.to_host else x.clone()

    def _range(self, layer: str):
        if self.tracing:
            return torch.profiler.record_function(PREFIX + layer)
        return nullcontext()

    def _wrap(self, owner, attr: str, layer: str, before=None, after=None):
        """Replace ``owner.attr`` by a wrapper that opens the layer's range
        while tracing; ``before(args, kwargs)`` and ``after(out)`` run
        outside the range."""
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (spans.tracing or spans.recording):
                return fn(*args, **kwargs)
            if before is not None:
                before(args, kwargs)
            with spans._range(layer):
                out = fn(*args, **kwargs)
            if after is not None:
                after(out)
            return out

        # a kernel wrapper counts its launches on its function's attribute
        if hasattr(fn, "launches"):
            wrapper.launches = fn.launches
        had = attr in vars(owner)
        setattr(owner, attr, wrapper)
        self._undo.append(lambda: setattr(owner, attr, fn) if had
                          else delattr(owner, attr))
        return wrapper

    def uninstall(self):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    # ------------------------------------------------------------ install
    def install(self, engine):
        from repro_torch.core import dpfl
        from repro_torch.fl import compress
        from repro_torch.kernels import flash_attention as k4
        from repro_torch.kernels import graph_mix as k1
        from repro_torch.kernels import sparse_graph_mix as k2

        spans = self

        def keep_start(args, kwargs):
            if spans.recording and "start" not in spans.record:
                spans.record["start"] = spans.keep(engine.flatten(args[0]))

        def keep_trained(out):
            if spans.recording:
                stacked, loss = out
                spans.record["trained"] = spans.keep(engine.flatten(stacked))
                spans.record["train_loss"] = spans.keep(loss)

        self._wrap(engine, "local_train", "local_train", before=keep_start,
                   after=keep_trained)

        # the first gradient of the round's local train, as the optimizer
        # gets it
        opt = engine.opt

        def update(grads, state, params):
            if spans.recording and "grad" not in spans.record:
                spans.record["grad"] = spans.keep(engine.flatten(
                    {k: g.detach() for k, g in grads.items()}))
            return opt.update(grads, state, params)

        engine.opt = opt._replace(update=update)
        self._undo.append(lambda: setattr(engine, "opt", opt))

        def keep_acc(out):
            if spans.recording:
                spans.record["val_acc"] = spans.keep(out[0])

        self._wrap(engine, "eval_val", "eval", after=keep_acc)

        make_reward = engine.make_reward_fn

        def make_reward_fn():
            reward = make_reward()

            def recorded(probes, k_idx):
                r = reward(probes, k_idx)
                if spans.recording:
                    spans.record.setdefault("rewards", []).append(
                        (spans.keep(k_idx), spans.keep(r)))
                return r
            return recorded

        engine.make_reward_fn = make_reward_fn
        self._undo.append(lambda: delattr(engine, "make_reward_fn"))

        self._wrap(dpfl, "all_clients_graph", "greedy")
        self._wrap(dpfl, "all_clients_graph_sparse", "greedy")
        self._wrap(compress, "compress_exchange", "codec")

        def k1_shape(args, kwargs):
            A, W = args[:2]
            if spans.tracing:
                spans.calls["k1"].append(dict(
                    M=A.shape[0], N=A.shape[1], P=W.shape[1],
                    element_size=W.element_size()))

        self._wrap(k1, "graph_mix", "k1", before=k1_shape)

        def k2_shape(args, kwargs):
            self_w, nbr_w, nbr_idx, W_self, W_peers = args[:5]
            if spans.tracing:
                spans.calls["k2"].append(dict(
                    N=W_self.shape[0], B=nbr_idx.shape[1], P=W_self.shape[1],
                    element_size=W_self.element_size(),
                    # the lists are read once the window has closed
                    idx=nbr_idx.clone(),
                    separate=W_peers.data_ptr() != W_self.data_ptr()))

        self._wrap(k2, "sparse_graph_mix", "k2", before=k2_shape)

        def k4_shape(key):
            def before(args, kwargs):
                q, k = args[0], args[1]
                causal, window = (args[3], args[4]) if key == "k4" else \
                    (kwargs.get("causal", True), kwargs.get("window"))
                if spans.tracing:
                    spans.calls[key].append(dict(
                        B=q.shape[0], Sq=q.shape[1], Sk=k.shape[1],
                        Hq=q.shape[2], Hkv=k.shape[2], hd=q.shape[3],
                        causal=bool(causal), window=window,
                        element_size=q.element_size()))
            return before

        self._wrap(k4, "_forward", "k4", before=k4_shape("k4"))
        self._wrap(k4, "flash_attention_bwd", "k4", before=k4_shape("k4_bwd"))
        return self
