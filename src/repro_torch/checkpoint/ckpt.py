"""Filesystem checkpointing: a tree of tensors <-> .npz + a structure
JSON, port of `repro.checkpoint.ckpt`, in its file format.

A tree is a dict, list or tuple of trees, None (no leaf) or a leaf (a
tensor, array or number). Each leaf is stored under `repro`'s key, the
"/"-joined path of dict keys and sequence indices with dict keys in
sorted order, so the port's files load with `repro.checkpoint.load_pytree`
and `repro`'s with the port's. The JSON holds the sorted ``keys``, the
``metadata`` and, under ``treedef``, the structure written the way jax
prints a treedef (``PyTreeDef({'a': *, 'b': [*, *]})``); no loader reads
that field. Supports the paper's protocol of keeping the best-on-
validation model (`CheckpointManager.keep_best`) and periodic snapshots
with retention.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs in jax's leaf order: dict keys sorted, sequences
    in order, None holding no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, prefix + (i,))
    else:
        yield "/".join(str(p) for p in prefix), tree


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(t) for t in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: _numpy(v) for k, v in _items(tree)}
    np.savez(path + ".npz", **arrays)
    meta = {"treedef": f"PyTreeDef({_structure(tree)})",
            "keys": sorted(arrays), "metadata": metadata or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: keys and shapes validated,
    each leaf a tensor on the device and of the dtype of ``like``'s leaf
    at its place."""
    ref = list(_items(like))
    with np.load(path + ".npz") as data:
        keys = [k for k, _ in ref]
        if sorted(data.files) != sorted(keys):
            missing = set(keys) - set(data.files)
            extra = set(data.files) - set(keys)
            raise ValueError(f"checkpoint mismatch: missing={missing} "
                             f"extra={extra}")
        out = []
        for key, leaf in ref:
            arr = data[key]
            want = torch.as_tensor(leaf) if not isinstance(
                leaf, torch.Tensor) else leaf
            if arr.shape != tuple(want.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(want.shape)}")
            out.append(torch.from_numpy(arr).to(device=want.device,
                                                dtype=want.dtype))
    return _rebuild(like, iter(out))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._best_metric = -float("inf")

    def save_step(self, step: int, tree: Any,
                  metadata: Optional[dict] = None):
        save_pytree(os.path.join(self.dir, f"step_{step:08d}"), tree,
                    {**(metadata or {}), "step": step})
        self._gc()

    def keep_best(self, metric: float, tree: Any,
                  metadata: Optional[dict] = None) -> bool:
        """Paper §4.1: retain the best model on the validation metric."""
        if metric <= self._best_metric:
            return False
        self._best_metric = metric
        save_pytree(os.path.join(self.dir, "best"), tree,
                    {**(metadata or {}), "metric": float(metric)})
        return True

    def _steps(self):
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("step_") and f.endswith(".json"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, load_pytree(os.path.join(self.dir, f"step_{s:08d}"), like)

    def restore_best(self, like: Any):
        p = os.path.join(self.dir, "best")
        if not os.path.exists(p + ".npz"):
            return None
        return load_pytree(p, like)

    def _gc(self):
        for s in self._steps()[: -self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s:08d}{ext}"))
                except OSError:
                    pass
