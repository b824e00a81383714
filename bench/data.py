"""The benchmark's input generators, frozen.

Copies of `src/repro_torch/data/synthetic.py`'s ``FederatedData``,
``make_federated_classification`` (with the pathological and Dirichlet
class splits of `src/repro_torch/data/partition.py`) and
``make_lm_token_data``, and of the LM example's corpus split
(`examples/lm_dpfl_torch.py`: 24 train, 12 validation, 12 test sequences
of each client's 48). The same seed gives the same arrays as the
program's own generators, and a later change to those cannot move the
benchmark's inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class FederatedData:
    """Stacked per-client arrays. x: (N, n, ...); y: (N, n)."""
    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    p: np.ndarray                      # (N,) client weights, sums to 1
    cluster: np.ndarray                # (N,) cluster id per client
    n_classes: int

    @property
    def n_clients(self) -> int:
        return self.train_x.shape[0]


def _pathological_assignment(rng, n_clients: int, n_classes: int,
                             k: int) -> np.ndarray:
    """(n_clients, n_classes) bool: exactly k distinct classes a client,
    round-robin shards so every class is used."""
    assign = np.zeros((n_clients, n_classes), dtype=bool)
    shards = []
    while len(shards) < n_clients * k:
        shards.extend(rng.permutation(n_classes).tolist())
    shards = np.array(shards[: n_clients * k]).reshape(n_clients, k)
    for i in range(n_clients):
        cls = list(dict.fromkeys(shards[i].tolist()))
        while len(cls) < k:
            c = int(rng.integers(n_classes))
            if c not in cls:
                cls.append(c)
        assign[i, cls] = True
    return assign


def _class_dists(rng, n_clients, n_classes, partition, alpha,
                 classes_per_client):
    if partition == "dirichlet":
        d = rng.dirichlet([alpha] * n_clients, size=n_classes).T
        return d / np.maximum(d.sum(1, keepdims=True), 1e-9)
    if partition == "pathological":
        a = _pathological_assignment(rng, n_clients, n_classes,
                                     classes_per_client).astype(float)
        return a / a.sum(1, keepdims=True)
    if partition == "iid":
        return np.full((n_clients, n_classes), 1.0 / n_classes)
    raise ValueError(partition)


def _sample_split(rng, dists, protos, cluster_of, n, noise):
    xs, ys = [], []
    for i in range(dists.shape[0]):
        y = rng.choice(dists.shape[1], size=n, p=dists[i])
        proto = protos[cluster_of[i]]
        eps = rng.normal(0, noise, size=(n,) + proto.shape[1:])
        xs.append((proto[y] + eps).astype(np.float32))
        ys.append(np.asarray(y, np.int32))
    return np.stack(xs), np.stack(ys)


def make_federated_classification(
        seed: int, n_clients: int, n_classes: int = 10, n_clusters: int = 4,
        partition: str = "dirichlet", alpha: float = 0.1,
        classes_per_client: int = 3, n_train: int = 64, n_val: int = 32,
        n_test: int = 32, noise: float = 0.6,
        image_shape: Optional[Tuple[int, ...]] = None,
        feature_dim: int = 32) -> FederatedData:
    """Clients in ``n_clusters`` hidden clusters, each cluster with its own
    class prototypes (smoothed Gaussian images), label skew from
    ``partition``; uniform client weights (the program's ``p_mode=
    "uniform"``, ``assign_level="client"``)."""
    rng = np.random.default_rng(seed)
    shape = tuple(image_shape) if image_shape else (feature_dim,)
    protos = rng.normal(0, 1.0, size=(n_clusters, n_classes) + shape)
    if image_shape:
        for _ in range(2):
            protos = 0.5 * protos + 0.25 * np.roll(protos, 1, axis=-2) \
                + 0.25 * np.roll(protos, -1, axis=-2)
    cluster_of = np.arange(n_clients) % n_clusters
    rng.shuffle(cluster_of)
    dists = _class_dists(rng, n_clients, n_classes, partition, alpha,
                         classes_per_client)
    tr = _sample_split(rng, dists, protos, cluster_of, n_train, noise)
    va = _sample_split(rng, dists, protos, cluster_of, n_val, noise)
    te = _sample_split(rng, dists, protos, cluster_of, n_test, noise)
    p = np.full(n_clients, 1.0 / n_clients)
    return FederatedData(*tr, *va, *te, p=p, cluster=cluster_of,
                         n_classes=n_classes)


def make_lm_token_data(seed: int, n_clients: int, vocab: int, seq_len: int,
                       n_seqs: int, n_clusters: int = 2):
    """Per-cluster bigram corpora: (N, n_seqs, seq_len + 1) int32 tokens and
    each client's cluster."""
    rng = np.random.default_rng(seed)
    tables = rng.dirichlet([0.05] * vocab, size=(n_clusters, vocab))
    cluster_of = np.arange(n_clients) % n_clusters
    out = np.zeros((n_clients, n_seqs, seq_len + 1), np.int32)
    for i in range(n_clients):
        t = tables[cluster_of[i]]
        x = rng.integers(0, vocab, size=n_seqs)
        seq = [x]
        for _ in range(seq_len):
            u = rng.random((n_seqs, 1))
            nxt = (t[seq[-1]].cumsum(1) > u).argmax(1)
            seq.append(nxt.astype(np.int64))
        out[i] = np.stack(seq, 1).astype(np.int32)
    return out, cluster_of


def lm_federated_data(seed: int, n_clients: int, vocab: int, seq_len: int,
                      n_seqs: int, n_clusters: int,
                      split: Tuple[int, int]) -> FederatedData:
    """The LM example's corpus as `FederatedData`: token rows as x, zero
    labels (the loss reads the next token), uniform weights."""
    tokens, cluster_of = make_lm_token_data(seed, n_clients, vocab, seq_len,
                                            n_seqs, n_clusters)
    tr, va, te = np.split(tokens, list(split), axis=1)
    return FederatedData(
        train_x=tr, train_y=np.zeros(tr.shape[:2], np.int32),
        val_x=va, val_y=np.zeros(va.shape[:2], np.int32),
        test_x=te, test_y=np.zeros(te.shape[:2], np.int32),
        p=np.full(n_clients, 1.0 / n_clients), cluster=cluster_of,
        n_classes=vocab)
