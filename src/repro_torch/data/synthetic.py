"""Synthetic heterogeneous federated datasets (numpy).

A copy of `repro.data.synthetic`'s ``FederatedData``,
``make_federated_classification``, ``make_label_flip_data`` and
``make_lm_token_data``: clients in ``n_clusters`` hidden clusters, each
cluster with its own class-conditional Gaussian prototypes, and label
skew from a Dirichlet, pathological or iid split; the paper's §4.5
label-flip data (malicious clients under one label permutation); and
per-cluster bigram token corpora for LM training
(`repro_torch.launch.train`).
The same seed gives the same arrays in both packages (tested), so the
port and the reference train on identical data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .partition import dirichlet_proportions, pathological_assignment


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


def _class_dists(rng, n_clients, n_classes, partition, alpha,
                 classes_per_client):
    if partition == "dirichlet":
        props = dirichlet_proportions(rng, n_clients, n_classes, alpha)
        # per-client class distribution: column-normalize the (C, N) shares
        d = props.T  # (N, C): client i's share of each class
        d = d / np.maximum(d.sum(1, keepdims=True), 1e-9)
        return d
    if partition == "pathological":
        a = pathological_assignment(rng, n_clients, n_classes,
                                    classes_per_client).astype(float)
        return a / a.sum(1, keepdims=True)
    if partition == "iid":
        return np.full((n_clients, n_classes), 1.0 / n_classes)
    raise ValueError(partition)


def _sample_split(rng, dists, protos, cluster_of, n, noise, image_shape,
                  label_perm=None):
    N, C = dists.shape
    xs, ys = [], []
    for i in range(N):
        y = rng.choice(C, size=n, p=dists[i])
        proto = protos[cluster_of[i]]  # (C, ...)
        eps = rng.normal(0, noise, size=(n,) + proto.shape[1:])
        x = proto[y] + eps
        y_out = y if (label_perm is None or label_perm[i] is None) \
            else label_perm[i][y]
        xs.append(x.astype(np.float32))
        ys.append(np.asarray(y_out, np.int32))
    return np.stack(xs), np.stack(ys)


def make_federated_classification(
    seed: int = 0,
    n_clients: int = 16,
    n_classes: int = 10,
    n_clusters: int = 4,
    partition: str = "dirichlet",       # dirichlet | pathological | iid
    alpha: float = 0.1,
    classes_per_client: int = 3,
    n_train: int = 64,
    n_val: int = 32,
    n_test: int = 32,
    noise: float = 0.6,
    image_shape: Optional[Tuple[int, ...]] = None,  # e.g. (32, 32, 3)
    feature_dim: int = 32,
    p_mode: str = "uniform",       # uniform | size (p_k from the clients'
    #                                actual effective train-set sizes)
    assign_level: str = "client",  # client | cluster (peers share classes)
) -> FederatedData:
    """Synthetic federated classification benchmark (DESIGN.md §7): the
    paper's CIFAR-10 heterogeneity structure at CPU-testable sizes.

    Clients belong to ``n_clusters`` hidden clusters; each cluster has
    its own label-conditional feature distribution (Gaussian prototypes
    + ``noise``), and label skew comes from ``partition``: "dirichlet"
    (concentration ``alpha``), "pathological" (``classes_per_client``
    distinct classes per client) or "iid". With
    ``assign_level="cluster"`` all clients of a cluster share one class
    distribution — true statistical peers, the structure GGC should
    discover.

    Returns a `FederatedData` of stacked arrays: ``train_x`` is
    ``(N, n_train) + shape`` fp where ``shape`` is ``image_shape`` or
    ``(feature_dim,)``; ``train_y`` is ``(N, n_train)`` int labels in
    ``[0, n_classes)`` (val/test alike with their own sizes);
    ``p`` is ``(N,)`` fp64 aggregation weights summing to 1 (uniform, or
    proportional to distinct-sample counts with ``p_mode="size"``);
    ``cluster`` is ``(N,)`` int cluster ids."""
    rng = np.random.default_rng(seed)
    shape = image_shape if image_shape else (feature_dim,)
    # cluster prototypes; smooth images a little so convs have structure
    protos = rng.normal(0, 1.0, size=(n_clusters, n_classes) + shape)
    if image_shape:
        # cheap separable smoothing
        for _ in range(2):
            protos = 0.5 * protos + 0.25 * np.roll(protos, 1, axis=-2) \
                + 0.25 * np.roll(protos, -1, axis=-2)
    cluster_of = np.arange(n_clients) % n_clusters
    rng.shuffle(cluster_of)
    if assign_level == "cluster":
        # clients of a cluster share one heterogeneous class distribution —
        # true statistical peers (the structure GGC should discover)
        cd = _class_dists(rng, n_clusters, n_classes, partition, alpha,
                          classes_per_client)
        dists = cd[cluster_of]
    else:
        dists = _class_dists(rng, n_clients, n_classes, partition, alpha,
                             classes_per_client)
    tr = _sample_split(rng, dists, protos, cluster_of, n_train, noise, shape)
    va = _sample_split(rng, dists, protos, cluster_of, n_val, noise, shape)
    te = _sample_split(rng, dists, protos, cluster_of, n_test, noise, shape)
    if p_mode == "uniform":
        p = np.full(n_clients, 1.0 / n_clients)
    else:
        # size-proportional: the Eq.-4 weights p_k must describe the data
        # the clients actually train on, not virtual sizes drawn on the
        # side. Each client keeps a rng-drawn EFFECTIVE sample count
        # n_eff_i in [max(1, n_train/4), n_train]; rows beyond n_eff_i are
        # resampled (with replacement) from the first n_eff_i, so the
        # stacked arrays stay equal-sized (vmap-friendly) while the
        # client's true dataset has exactly n_eff_i distinct samples —
        # and p_k = n_eff_k / sum_j n_eff_j matches the data (tested).
        tr_x, tr_y = tr
        sizes = rng.integers(max(1, n_train // 4), n_train + 1, n_clients)
        for i in range(n_clients):
            n_eff = int(sizes[i])
            if n_eff < n_train:
                fill = rng.integers(0, n_eff, n_train - n_eff)
                tr_x[i, n_eff:] = tr_x[i, fill]
                tr_y[i, n_eff:] = tr_y[i, fill]
        tr = (tr_x, tr_y)
        p = sizes.astype(float) / sizes.sum()
    return FederatedData(*tr, *va, *te, p=p, cluster=cluster_of,
                         n_classes=n_classes)


def make_label_flip_data(seed: int = 0, n_clients: int = 10,
                         n_malicious: int = 4, n_classes: int = 10,
                         feature_dim: int = 32, **kw) -> FederatedData:
    """Paper §4.5's label-flip data: ``n_malicious`` clients, drawn at
    random, see every label through one fixed derangement of the classes;
    all clients share one set of class prototypes (iid labels, one
    cluster of features). ``cluster`` is 1 for the malicious clients and
    0 for the benign ones. `repro.data.make_label_flip_data`'s code: the
    same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    shape = (feature_dim,)
    protos = rng.normal(0, 1.0, size=(1, n_classes) + shape)
    cluster_of = np.zeros(n_clients, int)
    dists = _class_dists(rng, n_clients, n_classes, "iid", 0.0, 0)
    perm = rng.permutation(n_classes)
    while np.any(perm == np.arange(n_classes)):
        perm = rng.permutation(n_classes)
    mal = rng.choice(n_clients, n_malicious, replace=False)
    label_perm = [perm if i in mal else None for i in range(n_clients)]
    kw.setdefault("n_train", 64)
    kw.setdefault("n_val", 32)
    kw.setdefault("n_test", 32)
    kw.setdefault("noise", 0.5)
    tr = _sample_split(rng, dists, protos, cluster_of, kw["n_train"],
                       kw["noise"], shape, label_perm)
    va = _sample_split(rng, dists, protos, cluster_of, kw["n_val"],
                       kw["noise"], shape, label_perm)
    te = _sample_split(rng, dists, protos, cluster_of, kw["n_test"],
                       kw["noise"], shape, label_perm)
    cluster = np.array([1 if i in mal else 0 for i in range(n_clients)])
    p = np.full(n_clients, 1.0 / n_clients)
    return FederatedData(*tr, *va, *te, p=p, cluster=cluster,
                         n_classes=n_classes)


def make_lm_token_data(seed: int, n_clients: int, vocab: int, seq_len: int,
                       n_seqs: int, n_clusters: int = 2):
    """Synthetic LM corpora: per-cluster bigram transition tables (used by
    the LM-scale DPFL examples and the end-to-end training entry point)."""
    rng = np.random.default_rng(seed)
    tables = rng.dirichlet([0.05] * vocab, size=(n_clusters, vocab))
    cluster_of = np.arange(n_clients) % n_clusters
    out = np.zeros((n_clients, n_seqs, seq_len + 1), np.int32)
    for i in range(n_clients):
        t = tables[cluster_of[i]]
        x = rng.integers(0, vocab, size=n_seqs)
        seq = [x]
        for _ in range(seq_len):
            # vectorized categorical draw per sequence
            u = rng.random((n_seqs, 1))
            nxt = (t[seq[-1]].cumsum(1) > u).argmax(1)
            seq.append(nxt.astype(np.int64))
        out[i] = np.stack(seq, 1).astype(np.int32)
    return out, cluster_of
