"""Heterogeneous federated partitioners (paper §4.1 / App. F.2).

Two families, matching the paper:
  * Dirichlet: for each class c draw q_c ~ Dir_N(alpha) and give client i a
    fraction q_{c,i} of class-c samples. [Yurochkin et al.; Wang et al.]
  * Pathological: each client holds exactly ``classes_per_client`` classes.
    [McMahan et al.]

Provided both as proportion generators (for the synthetic generative
pipeline) and as finite-pool index partitioners (property-tested: disjoint
cover of the pool).
"""
from __future__ import annotations

import numpy as np


def dirichlet_proportions(rng: np.random.Generator, n_clients: int,
                          n_classes: int, alpha: float) -> np.ndarray:
    """(n_classes, n_clients): per-class client shares, rows sum to 1."""
    return rng.dirichlet([alpha] * n_clients, size=n_classes)


def pathological_assignment(rng: np.random.Generator, n_clients: int,
                            n_classes: int, classes_per_client: int
                            ) -> np.ndarray:
    """(n_clients, n_classes) bool: exactly classes_per_client True per row,
    with every class covered when possible (round-robin base).

    Raises ValueError when ``classes_per_client`` is not in
    [1, n_classes] — a client cannot hold more distinct classes than
    exist (the dedup-and-refill loop below would otherwise never
    terminate) — or when the client/class counts are not positive.
    """
    k = classes_per_client
    if n_clients < 1 or n_classes < 1:
        raise ValueError(f"need n_clients >= 1 and n_classes >= 1, got "
                         f"n_clients={n_clients}, n_classes={n_classes}")
    if not 1 <= k <= n_classes:
        raise ValueError(
            f"classes_per_client={k} must be in [1, n_classes={n_classes}]"
            f": a client holds distinct classes")
    assign = np.zeros((n_clients, n_classes), dtype=bool)
    # round-robin shards so all classes get used, like the McMahan split
    shards = []
    while len(shards) < n_clients * k:
        order = rng.permutation(n_classes)
        shards.extend(order.tolist())
    shards = np.array(shards[: n_clients * k]).reshape(n_clients, k)
    for i in range(n_clients):
        # ensure k distinct classes for client i
        cls = list(dict.fromkeys(shards[i].tolist()))
        while len(cls) < k:
            c = int(rng.integers(n_classes))
            if c not in cls:
                cls.append(c)
        assign[i, cls] = True
    return assign


def partition_pool_dirichlet(rng: np.random.Generator, labels: np.ndarray,
                             n_clients: int, alpha: float):
    """Split indices of a finite pool by the Dirichlet scheme.
    Returns list of index arrays (disjoint cover)."""
    n_classes = int(labels.max()) + 1
    props = dirichlet_proportions(rng, n_clients, n_classes, alpha)
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        # proportional cut points
        cuts = (np.cumsum(props[c])[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            out[i].append(part)
    return [np.concatenate(p) if p else np.array([], int) for p in out]


def partition_pool_pathological(rng: np.random.Generator, labels: np.ndarray,
                                n_clients: int, classes_per_client: int):
    """Finite-pool pathological split; returns list of index arrays."""
    n_classes = int(labels.max()) + 1
    assign = pathological_assignment(rng, n_clients, n_classes,
                                     classes_per_client)
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        holders = np.flatnonzero(assign[:, c])
        if len(holders) == 0:
            holders = np.array([int(rng.integers(n_clients))])
        for i, part in enumerate(np.array_split(idx, len(holders))):
            out[holders[i]].append(part)
    return [np.concatenate(p) if p else np.array([], int) for p in out]
