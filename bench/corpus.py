"""A per-cluster bigram corpus over a vocabulary of any size, from the
seed.

Each cluster's language gives every token ``successors`` next tokens,
drawn from the vocabulary, with Dirichlet(``alpha``) probabilities; a
sequence starts at a uniform token and walks the chain. Clients of one
cluster share its language (client i is in cluster i mod n_clusters),
so the greedy has peers worth finding. The tables take V x successors
entries, where `bench.data`'s dense (V, V) Dirichlet table of the LM
example would take 2.5 GB at a vocabulary of 12,544.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .data import FederatedData


def bigram_tokens(seed: int, n_clients: int, vocab: int, seq_len: int,
                  n_seqs: int, n_clusters: int, successors: int,
                  alpha: float):
    """(N, n_seqs, seq_len + 1) int32 tokens and each client's cluster."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(n_clusters, vocab, successors))
    cum = rng.dirichlet([alpha] * successors,
                        size=(n_clusters, vocab)).cumsum(-1)
    cluster_of = np.arange(n_clients) % n_clusters
    out = np.zeros((n_clients, n_seqs, seq_len + 1), np.int32)
    for i in range(n_clients):
        c = cluster_of[i]
        tok = rng.integers(0, vocab, size=n_seqs)
        out[i, :, 0] = tok
        for t in range(1, seq_len + 1):
            u = rng.random((n_seqs, 1))
            slot = np.minimum((cum[c, tok] <= u).sum(1), successors - 1)
            tok = nxt[c, tok, slot]
            out[i, :, t] = tok
    return out, cluster_of


def bigram_federated_data(seed: int, n_clients: int, vocab: int,
                          seq_len: int, n_seqs: int, n_clusters: int,
                          split: Tuple[int, int], successors: int,
                          alpha: float) -> FederatedData:
    """The corpus as `FederatedData`: token rows as x split into train,
    validation and test at ``split``, zero labels (the loss reads the next
    token), uniform weights."""
    tokens, cluster_of = bigram_tokens(seed, n_clients, vocab, seq_len,
                                       n_seqs, n_clusters, successors, alpha)
    tr, va, te = np.split(tokens, list(split), axis=1)
    return FederatedData(
        train_x=tr, train_y=np.zeros(tr.shape[:2], np.int32),
        val_x=va, val_y=np.zeros(va.shape[:2], np.int32),
        test_x=te, test_y=np.zeros(te.shape[:2], np.int32),
        p=np.full(n_clients, 1.0 / n_clients), cluster=cluster_of,
        n_classes=vocab)
