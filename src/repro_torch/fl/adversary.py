"""Adversarial-client attack models for the DPFL round engine (port of
`repro.fl.adversary`).

A frozen, hashable `AdversaryConfig` and seeded host-side generators
(numpy, copied from `repro`) build the malicious set and the per-round
attack schedule once, up front, as a (rounds, N) bool array that rides
in ``RoundState.aux["adv"]``; a round only indexes ``sched[t]``.

Attacks:

* ``label_flip``: data-level; malicious clients train on labels sent
  through a seeded derangement of the classes (train time only, so val
  and test stay clean).
* ``grad_scale``: the shared update ``flat - prev`` is scaled by
  ``scale``.
* ``sign_flip``: the shared update is negated.
* ``free_rider``: uploads its round-start params plus optional seeded
  noise; its local training is discarded.

``grad_scale``, ``sign_flip`` and ``free_rider`` rewrite the attacker's
own row of the (N, P) panel in the round engine's ``post_train`` hook,
after the participation hold and before the exchange, so every mix path
sees the poisoned row. ``free_rider`` also swaps its noisy payload into
the peer-visible wire table (`wire_view`) while its own self term stays
exact. Every select is a ``torch.where`` on the schedule row: with
``fraction=0.0`` each mask is all-False and a run equals the
adversary-free one bit for bit. Under a client mesh the schedule and the
malicious set stay whole on every rank, and a rank applies its rows of
them to its rows of the panel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import prng

__all__ = ["ATTACKS", "AdversaryConfig", "n_malicious", "malicious_mask",
           "attack_schedule", "label_permutation", "adv_base_key",
           "edge_rates", "segregation_history", "poison_update",
           "wire_view", "free_rider_active", "make_post_train",
           "make_adv_local_train"]

ATTACKS = ("label_flip", "grad_scale", "sign_flip", "free_rider")


@dataclass(frozen=True)
class AdversaryConfig:
    """Which clients attack, how, and when.

    Frozen and hashable, like `ParticipationConfig` and
    `CompressionConfig`.

    attack      : one of `ATTACKS`.
    fraction    : fraction of clients that are malicious; the malicious
                  set has EXACTLY ``round(fraction * N)`` members
                  (seeded, disjoint from benign by construction).
    seed        : seeds the malicious set, the per-round activity draws,
                  the label derangement, and the free-rider noise —
                  independent of the data / training / graph streams.
    scale       : ``grad_scale`` multiplier on the shared update.
    noise_scale : std of the Gaussian payload a free rider adds to its
                  stale upload (0.0 = pure stale upload).
    round_prob  : probability a malicious client attacks in a given
                  round (1.0 = every round; the malicious SET is fixed,
                  only its activity is Bernoulli per round).
    """
    attack: str = "label_flip"
    fraction: float = 0.0
    seed: int = 0
    scale: float = 5.0
    noise_scale: float = 1.0
    round_prob: float = 1.0

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(f"attack must be one of {ATTACKS}, "
                             f"got {self.attack!r}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], "
                             f"got {self.fraction}")
        if not 0.0 <= self.round_prob <= 1.0:
            raise ValueError(f"round_prob must be in [0, 1], "
                             f"got {self.round_prob}")
        if self.scale <= 0.0:
            raise ValueError(f"scale must be > 0, got {self.scale}")
        if self.noise_scale < 0.0:
            raise ValueError(f"noise_scale must be >= 0, "
                             f"got {self.noise_scale}")


# --------------------------------------------------------- host schedules
def n_malicious(cfg: AdversaryConfig, n_clients: int) -> int:
    """Exact malicious head-count: ``round(fraction * N)``."""
    return int(round(cfg.fraction * n_clients))


def malicious_mask(cfg: AdversaryConfig, n_clients: int) -> np.ndarray:
    """(N,) bool — the seeded malicious set. Deterministic in
    ``(cfg.seed, n_clients)``; exactly `n_malicious` True entries."""
    mask = np.zeros(n_clients, dtype=bool)
    m = n_malicious(cfg, n_clients)
    if m:
        rng = np.random.default_rng([cfg.seed, 0])
        mask[rng.choice(n_clients, size=m, replace=False)] = True
    return mask


def attack_schedule(cfg: AdversaryConfig, rounds: int,
                    n_clients: int) -> np.ndarray:
    """(rounds, N) bool — ``sched[t, k]`` ⇔ client k attacks in round t.

    Row support is always a subset of `malicious_mask`; with
    ``round_prob >= 1`` every row IS the mask. Activity draws come from
    an independent seeded stream so the malicious set itself does not
    move with ``round_prob``."""
    mask = malicious_mask(cfg, n_clients)
    if cfg.round_prob >= 1.0:
        return np.tile(mask, (rounds, 1))
    rng = np.random.default_rng([cfg.seed, 1])
    act = rng.random((rounds, n_clients)) < cfg.round_prob
    return act & mask[None, :]


def label_permutation(cfg: AdversaryConfig, n_classes: int) -> np.ndarray:
    """(n_classes,) int — seeded derangement (no fixed points), the
    ``label_flip`` map. Same construction as
    `repro.data.synthetic.make_label_flip_data`."""
    if n_classes < 2:
        raise ValueError("label_flip needs n_classes >= 2")
    rng = np.random.default_rng([cfg.seed, 2])
    perm = rng.permutation(n_classes)
    while np.any(perm == np.arange(n_classes)):
        perm = rng.permutation(n_classes)
    return perm


def adv_base_key(seed: int, device=None) -> torch.Tensor:
    """Base PRNG key of the in-round adversary randomness (free-rider
    noise): ``fold_in(PRNGKey(seed), 1013)``, a stream apart from the
    graph (1000 + t) and codec (977) streams."""
    return prng.fold_in(prng.PRNGKey(seed, device=device), 1013)


# ----------------------------------------------------- segregation metrics
def edge_rates(adj, malicious):
    """Fig.-4 graph-segregation metrics of one adjacency snapshot.

    Returns ``(benign_to_malicious, benign_to_benign)``: the mean edge
    rate from benign rows into malicious columns, and the off-diagonal
    edge rate within the benign block. GGC isolating attackers shows as
    the first rate falling over rounds while the second stays up.
    Zero-division-safe: an empty benign or malicious set yields 0.0."""
    a = np.asarray(adj, dtype=np.float64)
    mal = np.asarray(malicious, dtype=bool)
    ben = ~mal
    nb, nm = int(ben.sum()), int(mal.sum())
    cross = float(a[np.ix_(ben, mal)].mean()) if nb and nm else 0.0
    within = (float((a[np.ix_(ben, ben)].sum() - nb) / (nb * (nb - 1)))
              if nb > 1 else 0.0)
    return cross, within


def segregation_history(graph_history, malicious):
    """`edge_rates` over a per-round adjacency history. Returns
    ``{"benign_to_malicious": [...], "benign_to_benign": [...]}``."""
    cross, within = [], []
    for adj in graph_history:
        c, w = edge_rates(adj, malicious)
        cross.append(c)
        within.append(w)
    return {"benign_to_malicious": cross, "benign_to_benign": within}


# ------------------------------------------------------- in-round attacks
def poison_update(cfg: AdversaryConfig, flat, prev, row):
    """Model poisoning: rows of ``flat`` where ``row`` (this round's (N,)
    attack mask) is True become the poisoned update relative to ``prev``
    (the round-start panel). Benign rows pass through bit for bit; an
    all-False row is the identity."""
    upd = flat - prev
    if cfg.attack == "grad_scale":
        poisoned = prev + float(np.float32(cfg.scale)) * upd
    elif cfg.attack == "sign_flip":
        poisoned = prev - upd
    elif cfg.attack == "free_rider":
        poisoned = prev          # training discarded: the stale row
    else:
        return flat              # label_flip poisons data, not the update
    return torch.where(row[:, None], poisoned, flat)


def free_rider_active(cfg: Optional[AdversaryConfig]) -> bool:
    """True iff the free-rider wire swap runs at all: with ``fraction=0.0``
    the mix keeps the adversary-free call."""
    return (cfg is not None and cfg.attack == "free_rider"
            and cfg.fraction > 0.0)


def wire_view(cfg: AdversaryConfig, flat, row, key, t: int,
              row0: int = 0):
    """The peer-visible (N, P) table of round ``t``: free riders upload
    their stale row (already reverted by `poison_update`) plus
    ``noise_scale`` times ``prng.normal(fold_in(key, t))``; everyone else
    uploads ``flat``. ``prng.normal`` may differ from
    ``jax.random.normal`` by a few ulps (its erfinv); at ``noise_scale=0``
    the table is ``flat``'s bits. ``flat`` and ``row`` may be the rows
    from ``row0``, which draw their rows of the noise."""
    n, P = flat.shape
    noise = float(np.float32(cfg.noise_scale)) * prng.normal(
        prng.fold_in(key, t), (row0 + n, P), rows=(row0, row0 + n))
    return torch.where(row[:, None], flat + noise, flat)


def make_post_train(cfg: AdversaryConfig, rows: slice = slice(None)):
    """The round engine's ``post_train`` hook (after the participation
    hold, before the exchange) on the panel's ``rows`` of the schedule;
    None for ``label_flip``, which rides the local-train hook."""
    if cfg.attack == "label_flip":
        return None

    def post_train(flat, prev, aux, t):
        return poison_update(cfg, flat, prev,
                             aux["adv"]["sched"][t][rows])

    return post_train


def make_adv_local_train(engine, cfg: AdversaryConfig):
    """``label_flip``'s local train: in a round where they attack,
    malicious clients' labels go through the seeded derangement; an
    all-False row trains on exactly the clean labels. None for the
    model-poisoning attacks (`make_post_train`)."""
    if cfg.attack != "label_flip":
        return None
    train_y = engine.train_data[1]
    perm = torch.as_tensor(label_permutation(cfg, engine.data.n_classes),
                           device=train_y.device)
    flip_y = perm[train_y]

    def local_train(stacked, key, epochs, *, aux, t):
        row = aux["adv"]["sched"][t][engine.rows]
        ys = torch.where(row[:, None], flip_y, train_y)
        return engine.local_train_with_labels(stacked, key, epochs, ys)

    return local_train
