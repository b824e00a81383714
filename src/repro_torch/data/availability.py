"""Per-round client availability processes (partial participation).

The paper assumes every client is present in every round; realistic
decentralized deployments do not (DisPFL's busiest-node analysis, directed
partial communication in Decentralized Directed Collaboration). This
module generates a seeded ``(rounds, N)`` bool participation schedule that
rides in ``RoundState.aux`` and drives the participation-aware round
engine (DESIGN.md §9): absent clients hold their params, the Eq.-4 mix is
restricted to available peers, the GGC refresh selects only among
available candidates, and comm counters count only realized downloads.

Three availability models, all sharing the contract that ``rate=1.0``
yields the all-ones schedule (so the participation-aware round_step is
bitwise-identical to the full-participation path — tested) and
``rate=0.0`` yields all-zeros:

  * ``bernoulli`` — i.i.d. per client per round.
  * ``markov``    — per-client 2-state (up/down) chain with stationary
    availability ``rate`` and mean down-spell ``mean_burst`` rounds
    (bursty outages: a client that just dropped tends to stay dropped).
  * ``cluster``   — per-round, whole clusters go down together
    (correlated outages: a pod, region or institution disappearing at
    once); each cluster is up i.i.d. with probability ``rate``.

Schedules are generated host-side with numpy (they are data, not traced
computation) and uploaded once into the round engine's aux pytree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

AVAILABILITY_MODELS = ("bernoulli", "markov", "cluster")


@dataclass(frozen=True)
class ParticipationConfig:
    """Availability process spec (frozen: hashable, so it can ride in the
    engine's compiled-step cache keys).

    rate:       stationary per-round availability probability in [0, 1].
    model:      one of AVAILABILITY_MODELS.
    seed:       schedule PRNG seed (independent of the training seed).
    mean_burst: markov only — mean consecutive-down spell in rounds.
    """
    rate: float = 1.0
    model: str = "bernoulli"
    seed: int = 0
    mean_burst: float = 3.0

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.model not in AVAILABILITY_MODELS:
            raise ValueError(f"model must be one of {AVAILABILITY_MODELS},"
                             f" got {self.model!r}")
        if self.mean_burst < 1.0:
            raise ValueError(f"mean_burst must be >= 1 round, got "
                             f"{self.mean_burst}")


def bernoulli_schedule(rng: np.random.Generator, rounds: int, n_clients: int,
                       rate: float) -> np.ndarray:
    """(rounds, N) bool — i.i.d. availability per client per round."""
    return rng.random((rounds, n_clients)) < rate


def markov_schedule(rng: np.random.Generator, rounds: int, n_clients: int,
                    rate: float, mean_burst: float = 3.0) -> np.ndarray:
    """(rounds, N) bool — per-client up/down Markov chain.

    The down->up transition probability is q = 1/mean_burst (geometric
    down-spells of mean ``mean_burst`` rounds); the up->down probability
    p = q (1 - rate) / rate makes ``rate`` the stationary up-probability
    (clamped to [0, 1] — for very small rates the chain saturates at
    p = 1 and the realized availability is q / (1 + q)). The initial
    state draws from the stationary distribution, so every round
    (including the first) has availability ``rate``.
    """
    if rate >= 1.0:
        return np.ones((rounds, n_clients), bool)
    if rate <= 0.0:
        return np.zeros((rounds, n_clients), bool)
    q = min(1.0, 1.0 / float(mean_burst))          # down -> up
    p = min(1.0, q * (1.0 - rate) / rate)          # up -> down
    out = np.zeros((rounds, n_clients), bool)
    state = rng.random(n_clients) < rate
    for t in range(rounds):
        out[t] = state
        u = rng.random(n_clients)
        state = np.where(state, u >= p, u < q)
    return out


def cluster_outage_schedule(rng: np.random.Generator, rounds: int,
                            cluster: np.ndarray, rate: float) -> np.ndarray:
    """(rounds, N) bool — whole clusters drop together: each cluster is up
    i.i.d. with probability ``rate`` per round and every member inherits
    its cluster's state (within-cluster availability correlation = 1)."""
    cluster = np.asarray(cluster)
    _, inv = np.unique(cluster, return_inverse=True)
    n_clusters = int(inv.max()) + 1 if cluster.size else 0
    up = rng.random((rounds, n_clusters)) < rate
    return up[:, inv]


def schedule_for_data(cfg: ParticipationConfig, rounds: int,
                      data) -> np.ndarray:
    """`participation_schedule` for a `FederatedData`-like container: one
    place that knows which of its fields the models need (the cluster
    assignment, for cluster-correlated outages) — shared by the DPFL
    engine, the host reference loop, and the baselines' round loop."""
    return participation_schedule(
        cfg, rounds, data.n_clients,
        cluster=getattr(data, "cluster", None))


def participation_schedule(cfg: ParticipationConfig, rounds: int,
                           n_clients: int,
                           cluster: Optional[np.ndarray] = None
                           ) -> np.ndarray:
    """Generate the seeded (rounds, N) bool schedule for ``cfg``."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.model == "bernoulli":
        return bernoulli_schedule(rng, rounds, n_clients, cfg.rate)
    if cfg.model == "markov":
        return markov_schedule(rng, rounds, n_clients, cfg.rate,
                               cfg.mean_burst)
    if cfg.model == "cluster":
        if cluster is None:
            raise ValueError("cluster availability model needs the (N,) "
                             "cluster assignment (FederatedData.cluster)")
        if len(np.asarray(cluster)) != n_clients:
            raise ValueError(
                f"cluster assignment has {len(np.asarray(cluster))} "
                f"entries for {n_clients} clients")
        return cluster_outage_schedule(rng, rounds, cluster, cfg.rate)
    raise ValueError(cfg.model)
