"""DPFL — Algorithm 1 (Decentralized Personalized Federated Learning),
port of `repro.core.dpfl`: dense (N, N) or sparse (N, B) neighbor-list
graphs, the Fig.-3 random graph, the codecs of `fl.compress`, partial
participation, adversarial clients and the robust mix rules of
`fl.robust`, on one device or on a client mesh.

Preprocess: same-init local models, tau_init local epochs, BGGC (or the
random graph) builds the budgeted candidate graph Omega, one Eq.-4 mix
over Omega. Training loop: tau_train local epochs, GGC re-selects C_k
within Omega_k (every ``refresh_period`` rounds), weighted aggregation
over C_k ∪ {k} (Eq. 4). Best-on-validation models are kept per client
and give the final test accuracy (paper §4.1).

With a lossy codec, peers exchange C(x + e): the GGC refresh probes the
decoded peers, the off-diagonal Eq.-4 terms mix the decoded payloads
(top-k through the compressed_graph_mix kernel) while the self term
stays exact, and the error-feedback residuals ride in ``aux["ef"]``.
Preprocessing exchanges raw fp32 models and is charged 4P per download.

With ``participation``, a seeded (rounds, N) availability schedule rides
in ``aux["part"]``: absent clients hold their params, keep their C_k and
their residuals, the Eq.-4 weights are restricted to available peers and
the counters count realized downloads only. With ``adversary``, a seeded
(rounds, N) attack schedule rides in ``aux["adv"]``: label flipping
through the local-train hook, model poisoning through the post-train
hook, and free riders' uploads through the wire table that peers see
(probes, codec input and off-diagonal mix) while every self term reads
the exact local row. ``mix_rule`` picks the weighted (Eq. 4), trimmed
or clipped aggregation. Preprocessing sees every client and no attack.

`run_dpfl` runs the rounds on the device-resident round engine
(`repro_torch.fl.round_engine`): comm counters and histories stay on the
device and leave it once, at the end (or every ``history_every``
rounds). `run_dpfl_reference` is the host-driven loop, kept as the
engine's equivalence oracle. Both derive every key as `repro` does, so
on the same init they make the same random choices.

On an engine sharded over a client mesh (`FLEngine.shard_clients`, one
process per shard) `run_dpfl` runs on each rank's rows of every client
table: the graphs, Omega, the residuals, the histories and the
counters. Local training and evaluation stay on the shard; three things
cross ranks, as in `repro` (DESIGN.md §8): the Eq.-4 mix, the GGC/BGGC
refresh and the compressed exchange. The availability and attack
schedules and the malicious set stay whole on every rank. Each rank
counts its own clients' downloads, integers summed over the shards at
the end, so the counters are the single-device counters; the histories
are gathered at each flush and the results at the end, never per round.
Every rank returns the same whole `DPFLResult`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import obs as _obs
from .. import prng
from ..analysis.registry import exchange_site
from ..data.availability import ParticipationConfig, schedule_for_data
from ..fl import adversary as _adversary
from ..fl import compress as _compress
from ..fl import robust as _robust
from ..fl.adversary import AdversaryConfig
from ..fl.engine import FLEngine
from ..fl.robust import MIX_RULES
from ..fl.round_engine import init_round_state, make_round_step, run_rounds
from ..kernels import ops as _kops
from ..sharding import collectives as _coll
from ..sharding.rows import eye_rows
from .graph import (all_clients_bggc, all_clients_bggc_sparse,
                    all_clients_graph, all_clients_graph_sparse,
                    count_neighbor_downloads, eq4_weights_unnormalized,
                    mix_flat, mix_flat_sparse, mixing_matrix,
                    sparse_eq4_unnormalized, sparse_mixing_weights)


@dataclass
class DPFLConfig:
    rounds: int = 20
    tau_init: int = 10
    tau_train: int = 5
    budget: Optional[int] = None      # B_c; None = inf (no constraint)
    refresh_period: int = 1           # P: run GGC every P rounds (Table 3)
    seed: int = 0
    graph_impl: str = "ggc"           # ggc | naive (oracle)
    random_graph: bool = False        # Fig. 3 ablation: random C_k
    track_history: bool = True
    history_every: int = 0            # pull histories off the device every
    #                                   K rounds (0 = once at the end); also
    #                                   bounds the device history buffers
    graph_repr: str = "dense"         # dense | sparse: (N, B) int32
    #                                   neighbor lists in place of (N, N)
    #                                   masks; needs graph_impl="ggc"
    compression: Optional[_compress.CompressionConfig] = None
    # the peer-exchange codec; None and "identity" run the same code
    participation: Optional[ParticipationConfig] = None
    # partial participation; None = every client in every round (a
    # rate=1.0 schedule gives the same bits)
    adversary: Optional[AdversaryConfig] = None
    # adversarial clients; None (and fraction=0.0) = no attack, bit for bit
    mix_rule: str = "weighted"        # weighted (Eq. 4) | trimmed | clipped
    trim_frac: float = 0.2            # trimmed: fraction cut from each tail
    clip_mult: float = 1.0            # clipped: tau = clip_mult x own update


@dataclass
class DPFLResult:
    test_acc: np.ndarray              # (N,) per-client acc of best-val model
    val_acc_history: list = field(default_factory=list)
    graph_history: list = field(default_factory=list)   # (N, N) adjacency
    #                                                     per round, both
    #                                                     representations
    omega: Optional[np.ndarray] = None                  # (N, N) adjacency
    best_flat: Optional[np.ndarray] = None  # (N, P) best-val client models
    # communication accounting in models downloaded (the paper's cost
    # unit): preprocessing BGGC = 2(N-1) per client (Algorithm 3 streams
    # every peer in both phases), the random graph only its `budget`
    # sampled peers, once; each training round = |Omega_k| when GGC
    # refreshes (it needs all candidates), else |C_k| (aggregation only)
    comm_downloads: list = field(default_factory=list)  # per-round totals
    comm_preprocess: int = 0
    # bytes = downloads x the codec's static wire size per model
    # (`fl.compress.bytes_per_model`); preprocessing moved raw fp32
    # models and is charged 4P each
    comm_bytes: list = field(default_factory=list)      # per-round totals
    comm_bytes_preprocess: int = 0
    participation: Optional[np.ndarray] = None  # (rounds, N) realized
    #                                             schedule, if enabled
    malicious: Optional[np.ndarray] = None      # (N,) bool malicious set,
    #                                             if an adversary ran


# (DPFLConfig field, its default, the ROADMAP item that ports it) for each
# setting the port does not run yet: anything but the default raises
# NotImplementedError naming the item. Every setting is ported.
_NOT_PORTED: tuple = ()

# the config classes of the fields that take one: the port's own
_CONFIG_TYPES = (("compression", _compress.CompressionConfig),
                 ("participation", ParticipationConfig),
                 ("adversary", AdversaryConfig))


def _check_ported(cfg: DPFLConfig):
    """Raise NotImplementedError for a setting the port does not run yet,
    naming the ROADMAP item that ports it; TypeError for a config object
    not of the port's class; ValueError for a setting `repro` refuses
    too."""
    for name, default, item in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"DPFLConfig.{name}={getattr(cfg, name)!r} is not ported to "
                f"repro_torch yet (ROADMAP.md {item})")
    if cfg.graph_impl not in ("ggc", "naive"):
        raise NotImplementedError(
            f"DPFLConfig.graph_impl={cfg.graph_impl!r}: the port has "
            f"'ggc' and 'naive'")
    for name, cls in _CONFIG_TYPES:
        value = getattr(cfg, name)
        if value is not None and not isinstance(value, cls):
            raise TypeError(f"DPFLConfig.{name} must be a "
                            f"{cls.__module__}.{cls.__name__} or None, "
                            f"got {value!r}")
    _mix_rule(cfg)
    _sparse(cfg)


def _mix_rule(cfg: DPFLConfig) -> str:
    """The validated Eq.-4 aggregation rule."""
    if cfg.mix_rule not in MIX_RULES:
        raise ValueError(f"mix_rule must be one of {MIX_RULES}, "
                         f"got {cfg.mix_rule!r}")
    if cfg.mix_rule == "trimmed" and not 0.0 <= cfg.trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), "
                         f"got {cfg.trim_frac}")
    if cfg.mix_rule == "clipped" and cfg.clip_mult <= 0.0:
        raise ValueError(f"clip_mult must be > 0, got {cfg.clip_mult}")
    return cfg.mix_rule


def _sparse(cfg: DPFLConfig) -> bool:
    """True for the neighbor-list representation; also validates the
    combination: the literal-oracle graph_impl="naive" only exists dense,
    and the Fig.-3 random graph is representation-agnostic."""
    if cfg.graph_repr not in ("dense", "sparse"):
        raise ValueError(f"graph_repr must be 'dense' or 'sparse', "
                         f"got {cfg.graph_repr!r}")
    if cfg.graph_repr == "sparse" and cfg.graph_impl != "ggc" \
            and not cfg.random_graph:
        raise ValueError("graph_repr='sparse' supports graph_impl='ggc' "
                         "only (the naive oracle is dense-only)")
    return cfg.graph_repr == "sparse"


def _nbr_width(N: int, budget: int) -> int:
    """Slot count B of the (N, B) neighbor lists: a client selects at
    most min(budget, N-1) off-diagonal peers."""
    return max(1, min(budget, N - 1))


def _nbr_to_adj_np(idx: np.ndarray, n: int) -> np.ndarray:
    """Host-side (N, B) neighbor lists -> (N, n) bool adjacency (diagonal
    True), for the results of sparse runs."""
    idx = np.asarray(idx)
    adj = np.zeros((idx.shape[0], n), bool)
    rows, cols = np.nonzero(idx >= 0)
    adj[rows, idx[rows, cols]] = True
    adj |= np.eye(idx.shape[0], n, dtype=bool)
    return adj


def _sparsity(adj: np.ndarray) -> float:
    n = adj.shape[0]
    off = adj.sum() - np.trace(adj)
    return 1.0 - off / (n * (n - 1))


def _symmetry(adj: np.ndarray) -> float:
    a = adj.copy().astype(bool)
    np.fill_diagonal(a, False)
    denom = a.sum()
    return float((a & a.T).sum() / denom) if denom else 1.0


def _comm_preprocess(cfg: DPFLConfig, N: int, budget: int) -> int:
    """Models downloaded during preprocessing. BGGC (Algorithm 3) streams
    every peer in both communication phases: once to accumulate the
    shrink-set sum w^Y, once more for the batched greedy decisions (a
    client never holds more than B_c models, so it cannot replay stored
    batches). That is 2(N-1) downloads per client. The Fig.-3 random
    graph downloads only the `budget` sampled peers of each client,
    once."""
    if cfg.random_graph:
        return N * min(budget, N - 1)
    return 2 * N * (N - 1)


def _fill_comm_bytes(result: DPFLResult, cfg: DPFLConfig, n_params: int):
    """Download counts -> bytes, shared by the engine and the reference:
    a training-round download moves one codec-encoded model, a
    preprocessing download one raw fp32 model."""
    bpm = _compress.bytes_per_model(cfg.compression, n_params)
    result.comm_bytes = [int(d) * bpm for d in result.comm_downloads]
    result.comm_bytes_preprocess = result.comm_preprocess * 4 * n_params


def _comp_base_key(seed: int, device) -> torch.Tensor:
    """Base key of the codec's stochastic-rounding stream (round t folds
    in t): branched off the run seed on a constant the preprocessing
    split never touches, so a codec changes no other PRNG stream."""
    return prng.fold_in(prng.PRNGKey(seed, device=device), 977)


def _budget(cfg: DPFLConfig, N: int) -> int:
    return cfg.budget if cfg.budget is not None else N - 1


def _random_graph(cfg: DPFLConfig, N: int, budget: int, sparse: bool,
                  device) -> torch.Tensor:
    """The Fig.-3 ablation's Omega: ``min(budget, N-1)`` peers per client
    drawn by ``numpy.random.default_rng(seed).choice``, as `repro` draws
    them; the same peer sets in both representations."""
    rng = np.random.default_rng(cfg.seed)
    omega = np.zeros((N, N), bool)
    nbr = np.full((N, _nbr_width(N, budget)), -1, np.int32)
    for k in range(N):
        others = np.setdiff1d(np.arange(N), [k])
        sel = rng.choice(others, size=min(budget, N - 1), replace=False)
        omega[k, sel] = True
        omega[k, k] = True
        nbr[k, :len(sel)] = np.sort(sel)
    return torch.from_numpy(nbr if sparse else omega).to(device)


def _preprocess(engine: FLEngine, cfg: DPFLConfig, reward_fn, budget: int):
    """Alg. 1 lines 1-5: same-init clients, tau_init local epochs, BGGC
    (or random) candidate graph Omega, one Eq.-4 mix over Omega. Shared by
    the engine and the reference loops, so both start from the same
    (omega, flat). Omega is (N, N) bool, or (N, B) int32 lists when
    sparse: the engine's rows of it, as of ``flat``."""
    N = engine.data.n_clients
    p = engine.p
    mesh, ca, row0 = engine.mesh, engine.client_axes, engine.rows.start
    key = prng.PRNGKey(cfg.seed, device=engine.device)
    k_init, k_pre, k_graph, k_train = prng.split(key, 4)

    stacked = engine.init_clients(k_init)
    stacked, _ = engine.local_train(stacked, k_pre, epochs=cfg.tau_init)
    flat = engine.flatten(stacked)
    del stacked
    sparse = _sparse(cfg)
    chunk = engine._client_chunk
    if cfg.random_graph:
        omega = _random_graph(cfg, N, budget, sparse,
                              engine.device)[engine.rows].contiguous()
    elif sparse:
        omega = all_clients_bggc_sparse(k_graph, flat, p, reward_fn, budget,
                                        mesh=mesh, client_axes=ca,
                                        client_chunk=chunk)
    else:
        cand = torch.ones((engine.n_local, N), dtype=torch.bool,
                          device=engine.device)
        omega = all_clients_bggc(k_graph, flat, p, cand, reward_fn, budget,
                                 mesh=mesh, client_axes=ca,
                                 client_chunk=chunk)
    if sparse:
        self_w, nbr_w = sparse_mixing_weights(omega, p, row0=row0)
        flat = mix_flat_sparse(self_w, nbr_w, omega, flat, mesh=mesh,
                               client_axes=ca)
    else:
        flat = mix_flat(mixing_matrix(omega, p, row0=row0), flat,
                        mesh=mesh, client_axes=ca)
    return omega, flat, k_graph, k_train


def _omega_np(omega: torch.Tensor, N: int, sparse: bool) -> np.ndarray:
    """Omega as the (N, N) bool adjacency the results report."""
    om = omega.cpu().numpy()
    return _nbr_to_adj_np(om, N) if sparse else om


def _round_aux(engine: FLEngine, cfg: DPFLConfig, flat, result):
    """The round-loop state both loops share: the codec's key and
    residuals, the availability schedule (``part``) and the attack
    schedule with its key (``adv``). Fills ``result.participation`` and
    ``result.malicious``."""
    dev = engine.device
    N = engine.data.n_clients
    aux = {}
    comp = _compress.normalize(cfg.compression)
    if comp is not None:
        aux["k_comp"] = _comp_base_key(cfg.seed, dev)
        if _compress.uses_ef(comp):
            aux["ef"] = torch.zeros_like(flat)
    if cfg.participation is not None:
        sched = schedule_for_data(cfg.participation, cfg.rounds, engine.data)
        aux["part"] = torch.from_numpy(sched).to(dev)
        result.participation = sched
    if cfg.adversary is not None:
        aux["adv"] = {
            "sched": torch.from_numpy(_adversary.attack_schedule(
                cfg.adversary, cfg.rounds, N)).to(dev),
            "key": _adversary.adv_base_key(cfg.adversary.seed, dev)}
        result.malicious = _adversary.malicious_mask(cfg.adversary, N)
    return aux


def _wire(cfg: DPFLConfig, flat, aux, t, rows: slice):
    """The peer-visible upload table of round t: ``flat`` (the ``rows``
    of the clients) with the active free riders' stale, noisy uploads in
    their rows."""
    if not _adversary.free_rider_active(cfg.adversary):
        return flat
    return _adversary.wire_view(cfg.adversary, flat,
                                aux["adv"]["sched"][t][rows],
                                aux["adv"]["key"], t, row0=rows.start)


def _exchange(comp, wire, aux, t, active, mesh=None, client_axes=None):
    """The transmit side of round t under codec ``comp`` (None: no codec):
    ``(recv, payload, new_ef)``, the table peers receive (what the GGC
    refresh probes and the off-diagonal mix reads: the decoded payloads,
    or the wire table itself), the wire payload and the new residuals
    (an absent client transmits nothing, so its residual holds).
    ``active`` is the availability of ``wire``'s rows."""
    if comp is None:
        return wire, None, None
    with _obs.span("codec"):
        payload, dec, new_ef = _compress.compress_exchange(
            comp, wire, aux.get("ef"), prng.fold_in(aux["k_comp"], t),
            mesh=mesh, client_axes=client_axes)
    if new_ef is not None and active is not None:
        new_ef = torch.where(active[:, None], new_ef, aux["ef"])
    return dec, payload, new_ef


def _realized_downloads(adj, active, row0: int = 0):
    """Downloads of one round over (N, N) graph ``adj`` (or its row block
    from row ``row0``): an available client downloads its available peers
    (never itself). Without a mask, ``sum(adj) - N``, the same integer as
    an all-ones mask gives."""
    m, n = adj.shape
    if active is None:
        return adj.sum() - m
    off = adj & ~eye_rows(m, n, row0, adj.device)
    return (off & active[row0:row0 + m, None] & active[None, :]).sum()


def _make_mix(cfg: DPFLConfig, p, sparse: bool, mesh=None,
              client_axes=None, row0: int = 0):
    """The Eq.-4 mix of one round under ``cfg``'s codec, rule and
    adversary: ``mix(g, flat, recv, payload, prev, active)`` with ``g``
    the round's (N, N) graph or (N, B) lists, ``recv`` the table peers
    receive and ``prev`` the round-start panel (the clipped rule's
    reference point). The self term always reads ``flat``. Under
    ``mesh`` every table is the rank's rows (from ``row0``) and
    ``active`` whole: the dense robust rules read the all-gathered
    ``recv``, the neighbor-list ones its rotated rows
    (`kernels.ops.sparse_peer_rows`)."""
    comp = _compress.normalize(cfg.compression)
    fr = _adversary.free_rider_active(cfg.adversary)
    rule = _mix_rule(cfg)
    kw = dict(mesh=mesh, client_axes=client_axes)

    def whole(recv):
        return recv if mesh is None else \
            _coll.all_gather_rows(recv, mesh, client_axes)

    def peer_rows(nbr, recv):
        if mesh is None:
            return recv[nbr.clamp(0, recv.shape[0] - 1).long()]
        return _kops.sparse_peer_rows(nbr, recv, **kw)

    def mix_dense(adj, flat, recv, payload, prev, active):
        if rule == "trimmed":
            w = eq4_weights_unnormalized(adj, p, active=active, row0=row0)
            return _robust.trimmed_mix_dense(w, flat, whole(recv),
                                             cfg.trim_frac, row0)
        A = mixing_matrix(adj, p, active=active, row0=row0)
        if rule == "clipped":
            A = _robust.clipped_matrix(A, _robust.clip_factors(
                whole(recv), flat, prev, cfg.clip_mult), row0)
        if comp is not None:
            return _compress.mix_compressed(comp, A, flat, payload, recv,
                                            **kw)
        if fr:
            # peers mix the wire table, the self term the exact local row
            m, n = A.shape
            diag = A.gather(1, torch.arange(row0, row0 + m,
                                            device=A.device)[:, None])
            off = A * (1.0 - eye_rows(m, n, row0, A.device).to(A.dtype))
            return mix_flat(off, recv, **kw) + diag * flat
        return mix_flat(A, flat, **kw)

    def mix_sparse(nbr, flat, recv, payload, prev, active):
        if rule == "trimmed":
            p_un, w_un = sparse_eq4_unnormalized(nbr, p, active=active,
                                                 row0=row0)
            return _robust.trimmed_mix_sparse(
                p_un, w_un, nbr, flat, recv, cfg.trim_frac,
                nbr_rows=None if mesh is None else peer_rows(nbr, recv))
        self_w, nbr_w = sparse_mixing_weights(nbr, p, active=active,
                                              row0=row0)
        if rule == "clipped":
            gamma = _robust.clip_factors_sparse(peer_rows(nbr, recv), flat,
                                                prev, cfg.clip_mult)
            self_w, nbr_w = _robust.clipped_sparse_weights(self_w, nbr_w,
                                                           gamma)
        if comp is not None:
            return _compress.sparse_mix_compressed(comp, self_w, nbr_w, nbr,
                                                   flat, payload, recv, **kw)
        return mix_flat_sparse(self_w, nbr_w, nbr, flat, peers=recv, **kw)

    return mix_sparse if sparse else mix_dense


def _make_dpfl_aggregate(engine: FLEngine, cfg: DPFLConfig, reward_fn,
                         budget: int, hist_len: int):
    """The communication step of one DPFL round, dense (N, N) graphs:
    the codec exchange of the wire table, the GGC refresh inside Omega
    every ``cfg.refresh_period`` rounds (Alg. 1 line 9; never for the
    random graph) among the available candidates, the Eq.-4 mix under
    ``cfg.mix_rule`` and the comm-download counter. Omega, the current
    graph, the keys, the schedules, the residuals and the counters are
    read from ``aux``; the counters and the graph history are written in
    place. Under a client mesh every graph and table is the rank's rows
    and the counter its clients' downloads."""
    p = engine.p
    comp = _compress.normalize(cfg.compression)
    part = cfg.participation is not None
    mesh, ca, rows = engine.mesh, engine.client_axes, engine.rows
    mix = _make_mix(cfg, p, False, mesh, ca, rows.start)

    # bare @exchange_site: this aggregate charges its own downloads, the
    # aux["comm"] counter below
    @exchange_site
    def aggregate(flat, aux, t, prev):
        adj, omega = aux["adj"], aux["omega"]
        active = aux["part"][t] if part else None
        mine = None if active is None else active[rows]
        recv, payload, new_ef = _exchange(
            comp, _wire(cfg, flat, aux, t, rows), aux, t, mine, mesh, ca)
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        # line 9 needs all of Omega_k; aggregation-only rounds download
        # the currently selected C_k (the random graph: Omega itself);
        # only available downloader/peer pairs move models
        comm_t = _realized_downloads(omega if refresh else adj, active,
                                     rows.start)
        new_adj = adj
        if refresh:
            cand = omega if active is None else omega & active[None, :]
            # the refresh's exchanges are tagged by its span for the
            # wire-bytes audit (`analysis.commaudit`): attributed there,
            # not charged
            with _obs.span("refresh"):
                new_adj = all_clients_graph(
                    prng.fold_in(aux["k_graph"], 1000 + t), recv, p, cand,
                    reward_fn, budget, impl=cfg.graph_impl, mesh=mesh,
                    client_axes=ca, client_chunk=engine._client_chunk)
            if active is not None:
                # absent clients keep their previous C_k
                new_adj = torch.where(mine[:, None], new_adj, adj)
        with _obs.span("mix"):
            mixed = mix(new_adj, flat, recv, payload, prev, active)
        aux["comm"][t] = comm_t
        if hist_len:
            aux["graph_hist"][t % hist_len] = new_adj
        out = dict(aux, adj=new_adj)
        if new_ef is not None:
            out["ef"] = new_ef
        return mixed, out

    return aggregate


def _make_dpfl_aggregate_sparse(engine: FLEngine, cfg: DPFLConfig,
                                reward_fn, budget: int, hist_len: int):
    """The neighbor-list counterpart of `_make_dpfl_aggregate`: the graph
    rides in aux as (N, B) int32 lists (``aux["nbr"]`` the current C_k,
    ``aux["omega_nbr"]`` Omega), the GGC refresh probes only the <= B
    candidates of each client, the Eq.-4 mix gathers the selected peer
    rows (`mix_flat_sparse`, `compress.sparse_mix_compressed`,
    `robust.trimmed_mix_sparse`; never a dense (N, N) operator), and the
    counter sums the realized list slots (`count_neighbor_downloads`),
    the same integers as the dense accounting."""
    p = engine.p
    comp = _compress.normalize(cfg.compression)
    part = cfg.participation is not None
    mesh, ca, rows = engine.mesh, engine.client_axes, engine.rows
    mix = _make_mix(cfg, p, True, mesh, ca, rows.start)

    # bare @exchange_site: this aggregate charges its own downloads, the
    # aux["comm"] counter below
    @exchange_site
    def aggregate(flat, aux, t, prev):
        nbr, omega = aux["nbr"], aux["omega_nbr"]
        active = aux["part"][t] if part else None
        mine = None if active is None else active[rows]
        recv, payload, new_ef = _exchange(
            comp, _wire(cfg, flat, aux, t, rows), aux, t, mine, mesh, ca)
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        comm_t = count_neighbor_downloads(omega if refresh else nbr, active,
                                          rows.start)
        new_nbr = nbr
        if refresh:
            with _obs.span("refresh"):
                new_nbr = all_clients_graph_sparse(
                    prng.fold_in(aux["k_graph"], 1000 + t), recv, p, omega,
                    reward_fn, budget, active=active, mesh=mesh,
                    client_axes=ca, client_chunk=engine._client_chunk)
            if active is not None:
                # absent clients keep their previous C_k lists
                new_nbr = torch.where(mine[:, None], new_nbr, nbr)
        with _obs.span("mix"):
            mixed = mix(new_nbr, flat, recv, payload, prev, active)
        aux["comm"][t] = comm_t
        if hist_len:
            aux["graph_hist"][t % hist_len] = new_nbr
        out = dict(aux, nbr=new_nbr)
        if new_ef is not None:
            out["ef"] = new_ef
        return mixed, out

    return aggregate


def _hist_len(cfg: DPFLConfig) -> int:
    if not cfg.track_history:
        return 0
    return (min(cfg.history_every, cfg.rounds)
            if cfg.history_every else cfg.rounds)


def _dpfl_aux_specs(hist_len: int, participation: bool = False,
                    comp=None, sparse: bool = False,
                    adversary: bool = False) -> dict:
    """Which leaves of the DPFL aux are client rows under a client mesh,
    as the axis their clients lie on (None: whole on every rank;
    `repro.core.dpfl._dpfl_aux_specs`): the graph, Omega and the
    error-feedback residuals on axis 0, the graph history on axis 1. The
    keys and the counter (each rank's partial count) are not, and
    neither are the participation and attack schedules, which every rank
    holds whole (a rank reads peers' availability)."""
    specs = {"nbr": 0, "omega_nbr": 0} if sparse else {"adj": 0,
                                                      "omega": 0}
    specs.update(k_graph=None, comm=None)
    if hist_len:
        specs["graph_hist"] = 1
    if participation:
        specs["part"] = None
    if comp is not None:
        specs["k_comp"] = None
        if _compress.uses_ef(comp):
            specs["ef"] = 0
    if adversary:
        specs["adv"] = {"sched": None, "key": None}
    return specs


def dpfl_round_step(engine: FLEngine, cfg: DPFLConfig, *,
                    donate: bool = True):
    """The DPFL ``round_step`` for (engine, cfg): the exact function
    `run_dpfl` dispatches each round (`repro.core.dpfl.dpfl_round_step`),
    public so the audit and the donation report run the round itself,
    never a copy of it. It donates the state, as `repro`'s does
    (``donate=False`` gives the same bits from a step that allocates its
    outputs). Built anew on each call: the port compiles nothing, so
    there is nothing to memoize on the engine."""
    _check_ported(cfg)
    budget = _budget(cfg, engine.data.n_clients)
    hist_len = _hist_len(cfg)
    adv = cfg.adversary
    make_agg = _make_dpfl_aggregate_sparse if _sparse(cfg) \
        else _make_dpfl_aggregate
    return make_round_step(
        engine, tau=cfg.tau_train,
        aggregate=make_agg(engine, cfg, engine.make_reward_fn(), budget,
                           hist_len),
        local_train=(_adversary.make_adv_local_train(engine, adv)
                     if adv is not None else None),
        post_train=(_adversary.make_post_train(adv, engine.rows)
                    if adv is not None else None),
        hist_len=hist_len,
        aux_specs=_dpfl_aux_specs(
            hist_len, cfg.participation is not None,
            _compress.normalize(cfg.compression), _sparse(cfg),
            adv is not None),
        participation_key=("part" if cfg.participation is not None
                           else None),
        donate=donate)


def dpfl_initial_state(engine: FLEngine, cfg: DPFLConfig):
    """``(state, result)``: the `RoundState` the first round of `run_dpfl`
    starts from, built as `run_dpfl` builds it (Alg. 1 lines 1-5: same
    init, tau_init epochs, Omega, one mix; a random graph samples its
    Omega and runs no BGGC), and the `DPFLResult` it has filled so far
    (the preprocessing counter, the schedules). Under a client mesh, the
    rank's rows."""
    _check_ported(cfg)
    N = engine.data.n_clients
    budget = _budget(cfg, N)
    dev = engine.device
    n_loc = engine.n_local
    omega, flat, k_graph, k_train = _preprocess(
        engine, cfg, engine.make_reward_fn(), budget)
    result = DPFLResult(test_acc=None)
    result.comm_preprocess = _comm_preprocess(cfg, N, budget)
    hist_len = _hist_len(cfg)
    aux = _round_aux(engine, cfg, flat, result)
    aux.update(k_graph=k_graph,
               comm=torch.zeros((cfg.rounds,), dtype=torch.int64,
                                device=dev))
    if _sparse(cfg):
        aux.update(nbr=omega, omega_nbr=omega)
        if hist_len:
            aux["graph_hist"] = torch.full(
                (hist_len, n_loc, _nbr_width(N, budget)), -1,
                dtype=torch.int32, device=dev)
    else:
        aux.update(adj=omega, omega=omega)
        if hist_len:
            aux["graph_hist"] = torch.zeros((hist_len, n_loc, N),
                                            dtype=torch.bool, device=dev)
    return init_round_state(flat, k_train, hist_len=hist_len,
                            aux=aux), result


def abstract_round_state(engine: FLEngine, cfg: DPFLConfig):
    """The `RoundState` of `dpfl_initial_state` as shapes alone: every
    leaf of the same name, shape and dtype on "meta" (no storage), the
    engine's rows under a client mesh
    (`repro.core.dpfl.abstract_round_state`). It runs no preprocessing,
    so `dpfl_round_step` can run one round of a production-size
    configuration on "meta" tensors (`repro_torch.launch.fl_dryrun`)."""
    _check_ported(cfg)
    N = engine.data.n_clients
    n_loc, P_ = engine.n_local, engine.n_params
    hist_len = _hist_len(cfg)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    key = empty((2,), torch.int64)
    aux = {"k_graph": key, "comm": empty((cfg.rounds,), torch.int64)}
    if _sparse(cfg):
        B = _nbr_width(N, _budget(cfg, N))
        aux.update(nbr=empty((n_loc, B), torch.int32),
                   omega_nbr=empty((n_loc, B), torch.int32))
        if hist_len:
            aux["graph_hist"] = empty((hist_len, n_loc, B), torch.int32)
    else:
        aux.update(adj=empty((n_loc, N), torch.bool),
                   omega=empty((n_loc, N), torch.bool))
        if hist_len:
            aux["graph_hist"] = empty((hist_len, n_loc, N), torch.bool)
    comp = _compress.normalize(cfg.compression)
    if comp is not None:
        aux["k_comp"] = key
        if _compress.uses_ef(comp):
            aux["ef"] = empty((n_loc, P_))
    if cfg.participation is not None:
        aux["part"] = empty((cfg.rounds, N), torch.bool)
    if cfg.adversary is not None:
        aux["adv"] = {"sched": empty((cfg.rounds, N), torch.bool),
                      "key": key}
    return init_round_state(empty((n_loc, P_)), key, hist_len=hist_len,
                            aux=aux)


def run_dpfl(engine: FLEngine, cfg: DPFLConfig) -> DPFLResult:
    """Algorithm 1 on the device-resident round engine (on a client mesh
    when the engine is sharded: every rank returns the same result)."""
    N = engine.data.n_clients
    sparse = _sparse(cfg)

    # ---- preprocess (Alg. 1 lines 1-5)
    state, result = dpfl_initial_state(engine, cfg)

    # ---- training loop (Alg. 1 lines 6-12)
    hist_len = _hist_len(cfg)
    round_step = dpfl_round_step(engine, cfg)
    # the client axis of each leaf: what the flushes and the end gather
    spec = round_step.shardings
    g_key = "omega_nbr" if sparse else "omega"

    def flush_histories(st, k):
        # the only device-to-host copies of the round loop (under a mesh,
        # its only gathers of histories); copied, since the buffers are
        # reused (and .cpu() of a CPU tensor is no copy). Sparse
        # histories leave as (N, B) lists and become (N, N) adjacencies
        # here
        result.val_acc_history.extend(engine.whole(
            st.val_hist[:k], spec.val_hist).cpu().numpy().copy())
        hist = engine.whole(st.aux["graph_hist"][:k],
                            spec.aux["graph_hist"]).cpu().numpy()
        result.graph_history.extend(
            [_nbr_to_adj_np(h, N) for h in hist] if sparse else hist.copy())

    state = run_rounds(
        round_step, state, cfg.rounds,
        on_flush=flush_histories if hist_len else None,
        flush_every=hist_len if (hist_len and cfg.history_every) else 0)

    # each rank counted its own clients' downloads: integers, summed over
    # the shards in any order
    comm = engine.whole(state.aux["comm"][None]).sum(dim=0)
    result.comm_downloads = [int(c) for c in comm.tolist()]
    _fill_comm_bytes(result, cfg, engine.n_params)
    test_acc, _ = engine.eval_test(engine.unflatten(state.best_flat))
    result.test_acc = engine.whole(test_acc).cpu().numpy()
    result.best_flat = engine.whole(state.best_flat,
                                    spec.best_flat).cpu().numpy()
    result.omega = _omega_np(engine.whole(state.aux[g_key],
                                          spec.aux[g_key]), N, sparse)
    return result


def run_dpfl_reference(engine: FLEngine, cfg: DPFLConfig) -> DPFLResult:
    """The host-driven round loop (per-round host-side comm accounting and
    history copies), step by step as `repro.core.dpfl.run_dpfl_reference`.
    The equivalence oracle of `run_dpfl`, on one device: a sharded
    engine raises ``ValueError``."""
    _check_ported(cfg)
    if engine.mesh is not None:
        raise ValueError("run_dpfl_reference runs on one device; "
                         "run_dpfl runs a sharded engine")
    N = engine.data.n_clients
    budget = _budget(cfg, N)
    reward_fn = engine.make_reward_fn()
    p = engine.p
    sparse = _sparse(cfg)
    comp = _compress.normalize(cfg.compression)
    adv = cfg.adversary

    omega, flat, k_graph, k_train = _preprocess(engine, cfg, reward_fn,
                                                budget)
    stacked = engine.unflatten(flat)
    best_val = torch.full((N,), float("-inf"), dtype=torch.float32,
                          device=engine.device)
    best_flat = flat.clone()
    result = DPFLResult(test_acc=None, omega=_omega_np(omega, N, sparse))
    result.comm_preprocess = _comm_preprocess(cfg, N, budget)
    aux = _round_aux(engine, cfg, flat, result)
    mix = _make_mix(cfg, p, sparse)
    flip_y = None
    if adv is not None and adv.attack == "label_flip":
        train_y = engine.train_data[1]
        flip_y = torch.as_tensor(_adversary.label_permutation(
            adv, engine.data.n_classes), device=engine.device)[train_y]
    adj = omega
    for t in range(cfg.rounds):
        prev_flat = flat
        kt = prng.fold_in(k_train, t)
        if flip_y is not None:
            # data-level attack: attacking rows train on deranged labels
            ys = torch.where(aux["adv"]["sched"][t][:, None], flip_y,
                             train_y)
            stacked, _ = engine.local_train_with_labels(
                stacked, kt, cfg.tau_train, ys)
        else:
            stacked, _ = engine.local_train(stacked, kt,
                                            epochs=cfg.tau_train)
        flat = engine.flatten(stacked)
        active = aux["part"][t] if "part" in aux else None
        if active is not None:
            # absent clients hold their round-start params
            flat = torch.where(active[:, None], flat, prev_flat)
        if adv is not None:
            # model poisoning after the hold (identity for label_flip)
            flat = _adversary.poison_update(adv, flat, prev_flat,
                                            aux["adv"]["sched"][t])
        recv, payload, new_ef = _exchange(
            comp, _wire(cfg, flat, aux, t, engine.rows), aux, t, active)
        if new_ef is not None:
            aux["ef"] = new_ef
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        count_graph = omega if (refresh or cfg.random_graph) else adj
        if sparse:
            result.comm_downloads.append(
                int(count_neighbor_downloads(count_graph, active)))
        else:
            result.comm_downloads.append(
                int(_realized_downloads(count_graph, active)))
        if refresh and sparse:
            refreshed = all_clients_graph_sparse(
                prng.fold_in(k_graph, 1000 + t), recv, p, omega, reward_fn,
                budget, active=active)
        elif refresh:
            cand = omega if active is None else omega & active[None, :]
            refreshed = all_clients_graph(
                prng.fold_in(k_graph, 1000 + t), recv, p, cand, reward_fn,
                budget, impl=cfg.graph_impl)
        if refresh:
            adj = refreshed if active is None else \
                torch.where(active[:, None], refreshed, adj)
        flat = mix(adj, flat, recv, payload, prev_flat, active)
        stacked = engine.unflatten(flat)
        val_acc, _ = engine.eval_val(stacked)
        improved = val_acc > best_val
        best_val = torch.where(improved, val_acc, best_val)
        best_flat = torch.where(improved[:, None], flat, best_flat)
        if cfg.track_history:
            result.val_acc_history.append(val_acc.cpu().numpy())
            result.graph_history.append(_omega_np(adj, N, sparse))

    _fill_comm_bytes(result, cfg, engine.n_params)
    test_acc, _ = engine.eval_test(engine.unflatten(best_flat))
    result.test_acc = test_acc.cpu().numpy()
    result.best_flat = best_flat.cpu().numpy()
    return result


def graph_stats(result: DPFLResult) -> dict:
    out = {}
    if result.omega is not None:
        out["initial_sparsity"] = _sparsity(result.omega)
        out["initial_symmetry"] = _symmetry(result.omega)
    if result.graph_history:
        out["final_sparsity"] = _sparsity(result.graph_history[-1])
        out["final_symmetry"] = _symmetry(result.graph_history[-1])
    return out
