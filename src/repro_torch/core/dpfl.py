"""DPFL — Algorithm 1 (Decentralized Personalized Federated Learning),
port of `repro.core.dpfl` with full participation, no adversary and
``mix_rule="weighted"``: dense (N, N) or sparse (N, B) neighbor-list
graphs, the Fig.-3 random graph, and the codecs of `fl.compress`.

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

`run_dpfl` runs the rounds on the device-resident round engine
(`repro_torch.fl.round_engine`): comm counters and histories stay on the
device and leave it once, at the end (or every ``history_every``
rounds). `run_dpfl_reference` is the host-driven loop, kept as the
engine's equivalence oracle. Both derive every key as `repro` does, so
on the same init they make the same random choices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import prng
from ..analysis.registry import exchange_site
from ..fl import compress as _compress
from ..fl.engine import FLEngine
from ..fl.round_engine import init_round_state, make_round_step, run_rounds
from .graph import (all_clients_bggc, all_clients_bggc_sparse,
                    all_clients_graph, all_clients_graph_sparse,
                    count_neighbor_downloads, mix_flat, mix_flat_sparse,
                    mixing_matrix, sparse_mixing_weights)


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
    compression: Optional[Any] = None  # fl.compress.CompressionConfig;
    #                                    None and "identity" run the same
    #                                    code
    # settings of `repro.core.dpfl.DPFLConfig` the port does not run yet;
    # anything but the default raises NotImplementedError (`_check_ported`)
    participation: Optional[Any] = None
    adversary: Optional[Any] = None
    mix_rule: str = "weighted"
    trim_frac: float = 0.2
    clip_mult: float = 1.0


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


_NOT_PORTED = (
    ("participation", None, "Queue 1 item 8"),
    ("adversary", None, "Queue 1 item 10"),
    ("mix_rule", "weighted", "Queue 1 item 10"),
)


def _check_ported(cfg: DPFLConfig):
    """Raise NotImplementedError for a setting the port does not run yet,
    naming the ROADMAP item that ports it; ValueError for a combination
    `repro` refuses too."""
    for name, default, item in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"DPFLConfig.{name}={getattr(cfg, name)!r} is not ported to "
                f"repro_torch yet (ROADMAP.md {item})")
    if cfg.graph_impl not in ("ggc", "naive"):
        raise NotImplementedError(
            f"DPFLConfig.graph_impl={cfg.graph_impl!r}: the port has "
            f"'ggc' and 'naive'")
    if cfg.compression is not None and \
            not isinstance(cfg.compression, _compress.CompressionConfig):
        raise TypeError(f"DPFLConfig.compression must be a "
                        f"repro_torch.fl.compress.CompressionConfig or "
                        f"None, got {cfg.compression!r}")
    _sparse(cfg)


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
    sparse."""
    N = engine.data.n_clients
    p = engine.p
    key = prng.PRNGKey(cfg.seed, device=engine.device)
    k_init, k_pre, k_graph, k_train = prng.split(key, 4)

    stacked = engine.init_clients(k_init)
    stacked, _ = engine.local_train(stacked, k_pre, epochs=cfg.tau_init)
    flat = engine.flatten(stacked)
    sparse = _sparse(cfg)
    if cfg.random_graph:
        omega = _random_graph(cfg, N, budget, sparse, engine.device)
    elif sparse:
        omega = all_clients_bggc_sparse(k_graph, flat, p, reward_fn, budget)
    else:
        cand = torch.ones((N, N), dtype=torch.bool, device=engine.device)
        omega = all_clients_bggc(k_graph, flat, p, cand, reward_fn, budget)
    if sparse:
        self_w, nbr_w = sparse_mixing_weights(omega, p)
        flat = mix_flat_sparse(self_w, nbr_w, omega, flat)
    else:
        flat = mix_flat(mixing_matrix(omega, p), flat)
    return omega, flat, k_graph, k_train


def _omega_np(omega: torch.Tensor, N: int, sparse: bool) -> np.ndarray:
    """Omega as the (N, N) bool adjacency the results report."""
    om = omega.cpu().numpy()
    return _nbr_to_adj_np(om, N) if sparse else om


def _exchange(comp, flat, aux, t):
    """The transmit side of round t under codec ``comp`` (None: no codec):
    ``(probe_w, payload, dec, new_ef)``, the model table the GGC refresh
    probes, the wire payload, the decoded table and the new residuals."""
    if comp is None:
        return flat, None, None, None
    payload, dec, new_ef = _compress.compress_exchange(
        comp, flat, aux.get("ef"), prng.fold_in(aux["k_comp"], t))
    return dec, payload, dec, new_ef


def _mix_dense(comp, adj, p, flat, payload, dec):
    A = mixing_matrix(adj, p)
    if comp is None:
        return mix_flat(A, flat)
    return _compress.mix_compressed(comp, A, flat, payload, dec)


def _mix_sparse(comp, nbr, p, flat, payload, dec):
    self_w, nbr_w = sparse_mixing_weights(nbr, p)
    if comp is None:
        return mix_flat_sparse(self_w, nbr_w, nbr, flat)
    return _compress.sparse_mix_compressed(comp, self_w, nbr_w, nbr, flat,
                                           payload, dec)


def _make_dpfl_aggregate(engine: FLEngine, cfg: DPFLConfig, reward_fn,
                         budget: int, hist_len: int):
    """The communication step of one DPFL round, dense (N, N) graphs:
    the codec exchange, the GGC refresh inside Omega every
    ``cfg.refresh_period`` rounds (Alg. 1 line 9; never for the random
    graph), the Eq.-4 mix and the comm-download counter. Omega, the
    current graph, the keys, the residuals and the counters are read from
    ``aux``; the counters and the graph history are written in place."""
    p = engine.p
    comp = _compress.normalize(cfg.compression)

    # bare @exchange_site: this aggregate charges its own downloads, the
    # aux["comm"] counter below
    @exchange_site
    def aggregate(flat, aux, t):
        adj, omega = aux["adj"], aux["omega"]
        N = adj.shape[0]
        probe_w, payload, dec, new_ef = _exchange(comp, flat, aux, t)
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        # line 9 needs all of Omega_k; aggregation-only rounds download
        # the currently selected C_k (the random graph: Omega itself)
        comm_t = (omega if refresh else adj).sum() - N
        if refresh:
            new_adj = all_clients_graph(
                prng.fold_in(aux["k_graph"], 1000 + t), probe_w, p, omega,
                reward_fn, budget, impl=cfg.graph_impl)
        else:
            new_adj = adj
        mixed = _mix_dense(comp, new_adj, p, flat, payload, dec)
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
    rows (`mix_flat_sparse`, `compress.sparse_mix_compressed`; never a
    dense (N, N) operator), and the counter sums the realized list
    lengths (`count_neighbor_downloads`), the same integers as the dense
    accounting."""
    p = engine.p
    comp = _compress.normalize(cfg.compression)

    # bare @exchange_site: this aggregate charges its own downloads, the
    # aux["comm"] counter below
    @exchange_site
    def aggregate(flat, aux, t):
        nbr, omega = aux["nbr"], aux["omega_nbr"]
        probe_w, payload, dec, new_ef = _exchange(comp, flat, aux, t)
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        comm_t = count_neighbor_downloads(omega if refresh else nbr)
        if refresh:
            new_nbr = all_clients_graph_sparse(
                prng.fold_in(aux["k_graph"], 1000 + t), probe_w, p, omega,
                reward_fn, budget)
        else:
            new_nbr = nbr
        mixed = _mix_sparse(comp, new_nbr, p, flat, payload, dec)
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


def run_dpfl(engine: FLEngine, cfg: DPFLConfig) -> DPFLResult:
    """Algorithm 1 on the device-resident round engine."""
    _check_ported(cfg)
    N = engine.data.n_clients
    budget = _budget(cfg, N)
    reward_fn = engine.make_reward_fn()
    dev = engine.device
    sparse = _sparse(cfg)
    comp = _compress.normalize(cfg.compression)

    # ---- preprocess (Alg. 1 lines 1-5)
    omega, flat, k_graph, k_train = _preprocess(engine, cfg, reward_fn,
                                                budget)
    result = DPFLResult(test_acc=None, omega=_omega_np(omega, N, sparse))
    result.comm_preprocess = _comm_preprocess(cfg, N, budget)

    # ---- training loop (Alg. 1 lines 6-12)
    hist_len = _hist_len(cfg)
    aux = {"k_graph": k_graph,
           "comm": torch.zeros((cfg.rounds,), dtype=torch.int64,
                               device=dev)}
    if sparse:
        aux.update(nbr=omega, omega_nbr=omega)
        if hist_len:
            aux["graph_hist"] = torch.full(
                (hist_len, N, _nbr_width(N, budget)), -1,
                dtype=torch.int32, device=dev)
    else:
        aux.update(adj=omega, omega=omega)
        if hist_len:
            aux["graph_hist"] = torch.zeros((hist_len, N, N),
                                            dtype=torch.bool, device=dev)
    if comp is not None:
        aux["k_comp"] = _comp_base_key(cfg.seed, dev)
        if _compress.uses_ef(comp):
            aux["ef"] = torch.zeros_like(flat)
    make_agg = _make_dpfl_aggregate_sparse if sparse else _make_dpfl_aggregate
    round_step = make_round_step(
        engine, tau=cfg.tau_train,
        aggregate=make_agg(engine, cfg, reward_fn, budget, hist_len),
        hist_len=hist_len)
    state = init_round_state(flat, k_train, hist_len=hist_len, aux=aux)

    def flush_histories(st, k):
        # the only device-to-host copies of the round loop; copied, since
        # the buffers are reused (and .cpu() of a CPU tensor is no copy).
        # Sparse histories leave as (N, B) lists and become (N, N)
        # adjacencies here
        result.val_acc_history.extend(st.val_hist[:k].cpu().numpy().copy())
        hist = st.aux["graph_hist"][:k].cpu().numpy().copy()
        result.graph_history.extend(
            [_nbr_to_adj_np(h, N) for h in hist] if sparse else hist)

    state = run_rounds(
        round_step, state, cfg.rounds,
        on_flush=flush_histories if hist_len else None,
        flush_every=hist_len if (hist_len and cfg.history_every) else 0)

    result.comm_downloads = [int(c) for c in state.aux["comm"].tolist()]
    _fill_comm_bytes(result, cfg, engine.n_params)
    test_acc, _ = engine.eval_test(engine.unflatten(state.best_flat))
    result.test_acc = test_acc.cpu().numpy()
    result.best_flat = state.best_flat.cpu().numpy()
    return result


def run_dpfl_reference(engine: FLEngine, cfg: DPFLConfig) -> DPFLResult:
    """The host-driven round loop (per-round host-side comm accounting and
    history copies). The equivalence oracle of `run_dpfl`."""
    _check_ported(cfg)
    N = engine.data.n_clients
    budget = _budget(cfg, N)
    reward_fn = engine.make_reward_fn()
    p = engine.p
    sparse = _sparse(cfg)
    comp = _compress.normalize(cfg.compression)

    omega, flat, k_graph, k_train = _preprocess(engine, cfg, reward_fn,
                                                budget)
    stacked = engine.unflatten(flat)
    best_val = torch.full((N,), float("-inf"), dtype=torch.float32,
                          device=engine.device)
    best_flat = flat.clone()
    result = DPFLResult(test_acc=None, omega=_omega_np(omega, N, sparse))
    result.comm_preprocess = _comm_preprocess(cfg, N, budget)
    aux = {}
    if comp is not None:
        aux["k_comp"] = _comp_base_key(cfg.seed, engine.device)
        if _compress.uses_ef(comp):
            aux["ef"] = torch.zeros_like(flat)
    adj = omega
    for t in range(cfg.rounds):
        stacked, _ = engine.local_train(stacked, prng.fold_in(k_train, t),
                                        epochs=cfg.tau_train)
        flat = engine.flatten(stacked)
        probe_w, payload, dec, new_ef = _exchange(comp, flat, aux, t)
        if new_ef is not None:
            aux["ef"] = new_ef
        refresh = not cfg.random_graph and t % cfg.refresh_period == 0
        count_graph = omega if (refresh or cfg.random_graph) else adj
        if sparse:
            result.comm_downloads.append(
                int(count_neighbor_downloads(count_graph)))
        else:
            result.comm_downloads.append(int(count_graph.sum()) - N)
        if refresh and sparse:
            adj = all_clients_graph_sparse(prng.fold_in(k_graph, 1000 + t),
                                           probe_w, p, omega, reward_fn,
                                           budget)
        elif refresh:
            adj = all_clients_graph(prng.fold_in(k_graph, 1000 + t),
                                    probe_w, p, omega, reward_fn, budget,
                                    impl=cfg.graph_impl)
        mix = _mix_sparse if sparse else _mix_dense
        flat = mix(comp, adj, p, flat, payload, dec)
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
