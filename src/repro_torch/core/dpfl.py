"""DPFL — Algorithm 1 (Decentralized Personalized Federated Learning),
port of `repro.core.dpfl` in its default setting: dense (N, N) graphs,
full participation, no codec, no adversary, ``mix_rule="weighted"``.

Preprocess: same-init local models, tau_init local epochs, BGGC builds the
budgeted candidate graph Omega, one Eq.-4 mix over Omega. Training loop:
tau_train local epochs, GGC re-selects C_k within Omega_k (every
``refresh_period`` rounds), weighted aggregation over C_k ∪ {k} (Eq. 4).
Best-on-validation models are kept per client and give the final test
accuracy (paper §4.1).

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
from ..fl.engine import FLEngine
from ..fl.round_engine import init_round_state, make_round_step, run_rounds
from .graph import all_clients_bggc, all_clients_graph, mix_flat, mixing_matrix


@dataclass
class DPFLConfig:
    rounds: int = 20
    tau_init: int = 10
    tau_train: int = 5
    budget: Optional[int] = None      # B_c; None = inf (no constraint)
    refresh_period: int = 1           # P: run GGC every P rounds (Table 3)
    seed: int = 0
    graph_impl: str = "ggc"           # ggc | naive (oracle)
    track_history: bool = True
    history_every: int = 0            # pull histories off the device every
    #                                   K rounds (0 = once at the end); also
    #                                   bounds the device history buffers
    # settings of `repro.core.dpfl.DPFLConfig` the port does not run yet;
    # anything but the default raises NotImplementedError (`_check_ported`)
    random_graph: bool = False        # Fig. 3 ablation
    participation: Optional[Any] = None
    graph_repr: str = "dense"
    compression: Optional[Any] = None
    adversary: Optional[Any] = None
    mix_rule: str = "weighted"
    trim_frac: float = 0.2
    clip_mult: float = 1.0


@dataclass
class DPFLResult:
    test_acc: np.ndarray              # (N,) per-client acc of best-val model
    val_acc_history: list = field(default_factory=list)
    graph_history: list = field(default_factory=list)   # adjacency per round
    omega: Optional[np.ndarray] = None
    best_flat: Optional[np.ndarray] = None  # (N, P) best-val client models
    # communication accounting in models downloaded (the paper's cost
    # unit): preprocessing BGGC = 2(N-1) per client (Algorithm 3 streams
    # every peer in both phases); each training round = |Omega_k| when GGC
    # refreshes (it needs all candidates), else |C_k| (aggregation only)
    comm_downloads: list = field(default_factory=list)  # per-round totals
    comm_preprocess: int = 0
    # bytes = downloads x 4P (raw fp32 models; no codec in this port yet)
    comm_bytes: list = field(default_factory=list)      # per-round totals
    comm_bytes_preprocess: int = 0


_NOT_PORTED = (
    ("random_graph", False, "Queue 1 item 7"),
    ("participation", None, "Queue 1 item 8"),
    ("graph_repr", "dense", "Queue 1 item 7"),
    ("compression", None, "Queue 1 item 9"),
    ("adversary", None, "Queue 1 item 10"),
    ("mix_rule", "weighted", "Queue 1 item 10"),
)


def _check_ported(cfg: DPFLConfig):
    """Raise NotImplementedError for a setting the port does not run yet,
    naming the ROADMAP item that ports it."""
    for name, default, item in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"DPFLConfig.{name}={getattr(cfg, name)!r} is not ported to "
                f"repro_torch yet (ROADMAP.md {item})")
    if cfg.graph_impl not in ("ggc", "naive"):
        raise NotImplementedError(
            f"DPFLConfig.graph_impl={cfg.graph_impl!r}: the port has "
            f"'ggc' and 'naive'")


def _sparsity(adj: np.ndarray) -> float:
    n = adj.shape[0]
    off = adj.sum() - np.trace(adj)
    return 1.0 - off / (n * (n - 1))


def _symmetry(adj: np.ndarray) -> float:
    a = adj.copy().astype(bool)
    np.fill_diagonal(a, False)
    denom = a.sum()
    return float((a & a.T).sum() / denom) if denom else 1.0


def _comm_preprocess(N: int) -> int:
    """Models downloaded during preprocessing. BGGC (Algorithm 3) streams
    every peer in both communication phases: once to accumulate the
    shrink-set sum w^Y, once more for the batched greedy decisions (a
    client never holds more than B_c models, so it cannot replay stored
    batches). That is 2(N-1) downloads per client."""
    return 2 * N * (N - 1)


def _fill_comm_bytes(result: DPFLResult, n_params: int):
    """Download counts -> bytes, shared by the engine and the reference:
    every download moves one raw fp32 model of ``4 * n_params`` bytes."""
    bpm = 4 * n_params
    result.comm_bytes = [int(d) * bpm for d in result.comm_downloads]
    result.comm_bytes_preprocess = result.comm_preprocess * bpm


def _budget(cfg: DPFLConfig, N: int) -> int:
    return cfg.budget if cfg.budget is not None else N - 1


def _preprocess(engine: FLEngine, cfg: DPFLConfig, reward_fn, budget: int):
    """Alg. 1 lines 1-5: same-init clients, tau_init local epochs, BGGC
    candidate graph Omega, one Eq.-4 mix over Omega. Shared by the engine
    and the reference loops, so both start from the same (omega, flat)."""
    N = engine.data.n_clients
    key = prng.PRNGKey(cfg.seed, device=engine.device)
    k_init, k_pre, k_graph, k_train = prng.split(key, 4)

    stacked = engine.init_clients(k_init)
    stacked, _ = engine.local_train(stacked, k_pre, epochs=cfg.tau_init)
    flat = engine.flatten(stacked)
    cand = torch.ones((N, N), dtype=torch.bool, device=engine.device)
    omega = all_clients_bggc(k_graph, flat, engine.p, cand, reward_fn,
                             budget)
    flat = mix_flat(mixing_matrix(omega, engine.p), flat)
    return omega, flat, k_graph, k_train


def _make_dpfl_aggregate(engine: FLEngine, cfg: DPFLConfig, reward_fn,
                         budget: int, hist_len: int):
    """The communication step of one DPFL round: GGC refresh inside Omega
    every ``cfg.refresh_period`` rounds (Alg. 1 line 9), the Eq.-4 mix and
    the comm-download counter. Omega, the current graph, the graph key and
    the counters are read from ``aux``; the counters and the graph
    history are written in place."""
    p = engine.p

    # bare @exchange_site: this aggregate charges its own downloads, the
    # aux["comm"] counter below
    @exchange_site
    def aggregate(flat, aux, t):
        adj, omega = aux["adj"], aux["omega"]
        N = adj.shape[0]
        refresh = t % cfg.refresh_period == 0
        # line 9 needs all of Omega_k; aggregation-only rounds download
        # the currently selected C_k
        comm_t = (omega if refresh else adj).sum() - N
        if refresh:
            new_adj = all_clients_graph(
                prng.fold_in(aux["k_graph"], 1000 + t), flat, p, omega,
                reward_fn, budget, impl=cfg.graph_impl)
        else:
            new_adj = adj
        mixed = mix_flat(mixing_matrix(new_adj, p), flat)
        aux["comm"][t] = comm_t
        if hist_len:
            aux["graph_hist"][t % hist_len] = new_adj
        return mixed, dict(aux, adj=new_adj)

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

    # ---- preprocess (Alg. 1 lines 1-5)
    omega, flat, k_graph, k_train = _preprocess(engine, cfg, reward_fn,
                                                budget)
    result = DPFLResult(test_acc=None, omega=omega.cpu().numpy())
    result.comm_preprocess = _comm_preprocess(N)

    # ---- training loop (Alg. 1 lines 6-12)
    hist_len = _hist_len(cfg)
    aux = {"adj": omega, "omega": omega, "k_graph": k_graph,
           "comm": torch.zeros((cfg.rounds,), dtype=torch.int64,
                               device=dev)}
    if hist_len:
        aux["graph_hist"] = torch.zeros((hist_len, N, N), dtype=torch.bool,
                                        device=dev)
    round_step = make_round_step(
        engine, tau=cfg.tau_train,
        aggregate=_make_dpfl_aggregate(engine, cfg, reward_fn, budget,
                                       hist_len),
        hist_len=hist_len)
    state = init_round_state(flat, k_train, hist_len=hist_len, aux=aux)

    def flush_histories(st, k):
        # the only device-to-host copies of the round loop; copied, since
        # the buffers are reused (and .cpu() of a CPU tensor is no copy)
        result.val_acc_history.extend(st.val_hist[:k].cpu().numpy().copy())
        result.graph_history.extend(
            st.aux["graph_hist"][:k].cpu().numpy().copy())

    state = run_rounds(
        round_step, state, cfg.rounds,
        on_flush=flush_histories if hist_len else None,
        flush_every=hist_len if (hist_len and cfg.history_every) else 0)

    result.comm_downloads = [int(c) for c in state.aux["comm"].tolist()]
    _fill_comm_bytes(result, engine.n_params)
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

    omega, flat, k_graph, k_train = _preprocess(engine, cfg, reward_fn,
                                                budget)
    stacked = engine.unflatten(flat)
    best_val = torch.full((N,), float("-inf"), dtype=torch.float32,
                          device=engine.device)
    best_flat = flat.clone()
    result = DPFLResult(test_acc=None, omega=omega.cpu().numpy())
    result.comm_preprocess = _comm_preprocess(N)
    adj = omega
    for t in range(cfg.rounds):
        stacked, _ = engine.local_train(stacked, prng.fold_in(k_train, t),
                                        epochs=cfg.tau_train)
        flat = engine.flatten(stacked)
        refresh = t % cfg.refresh_period == 0
        count_graph = omega if refresh else adj
        result.comm_downloads.append(int(count_graph.sum()) - N)
        if refresh:
            adj = all_clients_graph(prng.fold_in(k_graph, 1000 + t), flat,
                                    p, omega, reward_fn, budget,
                                    impl=cfg.graph_impl)
        flat = mix_flat(mixing_matrix(adj, p), flat)
        stacked = engine.unflatten(flat)
        val_acc, _ = engine.eval_val(stacked)
        improved = val_acc > best_val
        best_val = torch.where(improved, val_acc, best_val)
        best_flat = torch.where(improved[:, None], flat, best_flat)
        if cfg.track_history:
            result.val_acc_history.append(val_acc.cpu().numpy())
            result.graph_history.append(adj.cpu().numpy())

    _fill_comm_bytes(result, engine.n_params)
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
