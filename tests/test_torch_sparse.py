"""The port's sparse (N, B) neighbor-list half against `repro`'s: K2's plain
version, the list conversions, the Eq.-4 list weights, the sparse and
heterogeneous greedy builders, and whole sparse and random-graph runs.

K2 (`ops.sparse_graph_mix` on CPU tensors, which takes the plain version
and launches nothing) matches the Pallas kernel in interpret mode and
`repro`'s oracle within 1e-5 (fp32), on tests/test_sparse_graph.py's
shapes and index tables. Integers are exact (lists, adjacencies, download
counts), weights within 1e-6, and the greedy builders select bitwise what
`repro` selects and what the port's dense builders select on the
equivalent masks. Whole runs hold the tolerances of
tests/test_torch_dpfl.py."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import run_dpfl as jrun  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sparse_graph_mix import \
    sparse_graph_mix as pallas_sparse_mix  # noqa: E402

from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.dpfl import (DPFLConfig, run_dpfl,  # noqa: E402
                                   run_dpfl_reference)
from repro_torch.interop import flat_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparse_graph_mix as k2  # noqa: E402
from test_torch_dpfl import (_assert_same_run, _engines,  # noqa: E402
                             _RewardLog)
from test_torch_graph import (_JP, _JREWARD, _JW, _N, _TP,  # noqa: E402
                              _treward, _TW)

# ------------------------------------------------------------ K2, plain

_K2_SHAPES = [(6, 3, 40), (16, 4, 2100), (5, 7, 33)]   # B > N in the last


def _k2_inputs(N, B, P, table, seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, P)).astype(np.float32)
    peers = rng.standard_normal((N, P)).astype(np.float32)
    idx = {"random": rng.integers(-1, N, (N, B)),
           "duplicates": np.zeros((N, B)),
           "sentinel": np.full((N, B), -1)}[table].astype(np.int32)
    nw = rng.standard_normal((N, B)).astype(np.float32)
    sw = rng.standard_normal(N).astype(np.float32)
    return sw, nw, idx, W, peers


@pytest.mark.parametrize("table", ["random", "duplicates", "sentinel"])
@pytest.mark.parametrize("shape", _K2_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ops_sparse_graph_mix_cpu_matches_repro(shape, table):
    N, B, P = shape
    sw, nw, idx, W, peers = _k2_inputs(N, B, P, table, sum(shape))
    j = [jnp.asarray(a) for a in (sw, nw, idx, W, peers)]
    want_pallas = np.asarray(pallas_sparse_mix(*j, block_p=512,
                                               interpret=True))
    want_ref = np.asarray(jref.sparse_graph_mix_ref(*j))
    before = k2.sparse_graph_mix.launches
    got = ops.sparse_graph_mix(*(torch.from_numpy(a) for a in
                                 (sw, nw, idx, W, peers)))
    assert k2.sparse_graph_mix.launches == before, \
        "a CPU call launched the kernel"
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, P)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_sparse_plain_version_keeps_bf16():
    sw, nw, idx, W, peers = _k2_inputs(6, 3, 40, "random", 0)
    t = [torch.from_numpy(a) for a in (sw, nw, idx)]
    got = ref.sparse_graph_mix_ref(*t, torch.from_numpy(W).bfloat16(),
                                   torch.from_numpy(peers).bfloat16())
    want = ref.sparse_graph_mix_ref(*t, torch.from_numpy(W),
                                    torch.from_numpy(peers))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=5e-2,
                               rtol=5e-2)


def test_sparse_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: it never computes on the CPU."""
    sw, nw, idx, W, peers = _k2_inputs(6, 3, 40, "random", 0)
    with pytest.raises(ValueError, match="CUDA"):
        k2.sparse_graph_mix(*(torch.from_numpy(a) for a in
                              (sw, nw, idx, W, peers)))


# ------------------------------------------------------- representation


def _budgeted_adjacency(n, budget, seed):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    for k in range(n):
        others = np.setdiff1d(np.arange(n), [k])
        take = rng.integers(0, min(budget, n - 1) + 1)
        adj[k, rng.choice(others, take, replace=False)] = True
    return adj | np.eye(n, dtype=bool)


_LIST_CASES = [(2, 1, 0), (5, 2, 1), (7, 3, 2), (9, 5, 3), (4, 6, 4),
               (12, 4, 5)]


@pytest.mark.parametrize("n,budget,seed", _LIST_CASES)
def test_list_conversions_match_repro(n, budget, seed):
    adj = _budgeted_adjacency(n, budget, seed)
    want = np.asarray(jgraph.neighbors_from_adjacency(jnp.asarray(adj),
                                                      budget))
    got = tgraph.neighbors_from_adjacency(torch.from_numpy(adj), budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tgraph.adjacency_from_neighbors(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jgraph.adjacency_from_neighbors(
            jnp.asarray(want), n)))
    np.testing.assert_array_equal(back.numpy(), adj)
    assert int(tgraph.count_neighbor_downloads(got)) == \
        int(jgraph.count_neighbor_downloads(jnp.asarray(want))) == \
        int(adj.sum() - n)
    for k in range(n):
        np.testing.assert_array_equal(
            tgraph.mask_to_neighbors(torch.from_numpy(adj[k]), k,
                                     budget).numpy(),
            np.asarray(jgraph.mask_to_neighbors(jnp.asarray(adj[k]), k,
                                                budget)))


@pytest.mark.parametrize("n,budget,seed", _LIST_CASES)
def test_sparse_mixing_weights_match_repro(n, budget, seed):
    adj = _budgeted_adjacency(n, budget, seed)
    p = np.random.default_rng(seed).uniform(0.1, 1.0, n).astype(np.float32)
    jidx = jgraph.neighbors_from_adjacency(jnp.asarray(adj), budget)
    idx = torch.from_numpy(np.array(jidx))
    for name in ("sparse_mixing_weights", "sparse_eq4_unnormalized"):
        want = getattr(jgraph, name)(jidx, jnp.asarray(p))
        got = getattr(tgraph, name)(idx, torch.from_numpy(p))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    # scattered back, the list weights are the mixing_matrix rows
    self_w, nbr_w = tgraph.sparse_mixing_weights(idx, torch.from_numpy(p))
    rows = np.diag(self_w.numpy())
    for k in range(n):
        for b in range(idx.shape[1]):
            if idx[k, b] >= 0:
                rows[k, idx[k, b]] += nbr_w[k, b].item()
    np.testing.assert_allclose(
        rows, tgraph.mixing_matrix(torch.from_numpy(adj),
                                   torch.from_numpy(p)).numpy(), atol=1e-6)


def test_mix_flat_sparse_matches_repro_and_dense_mix():
    adj = _budgeted_adjacency(_N, 3, 9)
    jidx = jgraph.neighbors_from_adjacency(jnp.asarray(adj), 3)
    sw, nw = jgraph.sparse_mixing_weights(jidx, _JP)
    want = np.asarray(jgraph.mix_flat_sparse(sw, nw, jidx, _JW, impl="ref"))
    idx = torch.from_numpy(np.array(jidx))
    tsw, tnw = tgraph.sparse_mixing_weights(idx, _TP)
    got = tgraph.mix_flat_sparse(tsw, tnw, idx, _TW)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    dense = tgraph.mix_flat(tgraph.mixing_matrix(torch.from_numpy(adj), _TP),
                            _TW)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sparse_participation_not_ported():
    """Named for the refusal it once asserted: with ``active`` the port's
    `count_neighbor_downloads` (exactly), `sparse_eq4_unnormalized` and
    `sparse_mixing_weights` (within 1e-6) match `repro`'s, on lists with
    -1 slots."""
    for seed in range(3):
        adj = _budgeted_adjacency(_N, 3, seed)
        active = np.random.default_rng(seed).random(_N) < 0.6
        jidx = jgraph.neighbors_from_adjacency(jnp.asarray(adj), 3)
        idx = torch.from_numpy(np.array(jidx))
        jact, tact = jnp.asarray(active), torch.from_numpy(active)
        assert int(tgraph.count_neighbor_downloads(idx, tact)) == \
            int(jgraph.count_neighbor_downloads(jidx, jact))
        for name in ("sparse_eq4_unnormalized", "sparse_mixing_weights"):
            for got, want in zip(
                    getattr(tgraph, name)(idx, _TP, active=tact),
                    getattr(jgraph, name)(jidx, _JP, active=jact)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- greedy builders

_JIT = {}


def _jit(name, *args):
    if (name, args) not in _JIT:
        _JIT[name, args] = jax.jit(getattr(jgraph, name), static_argnums=(
            {"all_clients_graph_sparse": (4, 5),
             "all_clients_bggc_sparse": (3, 4)}[name]))
    return _JIT[name, args]


@pytest.mark.parametrize("budget", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 17])
def test_sparse_ggc_selects_what_repro_and_dense_select(budget, seed):
    rng = np.random.default_rng(seed)
    cand = _budgeted_adjacency(_N, budget, seed + 1) & \
        (rng.random((_N, _N)) < 0.9)
    cand_idx = np.asarray(jgraph.neighbors_from_adjacency(
        jnp.asarray(cand), budget))
    key = jax.random.PRNGKey(seed + 5)
    want = np.asarray(_jit("all_clients_graph_sparse", budget)(
        key, _JW, _JP, jnp.asarray(cand_idx), _JREWARD, budget))
    tkey = common.key_to_torch(key)
    got = tgraph.all_clients_graph_sparse(tkey, _TW, _TP,
                                          torch.from_numpy(cand_idx),
                                          _treward, budget)
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tgraph.all_clients_graph(
        tkey, _TW, _TP, tgraph.adjacency_from_neighbors(
            torch.from_numpy(cand_idx), _N), _treward, budget)
    np.testing.assert_array_equal(
        tgraph.adjacency_from_neighbors(got, _N).numpy(), dense.numpy())


@pytest.mark.parametrize("budget", [1, 3, 4, 8])
def test_sparse_bggc_selects_what_repro_and_dense_select(budget):
    key = jax.random.PRNGKey(31 + budget)
    want = np.asarray(_jit("all_clients_bggc_sparse", budget)(
        key, _JW, _JP, _JREWARD, budget))
    tkey = common.key_to_torch(key)
    got = tgraph.all_clients_bggc_sparse(tkey, _TW, _TP, _treward, budget)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (_N, max(1, min(budget, _N - 1)))
    dense = tgraph.all_clients_bggc(tkey, _TW, _TP,
                                    torch.ones((_N, _N), dtype=torch.bool),
                                    _treward, budget)
    np.testing.assert_array_equal(
        tgraph.adjacency_from_neighbors(got, _N).numpy(), dense.numpy())


@pytest.mark.parametrize("reach", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_heterogeneous_ggc_matches_repro(seed, reach):
    rng = np.random.default_rng(seed)
    budgets = rng.integers(0, _N, _N).astype(np.int32)
    cand = rng.random((_N, _N)) < 0.8
    reachability = (rng.random((_N, _N)) < 0.7) if reach else None
    key = jax.random.PRNGKey(seed + 40)
    want = np.asarray(jgraph.all_clients_graph_heterogeneous(
        key, _JW, _JP, jnp.asarray(cand), _JREWARD, jnp.asarray(budgets),
        None if reachability is None else jnp.asarray(reachability)))
    got = tgraph.all_clients_graph_heterogeneous(
        common.key_to_torch(key), _TW, _TP, torch.from_numpy(cand),
        _treward, torch.from_numpy(budgets),
        None if reachability is None else torch.from_numpy(reachability))
    np.testing.assert_array_equal(got.numpy(), want)
    off = got.numpy() & ~np.eye(_N, dtype=bool)
    assert np.all(off.sum(1) <= budgets)


def test_heterogeneous_ggc_with_one_budget_is_ggc():
    key = common.key_to_torch(jax.random.PRNGKey(77))
    cand = torch.ones((_N, _N), dtype=torch.bool)
    got = tgraph.all_clients_graph_heterogeneous(
        key, _TW, _TP, cand, _treward, torch.full((_N,), 2))
    want = tgraph.all_clients_graph(key, _TW, _TP, cand, _treward, 2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sparse_bggc_on_small_mlp_matches_repro():
    je, te = common.make_engines("mlp")
    stacked = je.init_clients(jax.random.PRNGKey(0))
    stacked, _ = je.local_train(stacked, jax.random.PRNGKey(1), epochs=2)
    flat = je.flatten(stacked)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(lambda k, f: jgraph.all_clients_bggc_sparse(
        k, f, je.p, je.make_reward_fn(), 3))(key, flat))
    got = tgraph.all_clients_bggc_sparse(
        common.key_to_torch(key), flat_from_jax(np.asarray(flat), "cpu"),
        te.p, te.make_reward_fn(), 3)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- whole runs

RUNS = {
    "sparse-refresh1": ("mlp", dict(rounds=4, tau_init=2, tau_train=1,
                                    budget=3, seed=0, refresh_period=1,
                                    graph_repr="sparse")),
    "sparse-refresh2": ("mlp", dict(rounds=4, tau_init=2, tau_train=1,
                                    budget=3, seed=0, refresh_period=2,
                                    graph_repr="sparse")),
    "random-dense": ("mlp", dict(rounds=3, tau_init=2, tau_train=1,
                                 budget=2, seed=4, random_graph=True)),
    "random-sparse": ("mlp", dict(rounds=3, tau_init=2, tau_train=1,
                                  budget=2, seed=4, random_graph=True,
                                  graph_repr="sparse")),
    "sparse-cnn": ("cnn", dict(rounds=2, tau_init=2, tau_train=1, budget=2,
                               seed=0, graph_repr="sparse")),
}


@pytest.mark.parametrize("setting", list(RUNS))
def test_sparse_and_random_runs_match_repro_and_own_reference(setting):
    kind, cfg_kw = RUNS[setting]
    je, te = _engines(kind)
    log = _RewardLog(te)
    try:
        want = jrun(je, JConfig(**cfg_kw))
        got = run_dpfl(te, DPFLConfig(**cfg_kw))
        host = run_dpfl_reference(te, DPFLConfig(**cfg_kw))
    finally:
        del te.make_reward_fn
    _assert_same_run(want, got, cfg_kw, log, f"{setting}: port vs repro")
    _assert_same_run(got, host, cfg_kw, log,
                     f"{setting}: run_dpfl vs run_dpfl_reference")
    N = te.data.n_clients
    if cfg_kw.get("random_graph"):
        assert got.comm_preprocess == N * min(cfg_kw["budget"], N - 1)
        for g in got.graph_history:
            np.testing.assert_array_equal(g, got.omega)
    else:
        assert got.comm_preprocess == 2 * N * (N - 1)


def test_sparse_run_selects_what_dense_run_selects():
    _, te = _engines("mlp")
    kw = dict(rounds=3, tau_init=2, tau_train=1, budget=2, seed=6)
    dense = run_dpfl(te, DPFLConfig(**kw))
    sparse = run_dpfl(te, DPFLConfig(graph_repr="sparse", **kw))
    np.testing.assert_array_equal(dense.omega, sparse.omega)
    for a, b in zip(dense.graph_history, sparse.graph_history):
        np.testing.assert_array_equal(a, b)
    assert dense.comm_downloads == sparse.comm_downloads
    assert dense.comm_bytes == sparse.comm_bytes
    np.testing.assert_allclose(dense.best_flat, sparse.best_flat, rtol=1e-4,
                               atol=1e-5)


def test_sparse_naive_is_refused():
    _, te = _engines("mlp")
    with pytest.raises(ValueError, match="dense-only"):
        run_dpfl(te, DPFLConfig(rounds=1, tau_init=1, tau_train=1, budget=2,
                                graph_repr="sparse", graph_impl="naive"))


@pytest.mark.parametrize("refresh_period", [1, 2])
def test_sparse_kernel_calls_per_run(monkeypatch, refresh_period):
    """A sparse run calls K1 once per BGGC phase-1 batch and once per
    greedy init (refresh rounds), and K2 once for the preprocessing mix
    and once per round: ceil(N/B) + refreshes and 1 + rounds calls, the
    counts chip_smoke.py asserts on the card."""
    _, te = _engines("mlp")
    calls = {"graph_mix": 0, "sparse_graph_mix": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ops, name, counted)
    rounds, budget = 4, 4
    run_dpfl(te, DPFLConfig(rounds=rounds, tau_init=1, tau_train=1,
                            budget=budget, seed=2, graph_repr="sparse",
                            refresh_period=refresh_period))
    N = te.data.n_clients
    refreshes = len(range(0, rounds, refresh_period))
    assert calls == {"graph_mix": -(-N // budget) + refreshes,
                     "sparse_graph_mix": 1 + rounds}


def test_sparse_history_flushes_every_k_rounds():
    """(N, B) list histories leave the device every K rounds and become
    the same (N, N) adjacencies as when they leave once at the end."""
    _, te = _engines("mlp")
    kw = dict(rounds=3, tau_init=1, tau_train=1, budget=2, seed=1,
              graph_repr="sparse")
    a = run_dpfl(te, DPFLConfig(**kw))
    b = run_dpfl(te, DPFLConfig(history_every=2, **kw))
    assert len(b.graph_history) == len(b.val_acc_history) == 3
    for x, y in zip(a.graph_history, b.graph_history):
        assert x.shape == (te.data.n_clients,) * 2
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.best_flat, b.best_flat)
