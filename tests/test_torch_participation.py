"""Partial participation in the port against `repro`.

The three availability schedules equal `repro.data.availability`'s bit
for bit (rates 0, 0.5, 1). With an ``active`` mask, `mixing_matrix`,
`sparse_mixing_weights` and `count_neighbor_downloads` match `repro`'s
(integers exactly, weights within rtol 1e-6, atol 1e-7, as
tests/test_torch_graph.py), and the dense and sparse greedy select what
`repro`'s select. Whole `run_dpfl` runs under each availability model,
dense, sparse, top-k and on the Fig.-3 random graph, give `repro`'s
Omega, graphs, downloads, bytes and schedule, with accuracies within
atol 1e-6 and best_flat within rtol 1e-4, atol 1e-5
(tests/test_torch_dpfl.py's tolerances), and equal the port's own
`run_dpfl_reference` the same way. ``rate=1.0`` is the schedule-free
run bit for bit."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import CompressionConfig as JCompression  # noqa: E402
from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import run_dpfl as jrun  # noqa: E402
from repro.data import availability as javail  # noqa: E402

from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.dpfl import (DPFLConfig, run_dpfl,  # noqa: E402
                                   run_dpfl_reference)
from repro_torch.data import availability as tavail  # noqa: E402
from repro_torch.fl.compress import CompressionConfig  # noqa: E402
from test_torch_dpfl import (_assert_same_run, _engines,  # noqa: E402
                             _RewardLog)
from test_torch_graph import (_JP, _JREWARD, _JW, _N, _TP,  # noqa: E402
                              _treward, _TW)

# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("model", tavail.AVAILABILITY_MODELS)
def test_schedules_equal_repro(model, rate):
    cluster = np.array([0, 0, 1, 1, 2, 2, 2, 3])
    for seed in (0, 7):
        for burst in (1.0, 3.0):
            kw = dict(rate=rate, model=model, seed=seed, mean_burst=burst)
            want = javail.participation_schedule(
                javail.ParticipationConfig(**kw), 9, 8, cluster=cluster)
            got = tavail.participation_schedule(
                tavail.ParticipationConfig(**kw), 9, 8, cluster=cluster)
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want)
    if rate == 1.0:
        assert got.all()
    if rate == 0.0:
        assert not got.any()


# ------------------------------------------------------- masked weights


def _masked(seed, n=7):
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 0.5
    p = rng.random(n).astype(np.float32) + 0.1
    active = rng.random(n) < 0.6
    return adj, p, active


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_masked_mixing_matrix_matches_repro(seed):
    adj, p, active = _masked(seed)
    want = np.asarray(jgraph.mixing_matrix(jnp.asarray(adj), jnp.asarray(p),
                                           active=jnp.asarray(active)))
    got = tgraph.mixing_matrix(torch.from_numpy(adj), torch.from_numpy(p),
                               active=torch.from_numpy(active)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # an absent client's row is e_k
    for k in np.flatnonzero(~active):
        np.testing.assert_array_equal(got[k], np.eye(len(p))[k])
    # an all-ones mask changes no bit
    np.testing.assert_array_equal(
        tgraph.mixing_matrix(torch.from_numpy(adj), torch.from_numpy(p),
                             active=torch.ones(len(p), dtype=torch.bool)),
        tgraph.mixing_matrix(torch.from_numpy(adj), torch.from_numpy(p)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_masked_sparse_weights_and_downloads_match_repro(seed):
    adj, p, active = _masked(seed)
    jidx = jgraph.neighbors_from_adjacency(jnp.asarray(adj), 4)
    idx = torch.from_numpy(np.array(jidx))
    jact, tact = jnp.asarray(active), torch.from_numpy(active)
    for got, want in zip(
            tgraph.sparse_mixing_weights(idx, torch.from_numpy(p),
                                         active=tact),
            jgraph.sparse_mixing_weights(jidx, jnp.asarray(p),
                                         active=jact)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    for act in (None, tact):
        want = int(jgraph.count_neighbor_downloads(
            jidx, None if act is None else jact))
        got = tgraph.count_neighbor_downloads(idx, act)
        assert got.dtype == torch.int64 and int(got) == want
    # the list count equals the dense realized count
    from repro_torch.core.dpfl import _realized_downloads
    dense = tgraph.adjacency_from_neighbors(idx, len(p))
    assert int(_realized_downloads(dense, tact)) == \
        int(tgraph.count_neighbor_downloads(idx, tact))
    assert int(_realized_downloads(dense, None)) == \
        int(_realized_downloads(dense, torch.ones_like(tact)))


@pytest.mark.parametrize("budget", [1, 3])
@pytest.mark.parametrize("seed", [0, 5])
def test_masked_greedy_selects_what_repro_selects(budget, seed):
    """Dense: the refresh's candidates ``omega & active[None, :]``;
    sparse: ``active=`` inside the greedy. Both select `repro`'s graph,
    and each other's on the equivalent masks."""
    rng = np.random.default_rng(seed)
    cand = rng.random((_N, _N)) < 0.8
    active = rng.random(_N) < 0.6
    key = jax.random.PRNGKey(seed + 11)
    masked = cand & active[None, :]
    want_dense = np.asarray(jax.jit(lambda k: jgraph.all_clients_graph(
        k, _JW, _JP, jnp.asarray(masked), _JREWARD, budget))(key))
    got_dense = tgraph.all_clients_graph(
        common.key_to_torch(key), _TW, _TP, torch.from_numpy(masked),
        _treward, budget).numpy()
    np.testing.assert_array_equal(got_dense, want_dense)

    omega = jgraph.neighbors_from_adjacency(
        jnp.asarray(cand & ~np.eye(_N, dtype=bool)), _N - 1)
    want_sparse = np.asarray(jax.jit(
        lambda k: jgraph.all_clients_graph_sparse(
            k, _JW, _JP, omega, _JREWARD, budget,
            active=jnp.asarray(active)))(key))
    got_sparse = tgraph.all_clients_graph_sparse(
        common.key_to_torch(key), _TW, _TP, torch.from_numpy(np.array(omega)),
        _treward, budget, active=torch.from_numpy(active))
    np.testing.assert_array_equal(got_sparse.numpy(), want_sparse)
    # absent clients select nobody; available ones only available peers
    adj = tgraph.adjacency_from_neighbors(got_sparse, _N).numpy()
    assert not (adj & ~np.eye(_N, dtype=bool))[~active].any()
    assert not (adj & ~np.eye(_N, dtype=bool))[:, ~active].any()
    np.testing.assert_array_equal(adj[active], got_dense[active])


# ------------------------------------------------------------ whole runs

PART = {"bernoulli": dict(rate=0.6, model="bernoulli", seed=1),
        "markov": dict(rate=0.7, model="markov", mean_burst=2.0, seed=2),
        "cluster": dict(rate=0.6, model="cluster", seed=3)}
GRAPHS = {"dense": {}, "sparse": dict(graph_repr="sparse"),
          "topk": dict(compression="topk"),
          "random": dict(random_graph=True)}
RUN = dict(rounds=4, tau_init=2, tau_train=1, budget=3, seed=0)


def _configs(part, graph, **extra):
    g = dict(GRAPHS[graph])
    jg, tg = dict(g), dict(g)
    if "compression" in g:
        jg["compression"] = JCompression(g["compression"])
        tg["compression"] = CompressionConfig(g["compression"])
    jp = None if part is None else javail.ParticipationConfig(**part)
    tp = None if part is None else tavail.ParticipationConfig(**part)
    return (JConfig(**RUN, participation=jp, **jg, **extra),
            DPFLConfig(**RUN, participation=tp, **tg, **extra))


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("model", list(PART))
def test_participation_runs_match_repro_and_own_reference(model, graph):
    je, te = _engines("mlp")
    jcfg, tcfg = _configs(PART[model], graph)
    log = _RewardLog(te)
    try:
        want = jrun(je, jcfg)
        got = run_dpfl(te, tcfg)
        host = run_dpfl_reference(te, tcfg)
    finally:
        del te.make_reward_fn
    label = f"{model}/{graph}"
    _assert_same_run(want, got, RUN, log, f"{label}: port vs repro")
    _assert_same_run(got, host, RUN, log, f"{label}: engine vs reference")
    np.testing.assert_array_equal(got.participation, want.participation)
    np.testing.assert_array_equal(host.participation, want.participation)
    assert got.malicious is None
    part = got.participation
    assert 0 < part.sum() < part.size, "the schedule must drop someone"
    # an absent client keeps its previous C_k
    prev = got.omega
    for t, g in enumerate(got.graph_history):
        np.testing.assert_array_equal(g[~part[t]], prev[~part[t]])
        prev = g


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_rate_one_is_the_schedule_free_run_bitwise(graph):
    _, te = _engines("mlp")
    _, full = _configs(None, graph)
    _, ones = _configs(dict(rate=1.0, model="markov", seed=4), graph)
    a, b = run_dpfl(te, full), run_dpfl(te, ones)
    assert b.participation.all()
    assert a.comm_downloads == b.comm_downloads
    assert a.comm_bytes == b.comm_bytes
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.val_acc_history, b.val_acc_history):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.best_flat, b.best_flat)
    np.testing.assert_array_equal(a.test_acc, b.test_acc)


def test_nobody_available_moves_nothing():
    """rate=0: no client trains, refreshes or downloads; every model is
    the preprocessed one."""
    _, te = _engines("mlp")
    _, cfg = _configs(dict(rate=0.0, model="bernoulli"), "dense")
    res = run_dpfl(te, cfg)
    assert res.comm_downloads == [0] * RUN["rounds"]
    for g in res.graph_history:
        np.testing.assert_array_equal(g, res.omega)
