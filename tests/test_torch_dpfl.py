"""The whole slice: the port's `run_dpfl` against `repro`'s, from the same
init (carried across), on the small MLP setting of
tests/test_round_engine.py (refresh_period 1 and 2) and on a narrow
PaperCNN with 4 clients.

Integers are equal exactly: comm_downloads, comm_preprocess, comm_bytes,
Omega and every graph of the history. Accuracies agree within atol 1e-6
(as test_round_engine.py) and best_flat within rtol 1e-4, atol 1e-5. The
port's `run_dpfl` equals its own `run_dpfl_reference` the same way. When
a graph differs, the test prints the decision that split: round, client,
candidate, the gains a and b and the coin flip u."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import run_dpfl as jrun  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core.dpfl import (DPFLConfig, graph_stats,  # noqa: E402
                                   run_dpfl, run_dpfl_reference)
from repro_torch.fl.compress import CompressionConfig  # noqa: E402

SETTINGS = {
    "mlp-refresh1": ("mlp", dict(rounds=4, tau_init=2, tau_train=1,
                                 budget=3, seed=0, refresh_period=1)),
    "mlp-refresh2": ("mlp", dict(rounds=4, tau_init=2, tau_train=1,
                                 budget=3, seed=0, refresh_period=2)),
    "cnn": ("cnn", dict(rounds=2, tau_init=2, tau_train=1, budget=2,
                        seed=0)),
}
_ENGINES = {}


def _engines(kind):
    if kind not in _ENGINES:
        je, te = common.make_engines(kind)
        common.carry_init(je, te)
        _ENGINES[kind] = (je, te)
    return _ENGINES[kind]


class _RewardLog:
    """Records every reward call of the port's greedy (one call per
    candidate position, all clients at once) to explain a split."""

    def __init__(self, te):
        self.calls = []
        make = type(te).make_reward_fn.__get__(te)

        def make_logged():
            reward = make()

            def logged(probes, k_idx):
                r = reward(probes, k_idx)
                self.calls.append(r.clone())
                return r

            return logged

        te.make_reward_fn = make_logged


def _explain(graph_key, N, k, diff_cols, rewards):
    """The decisions of client k on the differing candidates."""
    key_k = prng.fold_in(graph_key, k)
    order = prng.permutation(prng.fold_in(key_k, 0), N).tolist()
    lines = []
    for j in diff_cols:
        s = order.index(j)
        r = rewards[s][k]
        a = max(float(r[1] - r[0]), 0.0)
        b = max(float(r[3] - r[2]), 0.0)
        u = float(prng.uniform(prng.fold_in(key_k, j + 1)))
        prob = a / (a + b) if a + b > 0 else 1.0
        lines.append(f"client {k} candidate {j} (position {s}): a={a!r} "
                     f"b={b!r} u={u!r} a/(a+b)={prob!r} "
                     f"|u-a/(a+b)|={abs(u - prob):.3g}")
    return lines


def _assert_same_graphs(want, got, cfg_kw, log, label):
    N = want.omega.shape[0]
    k_graph = prng.split(prng.PRNGKey(cfg_kw["seed"]), 4)[2]
    graphs = [("preprocess (BGGC Omega)", want.omega, got.omega, k_graph, 0)]
    refreshes = 0
    for t, (a, b) in enumerate(zip(want.graph_history, got.graph_history)):
        if t % cfg_kw.get("refresh_period", 1) == 0:
            refreshes += 1
            graphs.append((f"round {t}", a, b,
                           prng.fold_in(k_graph, 1000 + t), refreshes * N))
    for name, a, b, gkey, base in graphs:
        if np.array_equal(a, b):
            continue
        lines = [f"{label}: graphs differ at {name}"]
        for k in np.flatnonzero((a != b).any(axis=1)):
            cols = np.flatnonzero(a[k] != b[k]).tolist()
            lines += _explain(gkey, N, int(k), cols,
                              log.calls[base:base + N])
        print("\n".join(lines))
        pytest.fail("\n".join(lines))
    assert len(want.graph_history) == len(got.graph_history)


def _assert_same_run(want, got, cfg_kw, log, label):
    assert got.comm_downloads == want.comm_downloads, label
    assert got.comm_preprocess == want.comm_preprocess, label
    assert got.comm_bytes == want.comm_bytes, label
    assert got.comm_bytes_preprocess == want.comm_bytes_preprocess, label
    _assert_same_graphs(want, got, cfg_kw, log, label)
    for a, b in zip(want.val_acc_history, got.val_acc_history):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=label)
    np.testing.assert_allclose(want.test_acc, got.test_acc, atol=1e-6,
                               err_msg=label)
    np.testing.assert_allclose(want.best_flat, got.best_flat, rtol=1e-4,
                               atol=1e-5, err_msg=label)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_port_matches_repro_and_own_reference(setting):
    kind, cfg_kw = SETTINGS[setting]
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
    assert got.comm_preprocess == 2 * N * (N - 1)
    assert got.comm_bytes == [d * 4 * te.n_params
                              for d in got.comm_downloads]
    assert got.best_flat.shape == (N, te.n_params)


def test_naive_graph_impl_selects_what_ggc_selects():
    _, te = _engines("mlp")
    kw = dict(rounds=2, tau_init=1, tau_train=1, budget=2, seed=3)
    a = run_dpfl(te, DPFLConfig(**kw))
    b = run_dpfl(te, DPFLConfig(graph_impl="naive", **kw))
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    assert a.comm_downloads == b.comm_downloads
    stats = graph_stats(a)
    assert 0.0 <= stats["final_sparsity"] <= 1.0


@pytest.mark.parametrize("refresh_period", [1, 2])
def test_graph_mix_calls_per_run(monkeypatch, refresh_period):
    """K1 runs once per BGGC phase-1 batch, once for the preprocessing
    mix, and per round once per greedy init (refresh rounds) and once
    for the Eq.-4 mix: ceil(N/B) + 1 + refreshes + rounds calls, the
    count chip_smoke.py asserts on the card."""
    from repro_torch.core import graph as tgraph
    _, te = _engines("mlp")
    calls = []
    real = tgraph._kops.graph_mix

    def counted(A, W):
        calls.append((tuple(A.shape), tuple(W.shape)))
        return real(A, W)

    monkeypatch.setattr(tgraph._kops, "graph_mix", counted)
    rounds, budget = 4, 4
    run_dpfl(te, DPFLConfig(rounds=rounds, tau_init=1, tau_train=1,
                            budget=budget, seed=2,
                            refresh_period=refresh_period))
    N = te.data.n_clients
    refreshes = len(range(0, rounds, refresh_period))
    assert len(calls) == -(-N // budget) + 1 + refreshes + rounds
    # phase-1 batches are (N, b) @ (b, P); everything else is (N, N) @ (N, P)
    assert [a for a, _ in calls[:2]] == [(N, budget), (N, N - budget)]
    assert all(a == (N, N) for a, _ in calls[2:])


def test_history_flushes_every_k_rounds():
    _, te = _engines("mlp")
    kw = dict(rounds=3, tau_init=1, tau_train=1, budget=2, seed=1)
    a = run_dpfl(te, DPFLConfig(**kw))
    b = run_dpfl(te, DPFLConfig(history_every=2, **kw))
    assert len(b.graph_history) == len(b.val_acc_history) == 3
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.best_flat, b.best_flat)


@pytest.mark.parametrize("override", [
    dict(participation=object()),
    dict(compression=CompressionConfig("topk"), adversary=object()),
    dict(adversary=object()),
    dict(graph_repr="sparse", participation=object()),
    dict(mix_rule="trimmed"),
    dict(random_graph=True, mix_rule="clipped"),
    dict(graph_impl="other")], ids=lambda d: next(iter(d)))
def test_unported_settings_raise(override):
    """Settings still to port raise, alone or beside ported ones (the
    case ids name the first setting of each)."""
    _, te = _engines("mlp")
    for run in (run_dpfl, run_dpfl_reference):
        with pytest.raises(NotImplementedError):
            run(te, DPFLConfig(rounds=1, tau_init=1, tau_train=1, budget=2,
                               **override))


def test_engine_defaults_to_cuda():
    """No silent CPU fallback: the default device is cuda."""
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP
    _, te = _engines("mlp")
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    with pytest.raises((RuntimeError, AssertionError)):
        FLEngine(MLP(*common.SMALL_MLP), te.data)
