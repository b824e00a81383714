"""The paper's end-to-end claims on the port: tests/test_fl_e2e.py and
tests/test_paper_properties.py, each run through `repro_torch` on the
CPU, and §4.5's label-flip data (`make_label_flip_data`).

Every claim is asserted on the port's own run, from its own init (the
port's `prng` init is `repro`'s bit for bit). Where the run is
deterministic on the CPU (every DPFL run here), the same run of `repro`
is made too and the port must give its Omega, every round's graph and
every counter exactly; accuracies are fractions of counts and must agree
within atol 1e-6 (tests/test_round_engine.py's tolerance). The noisy-
reward GGC claim gives `repro`'s selections exactly and its reward
deltas within rtol 1e-5, atol 1e-5 (float32 sums of 30 terms).
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import run_dpfl as jrun_dpfl  # noqa: E402
from repro.data import make_federated_classification as jmake  # noqa: E402
from repro.data import make_label_flip_data as jflip  # noqa: E402
from repro.fl.baselines import run_baseline as jrun_baseline  # noqa: E402
from repro.fl.engine import FLEngine as JEngine  # noqa: E402
from repro.models.classifier import MLP as JMLP  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core import DPFLConfig, graph_stats, run_dpfl  # noqa: E402
from repro_torch.core.graph import make_ggc  # noqa: E402
from repro_torch.data import (make_federated_classification,  # noqa: E402
                              make_label_flip_data)
from repro_torch.fl.baselines import BASELINES, run_baseline  # noqa: E402
from repro_torch.fl.engine import FLEngine  # noqa: E402
from repro_torch.models.classifier import MLP  # noqa: E402

# tests/test_fl_e2e.py's setting
E2E_DATA = dict(seed=3, n_clients=8, n_clusters=2, partition="pathological",
                classes_per_client=3, feature_dim=16, n_train=16, n_val=24,
                n_test=48, noise=2.0, assign_level="cluster")
E2E_RUN = dict(rounds=8, tau_init=3, tau_train=3, budget=4, seed=0)
ENGINE = dict(lr=0.05, batch_size=8)
ACC_TOL = 1e-6


def _engines(jdata, tdata):
    """`repro`'s engine and the port's (CPU) on the same data."""
    return (JEngine(JMLP(16, 32, 10), jdata, **ENGINE),
            FLEngine(MLP(16, 32, 10), tdata, device=common.CPU, **ENGINE))


def _same_run(want, got):
    """The port's `DPFLResult` against `repro`'s: graphs and counters
    exactly, accuracies within ACC_TOL."""
    np.testing.assert_array_equal(want.omega, got.omega)
    assert len(want.graph_history) == len(got.graph_history)
    for t, (a, b) in enumerate(zip(want.graph_history, got.graph_history)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {t}")
    assert got.comm_downloads == want.comm_downloads
    assert got.comm_preprocess == want.comm_preprocess
    for a, b in zip(want.val_acc_history, got.val_acc_history):
        np.testing.assert_allclose(a, b, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(want.test_acc, got.test_acc, rtol=0,
                               atol=ACC_TOL)


def _both(je, te, **cfg):
    """(repro's result, the port's) of one DPFL configuration, the port's
    held to `repro`'s."""
    want, got = jrun_dpfl(je, JConfig(**cfg)), run_dpfl(te, DPFLConfig(**cfg))
    _same_run(want, got)
    return want, got


# ---- §4.5's label-flip data -----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_clients=8, n_malicious=3, feature_dim=16, n_train=24,
         n_val=24, n_test=24, noise=0.5),
    dict(seed=1),
    dict(seed=7, n_clients=5, n_malicious=1, n_classes=4, feature_dim=3,
         n_train=6, n_val=2, n_test=3),
    dict(seed=12, n_clients=12, n_malicious=6, n_classes=3, noise=2.0)],
    ids=["e2e", "defaults", "small", "half-malicious"])
def test_label_flip_data_equals_repro(kw):
    """`make_label_flip_data` is `repro`'s code, docstring aside, and
    draws `repro`'s arrays exactly."""
    from repro.data import synthetic as jsynthetic

    rel = Path("data") / "synthetic.py"
    ours = common._defs(common.ROOT / "src" / "repro_torch" / rel)
    theirs = common._defs(common.ROOT / "src" / "repro" / rel)
    assert ours["make_label_flip_data"] == theirs["make_label_flip_data"]
    a, b = jsynthetic.make_label_flip_data(**kw), make_label_flip_data(**kw)
    for name in ("train_x", "train_y", "val_x", "val_y", "test_x",
                 "test_y", "p", "cluster"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.n_classes == b.n_classes
    assert b.cluster.sum() == kw.get("n_malicious", 4)


# ---- tests/test_fl_e2e.py ---------------------------------------------------


@pytest.fixture(scope="module")
def e2e():
    """The e2e setting's engines and its DPFL run in both packages."""
    je, te = _engines(jmake(**E2E_DATA),
                      make_federated_classification(**E2E_DATA))
    want, got = _both(je, te, **E2E_RUN)
    return je, te, want, got


def test_dpfl_beats_local_and_fedavg(e2e):
    """DPFL > local - 0.01 and > FedAvg + 0.02 (mean test accuracy); the
    two baselines' accuracies are `repro`'s within ACC_TOL."""
    je, te, _, res = e2e
    runs = {}
    for name in ("local", "fedavg"):
        runs[name] = run_baseline(name, te, rounds=8, tau=3, seed=0)
        np.testing.assert_allclose(
            jrun_baseline(name, je, rounds=8, tau=3, seed=0)["test_acc"],
            runs[name]["test_acc"], rtol=0, atol=ACC_TOL)
    d = res.test_acc.mean()
    local, fedavg = (runs[n]["test_acc"].mean() for n in ("local", "fedavg"))
    assert d > local - 0.01, f"DPFL {d:.3f} vs local {local:.3f}"
    assert d > fedavg + 0.02, f"DPFL {d:.3f} vs fedavg {fedavg:.3f}"


def test_graph_aligns_with_clusters(e2e):
    _, te, _, res = e2e
    adj = res.graph_history[-1].astype(float)
    cl = te.data.cluster
    same = adj[cl[:, None] == cl[None, :]].mean()
    cross = adj[cl[:, None] != cl[None, :]].mean()
    assert same > cross + 0.2, (same, cross)


def test_graph_sparsifies_over_rounds(e2e):
    stats = graph_stats(e2e[3])
    assert stats["final_sparsity"] >= stats["initial_sparsity"] - 0.05


def test_budget_respected_every_round(e2e):
    for adj in e2e[3].graph_history:
        assert (adj.sum(1) - 1 <= E2E_RUN["budget"]).all()


def test_random_graph_underperforms_ggc(e2e):
    """Fig. 3: DPFL with GGC against a random collaboration graph."""
    je, te, _, res = e2e
    _, rnd = _both(je, te, **E2E_RUN, random_graph=True)
    assert res.test_acc.mean() >= rnd.test_acc.mean() - 0.02


def test_label_flip_segregation():
    """Fig. 4: benign clients stop selecting malicious ones (benign-to-
    benign edge rate above benign-to-malicious in the last graph); Omega
    and every round's graph are `repro`'s."""
    kw = dict(seed=0, n_clients=8, n_malicious=3, feature_dim=16,
              n_train=24, n_val=24, n_test=24, noise=0.5)
    data = make_label_flip_data(**kw)
    je, te = _engines(jflip(**kw), data)
    _, res = _both(je, te, rounds=6, tau_init=3, tau_train=3, budget=5,
                   seed=0)
    adj = res.graph_history[-1].astype(float)
    benign = data.cluster == 0
    mal = ~benign
    cross = adj[np.ix_(benign, mal)].mean()
    within = (adj[np.ix_(benign, benign)].sum() - benign.sum()) / \
        (benign.sum() * (benign.sum() - 1))
    assert within > cross, (within, cross)


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_runs(e2e, name):
    out = run_baseline(name, e2e[1], rounds=2, tau=1, seed=0)
    acc = out["test_acc"]
    assert acc.shape == (8,)
    assert np.isfinite(acc).all()
    assert (acc >= 0).all() and (acc <= 1).all()


def test_refresh_period_variants(e2e):
    """Table 3: a periodic GGC refresh keeps working."""
    je, te, _, _ = e2e
    _, res = _both(je, te, rounds=4, tau_init=2, tau_train=2, budget=4,
                   refresh_period=2, seed=0)
    assert np.isfinite(res.test_acc).all()


# ---- tests/test_paper_properties.py -----------------------------------------


def test_ggc_noisy_reward_no_worse_than_empty_set():
    """Remark 3: with a noisy reward oracle the selected set's true reward
    is on average no worse than the empty set's. The noise is `repro`'s
    (a jax.random normal keyed by the probe's rounded sum; `prng` draws
    the same bits), the port's GGC runs batched over one client, and each
    trial's selection is `repro`'s exactly."""
    from repro.core.graph import make_ggc as jmake_ggc

    key = jax.random.PRNGKey(0)
    N, P = 8, 30
    jflat = jax.random.normal(key, (N, P))
    jp = jnp.full((N,), 1.0 / N)
    jtarget = jax.random.normal(jax.random.PRNGKey(1), (P,))
    flat_w = torch.from_numpy(np.array(jflat))
    p = torch.from_numpy(np.array(jp))
    target = torch.from_numpy(np.array(jtarget))

    def jtrue(fw, k):
        return -jnp.sum((fw - jtarget) ** 2)

    def true_reward(fw):
        return -((fw - target) ** 2).sum(-1)

    deltas, jdeltas = [], []
    for trial in range(20):
        jnoise_key = jax.random.fold_in(jax.random.PRNGKey(2), trial)
        noise_key = prng.fold_in(prng.PRNGKey(2), trial)

        def jnoisy(fw, k):
            n = jax.random.normal(jax.random.fold_in(jnoise_key, jnp.sum(
                (fw * 1e3).astype(jnp.int32)) % 1000)) * 2.0
            return jtrue(fw, k) + n

        def noisy(fw, k_idx):
            # fw (K, Q, P) -> (K, Q), one noise draw a probe
            s = (fw * 1e3).to(torch.int32).sum(-1, dtype=torch.int32) % 1000
            n = prng.normal(prng.fold_in(noise_key, s.long())) * 2.0
            return true_reward(fw) + n

        k = trial % N
        jmask = np.asarray(jmake_ggc(jnoisy, budget=4)(
            jax.random.fold_in(key, trial), jnp.int32(k), jnp.ones(N, bool),
            jflat, jp))
        mask = make_ggc(noisy, budget=4)(
            common.key_to_torch(jax.random.fold_in(key, trial))[None],
            torch.tensor([k]), torch.ones((1, N), dtype=torch.bool),
            flat_w, p)[0]
        np.testing.assert_array_equal(mask.numpy(), jmask,
                                      err_msg=f"trial {trial}")
        m = mask.float()
        avg = torch.einsum("n,np->p", m * p, flat_w) / torch.sum(m * p)
        deltas.append(float(true_reward(avg) - true_reward(flat_w[k])))
        jm = jnp.asarray(jmask, jnp.float32)
        javg = jnp.einsum("n,np->p", jm * jp, jflat) / jnp.sum(jm * jp)
        jdeltas.append(float(jtrue(javg, k) - jtrue(jflat[k], k)))
    np.testing.assert_allclose(deltas, jdeltas, rtol=1e-5, atol=1e-5)
    # robust-selection guarantee holds on average despite reward noise
    assert np.mean(deltas) > -1e-3, np.mean(deltas)


def test_communication_accounting_respects_budget():
    """Models downloaded (the paper's efficiency unit): at most N * B a
    round, a longer refresh period never downloads more, and BGGC's
    preprocessing streams every peer in both phases: 2N(N - 1)."""
    kw = dict(seed=1, n_clients=6, n_clusters=2, partition="pathological",
              classes_per_client=3, feature_dim=16, n_train=16, n_val=16,
              n_test=16, noise=2.0, assign_level="cluster")
    je, te = _engines(jmake(**kw), make_federated_classification(**kw))
    budget = 3
    run = dict(rounds=4, tau_init=2, tau_train=2, budget=budget, seed=0)
    _, res_p1 = _both(je, te, **run, refresh_period=1)
    _, res_p2 = _both(je, te, **run, refresh_period=2)
    for d in res_p1.comm_downloads:
        assert d <= 6 * budget
    assert sum(res_p2.comm_downloads) <= sum(res_p1.comm_downloads)
    assert res_p1.comm_preprocess == 2 * 6 * 5


def test_data_rich_client_is_sink_not_source():
    """§1: a data-rich client (0, with 8x the distinct samples and weight
    0.6) is pulled by others more than it pulls them."""
    def starve(base):
        tx, ty = base.train_x.copy(), base.train_y.copy()
        for i in range(1, 6):
            tx[i] = np.resize(tx[i, :12], tx[i].shape)
            ty[i] = np.resize(ty[i, :12], ty[i].shape)
        base.train_x, base.train_y = tx, ty
        base.p = np.array([0.6] + [0.08] * 5)
        return base

    kw = dict(seed=7, n_clients=6, n_clusters=1, partition="iid",
              feature_dim=16, n_train=96, n_val=24, n_test=24, noise=1.5)
    je, te = _engines(starve(jmake(**kw)),
                      starve(make_federated_classification(**kw)))
    _, res = _both(je, te, rounds=5, tau_init=3, tau_train=2, budget=4,
                   seed=0)
    adj = res.graph_history[-1].astype(float)
    np.fill_diagonal(adj, 0)
    provides = adj[:, 0].sum()   # others pulling client 0's model
    consumes = adj[0, :].sum()   # client 0 pulling others
    assert provides >= consumes, (provides, consumes)
