"""Adversarial clients in the port against `repro.fl.adversary`.

The host schedules (malicious set, attack schedule, label derangement)
and `edge_rates` equal `repro`'s exactly; `poison_update` bit for bit;
`wire_view` bit for bit at noise_scale 1 and 0 (the port's
``prng.normal`` is ``jax.random.normal``'s bits). The label-flip
local train matches `repro`'s ``local_train_with_labels`` within rtol
1e-4, atol 1e-5 (tests/test_torch_engine.py's tolerance). Whole runs of
each attack under each mix rule give `repro`'s Omega, graphs, downloads
and malicious set, with tests/test_torch_dpfl.py's tolerances on the
models (free riding at noise_scale 0 and, dense and sparse, at 1.0),
and equal the port's `run_dpfl_reference`.
``fraction=0.0`` is the adversary-free run bit for bit."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import run_dpfl as jrun  # noqa: E402
from repro.data import ParticipationConfig as JPart  # noqa: E402
from repro.fl import adversary as jadv  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core.dpfl import (DPFLConfig, run_dpfl,  # noqa: E402
                                   run_dpfl_reference)
from repro_torch.data import ParticipationConfig  # noqa: E402
from repro_torch.fl import adversary as tadv  # noqa: E402
from repro_torch.interop import flat_from_jax  # noqa: E402
from test_torch_dpfl import (_assert_same_run, _engines,  # noqa: E402
                             _RewardLog)


def _cfgs(attack, **kw):
    return jadv.AdversaryConfig(attack, **kw), tadv.AdversaryConfig(attack,
                                                                    **kw)


# ------------------------------------------------------------ host side


@pytest.mark.parametrize("round_prob", [1.0, 0.5])
@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5, 1.0])
def test_host_schedules_equal_repro(fraction, round_prob):
    for seed in (0, 3):
        j, t = _cfgs("sign_flip", fraction=fraction, seed=seed,
                     round_prob=round_prob)
        for n in (6, 32):
            assert tadv.n_malicious(t, n) == jadv.n_malicious(j, n)
            np.testing.assert_array_equal(tadv.malicious_mask(t, n),
                                          jadv.malicious_mask(j, n))
            np.testing.assert_array_equal(tadv.attack_schedule(t, 5, n),
                                          jadv.attack_schedule(j, 5, n))
        for classes in (2, 10):
            np.testing.assert_array_equal(tadv.label_permutation(t, classes),
                                          jadv.label_permutation(j, classes))
    np.testing.assert_array_equal(tadv.adv_base_key(7).numpy(),
                                  np.asarray(jadv.adv_base_key(7)))


def test_edge_rates_equal_repro():
    rng = np.random.default_rng(0)
    mal = rng.random(9) < 0.3
    hist = [rng.random((9, 9)) < 0.4 for _ in range(3)]
    assert tadv.segregation_history(hist, mal) == \
        jadv.segregation_history(hist, mal)
    for m in (np.zeros(9, bool), np.ones(9, bool)):
        assert tadv.edge_rates(hist[0], m) == jadv.edge_rates(hist[0], m)


# -------------------------------------------------------- in-round side


def _panel(seed, n=6, p=11):
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((n, p)).astype(np.float32)
    prev = rng.standard_normal((n, p)).astype(np.float32)
    row = rng.random(n) < 0.5
    return flat, prev, row


@pytest.mark.parametrize("attack", tadv.ATTACKS)
def test_poison_update_bitwise(attack):
    j, t = _cfgs(attack, fraction=0.5, scale=3.7)
    for seed in range(3):
        flat, prev, row = _panel(seed)
        want = np.asarray(jadv.poison_update(
            j, jnp.asarray(flat), jnp.asarray(prev), jnp.asarray(row)))
        got = tadv.poison_update(t, torch.from_numpy(flat),
                                 torch.from_numpy(prev),
                                 torch.from_numpy(row)).numpy()
        np.testing.assert_array_equal(got, want)
        # an all-False row is the identity
        np.testing.assert_array_equal(
            tadv.poison_update(t, torch.from_numpy(flat),
                               torch.from_numpy(prev),
                               torch.zeros(len(row), dtype=torch.bool)),
            flat)


@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_wire_view_matches_repro(noise_scale):
    j, t = _cfgs("free_rider", fraction=0.5, noise_scale=noise_scale)
    flat, _, row = _panel(4)
    for rnd in (0, 5):
        want = np.asarray(jadv.wire_view(j, jnp.asarray(flat),
                                         jnp.asarray(row),
                                         jadv.adv_base_key(2), rnd))
        got = tadv.wire_view(t, torch.from_numpy(flat), torch.from_numpy(row),
                             tadv.adv_base_key(2), rnd).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[~row], flat[~row])
    assert tadv.free_rider_active(t)
    assert not tadv.free_rider_active(tadv.AdversaryConfig("free_rider"))
    assert not tadv.free_rider_active(None)


def test_label_flip_local_train_matches_repro():
    je, te = common.make_engines("mlp")
    j, t = _cfgs("label_flip", fraction=0.5, seed=1)
    N = te.data.n_clients
    stacked = je.init_clients(jax.random.PRNGKey(0))
    flat0 = np.asarray(je.flatten(stacked))
    key = jax.random.PRNGKey(3)
    sched = jadv.attack_schedule(j, 2, N)
    perm = jadv.label_permutation(j, te.data.n_classes)
    ys = np.where(sched[1][:, None], perm[np.asarray(je.train_data[1])],
                  np.asarray(je.train_data[1]))
    jst, _ = je.local_train_with_labels(je.unflatten(jnp.asarray(flat0)),
                                        key, epochs=2, ys=jnp.asarray(ys))
    hook = tadv.make_adv_local_train(te, t)
    aux = {"adv": {"sched": torch.from_numpy(tadv.attack_schedule(t, 2, N))}}
    tst, _ = hook(te.unflatten(flat_from_jax(flat0, "cpu")),
                  common.key_to_torch(key), 2, aux=aux, t=1)
    np.testing.assert_allclose(te.flatten(tst).numpy(),
                               np.asarray(je.flatten(jst)), rtol=1e-4,
                               atol=1e-5)
    # no attacker this round: exactly the clean local train
    aux["adv"]["sched"][0] = False
    a, _ = hook(te.unflatten(flat_from_jax(flat0, "cpu")),
                common.key_to_torch(key), 2, aux=aux, t=0)
    b, _ = te.local_train(te.unflatten(flat_from_jax(flat0, "cpu")),
                          common.key_to_torch(key), epochs=2)
    np.testing.assert_array_equal(te.flatten(a).numpy(),
                                  te.flatten(b).numpy())
    assert tadv.make_adv_local_train(te, tadv.AdversaryConfig("sign_flip")) \
        is None
    assert tadv.make_post_train(t) is None


# ------------------------------------------------------------ whole runs

RUN = dict(rounds=3, tau_init=2, tau_train=1, budget=3, seed=0)
# Free riders upload their round-start rows. Two of them with equal Omega
# rows upload the same model up to an ulp, and the greedy's gains between
# them are fp noise (|a|, |b| ~ 1e-8): `repro`'s own dense and sparse
# paths split on such a tie (adversary seed 2, markov participation, the
# sparse case below). Seed 0 makes clients 3 and 4 the free riders, one
# in each cluster of the small setting, so no tie decides a graph.
ATTACK_KW = {"label_flip": dict(seed=1), "grad_scale": dict(seed=1, scale=4.0),
             "sign_flip": dict(seed=1),
             "free_rider": dict(seed=0, noise_scale=0.0)}
RULES = {"weighted": {}, "trimmed": dict(trim_frac=0.2),
         "clipped": dict(clip_mult=1.0)}


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("attack", list(ATTACK_KW))
def test_attack_runs_match_repro_and_own_reference(attack, rule):
    """Dense runs of every attack under every rule; the sparse runs
    below cover the neighbor-list aggregate."""
    je, te = _engines("mlp")
    j, t = _cfgs(attack, fraction=0.34, **ATTACK_KW[attack])
    kw = dict(RUN, mix_rule=rule, **RULES[rule])
    log = _RewardLog(te)
    try:
        want = jrun(je, JConfig(**kw, adversary=j))
        got = run_dpfl(te, DPFLConfig(**kw, adversary=t))
        host = run_dpfl_reference(te, DPFLConfig(**kw, adversary=t))
    finally:
        del te.make_reward_fn
    label = f"{attack}/{rule}"
    _assert_same_run(want, got, kw, log, f"{label}: port vs repro")
    _assert_same_run(got, host, kw, log, f"{label}: engine vs reference")
    np.testing.assert_array_equal(got.malicious, want.malicious)
    assert got.malicious.sum() == 2


@pytest.mark.parametrize("setting", [
    ("sign_flip", "clipped", "bernoulli"), ("label_flip", "trimmed", None),
    ("free_rider", "weighted", "markov"), ("grad_scale", "trimmed",
                                           "cluster")],
    ids=lambda s: "-".join(x or "full" for x in s))
def test_sparse_attack_runs_match_repro(setting):
    """The neighbor-list aggregate under attacks, rules and participation:
    `mix_flat_sparse` with the wire table as ``peers``, clipped list
    weights, the trimmed (N, B+1, P) panel."""
    attack, rule, model = setting
    je, te = _engines("mlp")
    j, t = _cfgs(attack, fraction=0.34, **ATTACK_KW[attack])
    kw = dict(RUN, mix_rule=rule, graph_repr="sparse", **RULES[rule])
    jp = tp = None
    if model is not None:
        part = dict(rate=0.7, model=model, seed=5)
        jp, tp = JPart(**part), ParticipationConfig(**part)
    log = _RewardLog(te)
    try:
        want = jrun(je, JConfig(**kw, adversary=j, participation=jp))
        got = run_dpfl(te, DPFLConfig(**kw, adversary=t, participation=tp))
        host = run_dpfl_reference(te, DPFLConfig(**kw, adversary=t,
                                                 participation=tp))
    finally:
        del te.make_reward_fn
    _assert_same_run(want, got, kw, log, f"{setting}: port vs repro")
    _assert_same_run(got, host, kw, log, f"{setting}: engine vs reference")
    np.testing.assert_array_equal(got.malicious, want.malicious)
    if model is not None:
        np.testing.assert_array_equal(got.participation, want.participation)


@pytest.mark.parametrize("graph_repr", ["dense", "sparse"])
def test_noisy_free_rider_matches_repro(graph_repr):
    """noise_scale 1, whole runs: the noise is ``jax.random.normal``'s
    bits, so the port gives `repro`'s Omega, graphs, downloads and
    malicious set, with the models within tests/test_torch_dpfl.py's
    tolerances."""
    je, te = _engines("mlp")
    j, t = _cfgs("free_rider", fraction=0.5, seed=3, noise_scale=1.0)
    kw = dict(RUN, graph_repr=graph_repr)
    log = _RewardLog(te)
    try:
        want = jrun(je, JConfig(**kw, adversary=j))
        got = run_dpfl(te, DPFLConfig(**kw, adversary=t))
    finally:
        del te.make_reward_fn
    _assert_same_run(want, got, kw, log, f"{graph_repr}: port vs repro")
    np.testing.assert_array_equal(got.malicious, want.malicious)


@pytest.mark.parametrize("graph_repr", ["dense", "sparse"])
def test_noisy_free_rider_invariants(graph_repr):
    """noise_scale 1: engine equals reference, graphs stay in Omega
    within the budget, the malicious set is `repro`'s."""
    _, te = _engines("mlp")
    j, t = _cfgs("free_rider", fraction=0.5, seed=3, noise_scale=1.0)
    kw = dict(RUN, graph_repr=graph_repr, adversary=t)
    got = run_dpfl(te, DPFLConfig(**kw))
    host = run_dpfl_reference(te, DPFLConfig(**kw))
    assert got.comm_downloads == host.comm_downloads
    for a, b in zip(got.graph_history, host.graph_history):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.best_flat, host.best_flat, rtol=1e-4,
                               atol=1e-5)
    N = te.data.n_clients
    np.testing.assert_array_equal(got.malicious, jadv.malicious_mask(j, N))
    for g in got.graph_history:
        assert not (g & ~got.omega).any()
        assert (g & ~np.eye(N, dtype=bool)).sum(1).max() <= RUN["budget"]
    assert np.isfinite(got.best_flat).all()


@pytest.mark.parametrize("attack", list(ATTACK_KW))
def test_fraction_zero_is_the_adversary_free_run_bitwise(attack):
    _, te = _engines("mlp")
    a = run_dpfl(te, DPFLConfig(**RUN))
    b = run_dpfl(te, DPFLConfig(**RUN, adversary=tadv.AdversaryConfig(
        attack, fraction=0.0, **ATTACK_KW[attack])))
    assert not b.malicious.any()
    assert a.comm_downloads == b.comm_downloads
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.val_acc_history, b.val_acc_history):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.best_flat, b.best_flat)


def test_adversary_key_is_its_own_stream():
    """fold_in(PRNGKey(seed), 1013): apart from the graph and codec
    streams of the same seed."""
    key = tadv.adv_base_key(0)
    assert not torch.equal(key, prng.fold_in(prng.PRNGKey(0), 977))
    assert torch.equal(key, prng.fold_in(prng.PRNGKey(0), 1013))
