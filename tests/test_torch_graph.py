"""The port's graph builders against `repro`'s.

On the toy quadratic reward of tests/test_round_engine.py (its flat_w, p
and target carried across as numpy), the port's GGC, BGGC and the
literal Algorithm-2 oracle select exactly what `repro`'s select, for
budgets 1-5 and several seeds, and equal each other (Theorem 1 in the
port). `mixing_matrix` matches, with and without a participation mask,
and `all_clients_bggc` on the small MLP setting gives `repro`'s
Omega."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402

from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.interop import flat_from_jax  # noqa: E402

_N = 6


def _toy():
    # tests/test_round_engine.py::_toy, verbatim
    key = jax.random.PRNGKey(3)
    flat_w = jax.random.normal(key, (_N, 12))
    p = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (_N,))) + 0.1
    p = p / p.sum()
    target = jax.random.normal(jax.random.fold_in(key, 2), (12,))

    def reward(fw, k):
        return -jnp.sum((fw - target) ** 2) - 0.05 * k * jnp.sum(fw ** 2)

    return flat_w, p, target, reward


_JW, _JP, _TARGET, _JREWARD = _toy()
_TW = torch.from_numpy(np.array(_JW))
_TP = torch.from_numpy(np.array(_JP))
_TT = torch.from_numpy(np.array(_TARGET))


def _treward(fw, k):
    """The toy reward, batched: fw (K, Q, 12), k (K,) -> (K, Q)."""
    return -((fw - _TT) ** 2).sum(-1) - 0.05 * k[:, None] * (fw ** 2).sum(-1)


_JIT = {}


def _repro(name, budget):
    if (name, budget) not in _JIT:
        make = {"ggc": jgraph.make_ggc, "bggc": jgraph.make_bggc,
                "naive": jgraph.make_ggc_naive}[name]
        _JIT[name, budget] = jax.jit(make(_JREWARD, budget))
    return _JIT[name, budget]


@pytest.mark.parametrize("budget", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seed", [0, 17, 404])
def test_toy_selections_match_repro_and_each_other(budget, seed):
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(seed + 7), k)
             for k in range(_N)]
    rng = np.random.default_rng(seed)
    cand = rng.random((_N, _N)) < 0.8
    want = {}
    for name in ("ggc", "bggc", "naive"):
        want[name] = np.stack([
            np.asarray(_repro(name, budget)(
                jkeys[k], jnp.int32(k), jnp.asarray(cand[k]), _JW, _JP))
            for k in range(_N)])
    tkeys = common.key_to_torch(np.stack([np.asarray(k) for k in jkeys]))
    k_idx = torch.arange(_N)
    makers = {"ggc": tgraph.make_ggc, "bggc": tgraph.make_bggc,
              "naive": tgraph.make_ggc_naive}
    got = {name: make(_treward, budget)(tkeys, k_idx, torch.from_numpy(cand),
                                        _TW, _TP).numpy()
           for name, make in makers.items()}
    for name in makers:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # Theorem 1 inside the port
    np.testing.assert_array_equal(got["ggc"], got["naive"])
    np.testing.assert_array_equal(got["bggc"], got["naive"])
    off = got["ggc"] & ~np.eye(_N, dtype=bool)
    assert off.sum(1).max() <= budget and np.all(np.diag(got["ggc"]))


def test_all_clients_graph_matches_repro():
    key = jax.random.PRNGKey(21)
    cand = jnp.ones((_N, _N), bool)
    want = np.asarray(jax.jit(lambda k: jgraph.all_clients_graph(
        k, _JW, _JP, cand, _JREWARD, 3))(key))
    got = tgraph.all_clients_graph(common.key_to_torch(key), _TW, _TP,
                                   torch.ones((_N, _N), dtype=torch.bool),
                                   _treward, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixing_matrix_matches(seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((7, 7)) < 0.4
    p = rng.random(7).astype(np.float32)
    want = np.asarray(jgraph.mixing_matrix(jnp.asarray(adj), jnp.asarray(p)))
    got = tgraph.mixing_matrix(torch.from_numpy(adj), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(1).numpy(), np.ones(7), rtol=1e-6)


def test_mixing_matrix_participation_not_ported():
    """Named for the refusal it once asserted: with ``active`` the port's
    `mixing_matrix` and `eq4_weights_unnormalized` match `repro`'s
    (rtol 1e-6, atol 1e-7); an absent client keeps only its own
    weight."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        adj = rng.random((7, 7)) < 0.4
        p = rng.random(7).astype(np.float32)
        active = rng.random(7) < 0.6
        for name in ("mixing_matrix", "eq4_weights_unnormalized"):
            want = np.asarray(getattr(jgraph, name)(
                jnp.asarray(adj), jnp.asarray(p),
                active=jnp.asarray(active)))
            got = getattr(tgraph, name)(torch.from_numpy(adj),
                                        torch.from_numpy(p),
                                        active=torch.from_numpy(active))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_array_equal(got.numpy()[~active],
                                      np.diag(p)[~active])


def test_all_clients_bggc_matches_repro_on_small_mlp():
    je, te = common.make_engines("mlp")
    stacked = je.init_clients(jax.random.PRNGKey(0))
    stacked, _ = je.local_train(stacked, jax.random.PRNGKey(1), epochs=2)
    flat = je.flatten(stacked)
    N = flat.shape[0]
    key = jax.random.PRNGKey(4)
    for budget in (2, 3):
        want = np.asarray(jax.jit(lambda k, f: jgraph.all_clients_bggc(
            k, f, je.p, jnp.ones((N, N), bool), je.make_reward_fn(),
            budget))(key, flat))
        got = tgraph.all_clients_bggc(
            common.key_to_torch(key), flat_from_jax(np.asarray(flat), "cpu"),
            te.p, torch.ones((N, N), dtype=torch.bool), te.make_reward_fn(),
            budget)
        np.testing.assert_array_equal(got.numpy(), want)


def test_weighted_sum_is_batched_set_sum():
    mask_p = torch.from_numpy(
        np.random.default_rng(0).random((4, _N)).astype(np.float32))
    got = tgraph.weighted_sum(mask_p, _TW)
    np.testing.assert_allclose(got.numpy(), mask_p.numpy() @ _TW.numpy(),
                               rtol=1e-5, atol=1e-6)
