"""The port's FLEngine against `repro`'s from the same flat rows and key:
tau epochs of local SGD (same minibatch orders through the bitwise
PRNG; rows within rtol 1e-4, atol 1e-5, since summation order compounds
over the steps), validation and test metrics, and the GGC reward."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.interop import flat_from_jax  # noqa: E402


@pytest.fixture(scope="module", params=["mlp", "cnn"])
def engines(request):
    return common.make_engines(request.param)


def _start(je, seed=0):
    """Distinct per-client rows: the shared init plus per-client noise."""
    stacked = je.init_clients(jax.random.PRNGKey(seed))
    flat = np.asarray(je.flatten(stacked))
    rng = np.random.default_rng(seed)
    return (flat + 0.01 * rng.standard_normal(flat.shape)).astype(np.float32)


@pytest.mark.parametrize("epochs", [1, 3])
def test_local_train_matches(engines, epochs):
    je, te = engines
    flat0 = _start(je)
    key = jax.random.PRNGKey(11)
    jst, jloss = je.local_train(je.unflatten(jnp.asarray(flat0)), key,
                                epochs=epochs)
    tst, tloss = te.local_train(te.unflatten(flat_from_jax(flat0, "cpu")),
                                common.key_to_torch(key), epochs=epochs)
    np.testing.assert_allclose(np.asarray(je.flatten(jst)),
                               te.flatten(tst).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jloss), tloss.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_eval_matches(engines):
    je, te = engines
    flat0 = _start(je, seed=1)
    jst = je.unflatten(jnp.asarray(flat0))
    tst = te.unflatten(flat_from_jax(flat0, "cpu"))
    for jfn, tfn in ((je.eval_val, te.eval_val),
                     (je.eval_test, te.eval_test)):
        jacc, jl = jfn(jst)
        tacc, tl = tfn(tst)
        np.testing.assert_allclose(np.asarray(jacc), tacc.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_reward_matches(engines):
    """The port's batched reward (K clients x Q probes in one forward)
    equals `repro`'s per-(probe, client) reward."""
    je, te = engines
    flat0 = _start(je, seed=2)
    N = flat0.shape[0]
    jr = jax.jit(je.make_reward_fn())
    k_idx = np.array([0, N - 1, 1])
    probes = np.stack([flat0[[(k + q) % N for q in range(3)]]
                       for k in k_idx])                 # (K, Q, P)
    want = np.array([[float(jr(jnp.asarray(probes[i, q]), int(k)))
                      for q in range(3)] for i, k in enumerate(k_idx)])
    got = te.make_reward_fn()(torch.from_numpy(probes),
                              torch.from_numpy(k_idx))
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-5, atol=1e-6)


def test_init_clients_shares_one_init(engines):
    _, te = engines
    from repro_torch import prng
    st = te.init_clients(prng.PRNGKey(0))
    flat = te.flatten(st)
    assert flat.shape == (te.data.n_clients, te.n_params)
    assert torch.equal(flat, flat[:1].expand_as(flat))
