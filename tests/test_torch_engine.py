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


def test_eval_under_a_custom_acc_fn_matches_repro(engines):
    """``FLEngine(acc_fn=...)``: `eval_val` and `eval_test` report the
    given accuracy (`repro`'s one-client function vmapped by its engine,
    the port's client-stacked one), within 1e-6 of `repro`'s."""
    from repro.fl.engine import FLEngine as JEngine

    from repro_torch.fl.engine import FLEngine

    je0, te0 = engines
    jm, tm = je0.model, te0.model

    def jacc(p, b):
        probs = jax.nn.softmax(jm.logits(p, b["x"]).astype(jnp.float32))
        return jnp.take_along_axis(probs, b["y"][:, None], -1).mean()

    def tacc(p, b):
        probs = torch.softmax(tm.logits(p, b["x"]).float(), dim=-1)
        return torch.gather(probs, -1, b["y"][..., None])[..., 0].mean(-1)

    je = JEngine(jm, je0.data, lr=0.05, batch_size=8, acc_fn=jacc)
    te = FLEngine(tm, te0.data, lr=0.05, batch_size=8, acc_fn=tacc,
                  device=common.CPU)
    flat0 = _start(je0, seed=3)
    jst = je.unflatten(jnp.asarray(flat0))
    tst = te.unflatten(flat_from_jax(flat0, "cpu"))
    for jfn, tfn, dfn in ((je.eval_val, te.eval_val, te0.eval_val),
                          (je.eval_test, te.eval_test, te0.eval_test)):
        (jacc_v, jl), (tacc_v, tl) = jfn(jst), tfn(tst)
        np.testing.assert_allclose(np.asarray(jacc_v), tacc_v.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-5,
                                   atol=1e-6)
        # the default is the classifier's accuracy, which this is not
        assert not torch.equal(tacc_v, dfn(tst)[0])


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_data_keeps_integer_dtype(dtype):
    """Token ids reach the device as int64 (`repro` keeps the array's
    dtype; `F.embedding` takes no floats), features as float32."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    data = make_federated_classification(**common.SMALL_DATA)
    for name in ("train_x", "val_x", "test_x"):
        setattr(data, name, getattr(data, name).astype(dtype))
    te = FLEngine(MLP(*common.SMALL_MLP), data, device=common.CPU)
    want = torch.int64 if dtype.startswith("int") else torch.float32
    for x, y in (te.train_data, te.val_data, te.test_data):
        assert x.dtype == want and y.dtype == torch.int64


def test_flat_layout_is_read_without_a_cpu_draw():
    """The flat layout of a module comes from its own state dict (a
    "meta"-built `DecoderLM` keeps its "meta" weights: `init` would
    re-point them), and a classifier's init is drawn from a key on the
    engine's device; the layout is the same as from a drawn init."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models import build_model
    from repro_torch.models.classifier import MLP

    data = make_federated_classification(**common.SMALL_DATA)
    cfg = get_config("qwen3-0.6b").reduced()
    lm = build_model(cfg, device="meta", remat="none")
    te = FLEngine(lm, data, device=common.CPU)
    assert all(p.device.type == "meta" for p in lm.parameters())
    drawn = build_model(cfg, device="meta").init(prng.PRNGKey(0))
    assert te._keys == sorted(drawn)
    assert te.n_params == sum(v.numel() for v in drawn.values())

    devices = []
    mlp = MLP(*common.SMALL_MLP)
    init = mlp.init

    def recording(key):
        devices.append(key.device.type)
        return init(key)
    mlp.init = recording
    FLEngine(mlp, data, device="meta")
    assert devices == ["meta"]
