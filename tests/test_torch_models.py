"""The port's classifiers and SGD against `repro`'s on the same weights
(carried across with `repro_torch.interop`): logits, loss, gradients and
one SGD step, for the MLP and a narrow PaperCNN, batched over a leading
model axis (rtol 1e-5, atol 1e-6). The PaperCNN case covers the NHWC
flatten before fc1 (repro/models/classifier.py:59)."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models import classifier as jcls  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import classifier as tcls  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
G, B = 3, 5   # models, batch per model


def _models(kind):
    if kind == "mlp":
        return jcls.MLP(*common.SMALL_MLP), tcls.MLP(*common.SMALL_MLP), \
            (common.SMALL_MLP[0],)
    cfg = common.NARROW_CNN
    return (jcls.PaperCNN(JCNNConfig(**cfg)), tcls.PaperCNN(CNNConfig(**cfg)),
            (cfg["image_size"], cfg["image_size"], 3))


def _setup(kind, seed=0):
    jm, tm, xshape = _models(kind)
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    jparams = jax.vmap(jm.init)(keys)          # (G, ...) leaves
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, B) + xshape).astype(np.float32)
    y = rng.integers(0, 10, (G, B)).astype(np.int32)
    tparams = params_from_jax(common.np_tree(jparams), device="cpu")
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    return jm, tm, jparams, tparams, x, y, tbatch


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_logits_loss_accuracy(kind):
    jm, tm, jp, tp, x, y, tb = _setup(kind)
    _close(jax.vmap(jm.logits)(jp, x), tm.logits(tp, tb["x"]))
    jloss = jax.vmap(lambda p, xx, yy: jcls.xent_loss(
        jm, p, {"x": xx, "y": yy}))(jp, x, y)
    _close(jloss, tcls.xent_loss(tm, tp, tb))
    jacc = jax.vmap(lambda p, xx, yy: jcls.accuracy(
        jm, p, {"x": xx, "y": yy}))(jp, x, y)
    np.testing.assert_array_equal(np.asarray(jacc),
                                  tcls.accuracy(tm, tp, tb).numpy())


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_gradients_and_one_sgd_step(kind):
    jm, tm, jp, tp, x, y, tb = _setup(kind, seed=1)

    def one(p, xx, yy):
        return jcls.xent_loss(jm, p, {"x": xx, "y": yy})

    jgrads = jax.vmap(jax.grad(one))(jp, x, y)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tcls.xent_loss(tm, leaves, tb)
    tgrads = dict(zip(leaves, torch.autograd.grad(loss.sum(),
                                                  list(leaves.values()))))
    for k in tp:
        _close(jgrads[k], tgrads[k])

    jopt, topt = jsgd(0.05, momentum=0.9, weight_decay=1e-3), \
        tsgd(0.05, momentum=0.9, weight_decay=1e-3)
    jupd, _ = jopt.update(jgrads, jopt.init(jp), jp)
    tupd, tstate = topt.update(tgrads, topt.init(tp), tp)
    assert tstate["count"] == 1
    for k in tp:
        _close(jp[k] + jupd[k], tp[k] + tupd[k])


def test_sgd_nesterov_matches():
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((2, 5)).astype(np.float32)}
    g = {"w": rng.standard_normal((2, 5)).astype(np.float32)}
    jopt = jsgd(0.1, momentum=0.5, weight_decay=0.01, nesterov=True)
    topt = tsgd(0.1, momentum=0.5, weight_decay=0.01, nesterov=True)
    js, ts = jopt.init({"w": jnp.asarray(p["w"])}), \
        topt.init({"w": torch.from_numpy(p["w"])})
    for _ in range(3):
        ju, js = jopt.update({"w": jnp.asarray(g["w"])}, js,
                             {"w": jnp.asarray(p["w"])})
        tu, ts = topt.update({"w": torch.from_numpy(g["w"])}, ts,
                             {"w": torch.from_numpy(p["w"])})
        _close(ju["w"], tu["w"])


def test_flat_layout_is_ravel_pytree_order():
    """Sorted keys, JAX layouts: the port's flatten is ravel_pytree."""
    from jax.flatten_util import ravel_pytree

    je, te = common.make_engines("cnn")
    jp = je.model.init(jax.random.PRNGKey(2))
    tp = params_from_jax(common.np_tree(jp), device="cpu")
    stacked = {k: v[None] for k, v in tp.items()}
    np.testing.assert_array_equal(np.asarray(ravel_pytree(jp)[0]),
                                  te.flatten(stacked)[0].numpy())
    back = te.unflatten(te.flatten(stacked))
    for k in tp:
        np.testing.assert_array_equal(back[k].numpy(), stacked[k].numpy())


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_init_matches_within_ulps(kind):
    """The port's own init uses its normal sampler (erfinv): same shapes
    and keys, values equal to float32 noise."""
    jm, tm, _ = _models(kind)
    jp = jm.init(jax.random.PRNGKey(5))
    tp = tm.init(prng.PRNGKey(5))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape)
        np.testing.assert_allclose(np.asarray(jp[k]), tp[k].numpy(),
                                   rtol=1e-5, atol=2e-6)
