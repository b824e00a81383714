"""The port's checkpoints (`repro_torch.checkpoint`): the three tests of
tests/test_checkpoint.py on trees of tensors, and the file format across
the packages: the port's files load with `repro.checkpoint.load_pytree`
and `repro`'s with the port's, bit for bit; the JSON lists the same keys
and the same structure string as `repro` writes."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_pytree, save_pytree)
from repro_torch.checkpoint.ckpt import _items  # noqa: E402


def _tree(seed=0):
    k = prng.PRNGKey(seed)
    return {"a": prng.normal(k, (4, 5)),
            "nested": {"b": torch.arange(3, dtype=torch.int32),
                       "c": [torch.ones(2), torch.zeros((1, 1))]}}


def _jtree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"a": jax.random.normal(k, (4, 5)),
            "nested": {"b": jnp.arange(3, dtype=jnp.int32),
                       "c": [jnp.ones(2), jnp.zeros((1, 1))]}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def _leaves(tree):
    return [v for _, v in _items(tree)]


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path / "x"), t, {"note": "hi"})
    t2 = load_pytree(str(tmp_path / "x"), _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_shape_mismatch_raises(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path / "x"), t)
    bad = {"a": torch.zeros(4, 5, 1), "nested": _zeros_like(t["nested"])}
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "x"), bad)
    with pytest.raises(ValueError, match="missing"):
        load_pytree(str(tmp_path / "x"), {"a": t["a"]})


def test_manager_best_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    assert mgr.restore_best(_zeros_like(t)) is None
    assert mgr.restore_latest(_zeros_like(t)) == (None, None)
    assert mgr.keep_best(0.5, t)
    assert not mgr.keep_best(0.4, t)       # worse metric rejected
    assert mgr.keep_best(0.9, _tree(1))
    best = mgr.restore_best(_zeros_like(t))
    assert torch.equal(best["a"], _tree(1)["a"])
    for s in range(5):
        mgr.save_step(s, t)
    assert mgr.latest_step() == 4
    s, t2 = mgr.restore_latest(_zeros_like(t))
    assert s == 4 and torch.equal(t2["a"], t["a"])
    steps = [f for f in os.listdir(str(tmp_path)) if f.startswith("step_")
             and f.endswith(".json")]
    assert len(steps) == 2  # retention


def test_the_ports_files_load_in_repro_and_repros_in_the_port(tmp_path):
    """Both directions, bit for bit; the same keys and structure in the
    JSON. The trees are the same bits in both packages (the port's
    normal is jax's)."""
    t, jt = _tree(), _jtree()
    save_pytree(str(tmp_path / "port"), t, {"by": "port"})
    jckpt.save_pytree(str(tmp_path / "jax"), jt, {"by": "repro"})
    got_j = jckpt.load_pytree(str(tmp_path / "port"),
                              jax.tree.map(jnp.zeros_like, jt))
    got_t = load_pytree(str(tmp_path / "jax"), _zeros_like(t))
    for a, b in zip(jax.tree.leaves(got_j), _leaves(t)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(_leaves(got_t), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    mine = json.load(open(tmp_path / "port.json"))
    theirs = json.load(open(tmp_path / "jax.json"))
    assert mine["keys"] == theirs["keys"]
    assert mine["treedef"] == theirs["treedef"]
    assert mine["metadata"] == {"by": "port"}


def test_client_stacked_best_models_cross_over(tmp_path):
    """The drivers' use: a client-stacked best_flat, unflattened on each
    side, saved by one manager and restored by the other's."""
    je, te = common.make_engines("cnn")
    jflat = je.flatten(je.init_clients(jax.random.PRNGKey(2)))
    tflat = te.flatten(te.init_clients(prng.PRNGKey(2)))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    CheckpointManager(str(tmp_path / "p")).keep_best(
        0.5, te.unflatten(tflat), {"acc_per_client": [0.5] * 4})
    jckpt.CheckpointManager(str(tmp_path / "j")).keep_best(
        0.5, je.unflatten(jflat))
    jback = jckpt.CheckpointManager(str(tmp_path / "p")).restore_best(
        je.unflatten(jnp.zeros_like(jflat)))
    tback = CheckpointManager(str(tmp_path / "j")).restore_best(
        te.unflatten(torch.zeros_like(tflat)))
    np.testing.assert_array_equal(np.asarray(je.flatten(jback)),
                                  np.asarray(jflat))
    assert torch.equal(te.flatten(tback), tflat)


def test_tuples_and_none_as_jax_writes_them(tmp_path):
    t = {"x": (torch.ones(1),), "y": None, "z": (torch.zeros(2), [])}
    jt = {"x": (jnp.ones(1),), "y": None, "z": (jnp.zeros(2), [])}
    save_pytree(str(tmp_path / "t"), t)
    jckpt.save_pytree(str(tmp_path / "j"), jt)
    mine = json.load(open(tmp_path / "t.json"))
    theirs = json.load(open(tmp_path / "j.json"))
    assert mine["treedef"] == theirs["treedef"]
    assert mine["keys"] == theirs["keys"] == ["x/0", "z/0"]
    back = load_pytree(str(tmp_path / "t"), t)
    assert isinstance(back["x"], tuple) and back["y"] is None
    assert back["z"][1] == []
