"""The eleven Table-1 baselines of the port (`repro_torch.fl.baselines`)
against `repro.fl.baselines`, from the same seed, on the small MLP
setting and on a narrow PaperCNN.

Both packages draw the init from ``PRNGKey(seed)`` themselves (the port's
`prng.normal` is bitwise ``jax.random.normal``), so nothing is carried
across. Per-client test accuracies agree within atol 1e-6 and the
tracked ``best_flat`` (read by wrapping each package's ``_loop``) within
rtol 1e-4, atol 1e-5: tests/test_torch_dpfl.py's tolerances. Further
cases: FedAvg, APFL and Ditto under participation
(tests/test_participation.py::test_baselines_under_sampling), FedAvg
with top-k and int8 (tests/test_compress.py::test_fedavg_compression),
FedRep's local heads, kNN-Per's ranking against ``jax.lax.top_k`` with
exact ties, and the round engine's ``eval_flat``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.fl.baselines as jb  # noqa: E402
from repro.data import ParticipationConfig as JPart  # noqa: E402
from repro.fl.compress import CompressionConfig as JComp  # noqa: E402

import repro_torch.fl.baselines as tb  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.data import ParticipationConfig  # noqa: E402
from repro_torch.fl.compress import CompressionConfig  # noqa: E402
from repro_torch.fl.round_engine import (init_round_state,  # noqa: E402
                                         make_round_step, run_rounds)

RUN = dict(rounds=3, tau=1, seed=0)
_ENGINES = {}


def _engines(kind):
    if kind not in _ENGINES:
        _ENGINES[kind] = common.make_engines(kind)
    return _ENGINES[kind]


def _spy_loops(monkeypatch):
    """Wrap both packages' ``_loop``; returns the dict that collects each
    run's (best_flat, final stacked params) as numpy, under "j" / "t"."""
    got = {}
    for mod, tag in ((jb, "j"), (tb, "t")):
        def spy(*a, _loop=mod._loop, _tag=tag, **kw):
            best, stacked, aux = _loop(*a, **kw)
            got[_tag] = (np.asarray(best.cpu() if _tag == "t" else best),
                         {k: np.asarray(v.cpu() if _tag == "t" else v)
                          for k, v in stacked.items()})
            return best, stacked, aux
        monkeypatch.setattr(mod, "_loop", spy)
    return got


def _run_both(monkeypatch, kind, name, jkw=None, tkw=None):
    je, te = _engines(kind)
    got = _spy_loops(monkeypatch)
    want = jb.run_baseline(name, je, **RUN, **(jkw or {}))
    have = tb.run_baseline(name, te, **RUN, **(tkw or {}))
    np.testing.assert_allclose(have["test_acc"], want["test_acc"], atol=1e-6,
                               err_msg=f"{name} test_acc")
    np.testing.assert_allclose(got["t"][0], got["j"][0], rtol=1e-4,
                               atol=1e-5, err_msg=f"{name} best_flat")
    return have, got


def test_the_port_has_repros_eleven_methods():
    assert list(tb.BASELINES) == list(jb.BASELINES)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
@pytest.mark.parametrize("name", list(jb.BASELINES))
def test_baseline_matches_repro(monkeypatch, kind, name):
    _run_both(monkeypatch, kind, name)


PARTICIPATION = {
    "bernoulli": dict(rate=0.5, seed=7),
    "markov": dict(rate=0.6, model="markov", mean_burst=2.0, seed=3),
    "cluster": dict(rate=0.5, model="cluster", seed=1),
}


@pytest.mark.parametrize("name", ["fedavg", "apfl", "ditto"])
@pytest.mark.parametrize("part", sorted(PARTICIPATION))
def test_sampled_baseline_matches_repro(monkeypatch, name, part):
    kw = PARTICIPATION[part]
    _run_both(monkeypatch, "mlp", name,
              dict(participation=JPart(**kw)),
              dict(participation=ParticipationConfig(**kw)))


@pytest.mark.parametrize("name", ["fedavg", "apfl", "ditto"])
def test_sampling_edges_as_repro(name):
    """rate=1 reproduces the unsampled run; at rate=0 FedAvg never trains,
    so its test accuracy is the evaluated init's
    (tests/test_participation.py::test_baselines_under_sampling)."""
    _, te = _engines("mlp")
    fn = tb.BASELINES[name]
    base = fn(te, **RUN)
    full = fn(te, **RUN, participation=ParticipationConfig(rate=1.0))
    np.testing.assert_allclose(full["test_acc"], base["test_acc"], atol=1e-6)
    if name == "fedavg":
        frozen = fn(te, **RUN, participation=ParticipationConfig(rate=0.0))
        acc0, _ = te.eval_test(te.init_clients(prng.PRNGKey(0)))
        np.testing.assert_allclose(frozen["test_acc"], acc0.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("codec", [("topk", dict(topk_frac=0.25)),
                                   ("int8", {})], ids=["topk", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["full", "sampled"])
def test_fedavg_codec_matches_repro(monkeypatch, codec, sampled):
    """The codec branch of `_loop`: the server averages the decoded
    payloads, the residuals carry (and hold for absent clients)."""
    name, kw = codec
    jkw = dict(compression=JComp(name, **kw))
    tkw = dict(compression=CompressionConfig(name, **kw))
    if sampled:
        jkw["participation"] = JPart(rate=0.5, seed=7)
        tkw["participation"] = ParticipationConfig(rate=0.5, seed=7)
    _run_both(monkeypatch, "mlp", "fedavg", jkw, tkw)


def test_identity_codec_is_the_codec_free_run_bitwise():
    _, te = _engines("mlp")
    base = tb.run_fedavg(te, **RUN)
    ident = tb.run_fedavg(te, **RUN,
                          compression=CompressionConfig("identity"))
    np.testing.assert_array_equal(ident["test_acc"], base["test_acc"])


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_fedrep_keeps_the_heads_local(monkeypatch, kind):
    """After FedRep's last aggregate every client holds the same body and
    its own head; without ``HEAD_KEYS`` the heads are averaged too, and
    FedRep is FedAvg."""
    _, te = _engines(kind)
    got = _spy_loops(monkeypatch)
    assert te.model.HEAD_KEYS == ("out_w", "out_b")
    tb.run_fedrep(te, **RUN)
    stacked = got["t"][1]
    for name, leaf in stacked.items():
        same = all(np.array_equal(leaf[0], leaf[i])
                   for i in range(1, leaf.shape[0]))
        assert same == (name not in te.model.HEAD_KEYS), name
    monkeypatch.setattr(type(te.model), "HEAD_KEYS", ())
    rep = tb.run_fedrep(te, **RUN)
    for leaf in got["t"][1].values():
        assert all(np.array_equal(leaf[0], leaf[i])
                   for i in range(1, leaf.shape[0]))
    np.testing.assert_allclose(rep["test_acc"],
                               tb.run_fedavg(te, **RUN)["test_acc"],
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 4, 10, 20])
def test_knn_rank_equals_lax_top_k_with_ties(k):
    """Small integer distances: most entries tie with others."""
    d = np.random.default_rng(k).integers(0, 5, (3, 7, 20)).astype(
        np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(d), k)
    got = tb.knn_rank(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_rank_on_features_with_exact_ties():
    """kNN-Per's ranking on the port's features of repro's init, carried
    to jax (training rows duplicated, so distances tie exactly): the same
    neighbours in the same order as ``jax.lax.top_k``. On a mismatch the
    distances of the differing row are printed."""
    _, te = _engines("mlp")
    params = te.init_clients(prng.PRNGKey(0))
    tr_x = te.train_data[0].clone()
    tr_x[:, 1::2] = tr_x[:, 0::2]           # every pair a duplicate
    te_x = te.test_data[0]
    f_tr = te.model.features(params, tr_x)
    f_te = te.model.features(params, te_x)
    k = 10
    got = tb.knn_rank(torch.sum((f_te[:, :, None] - f_tr[:, None]) ** 2, -1),
                      k).numpy()
    jf_tr, jf_te = jnp.asarray(f_tr.numpy()), jnp.asarray(f_te.numpy())
    for n in range(got.shape[0]):
        d = jnp.sum((jf_te[n][:, None, :] - jf_tr[n][None, :, :]) ** 2, -1)
        _, want = jax.lax.top_k(-d, k)
        bad = np.flatnonzero((np.asarray(want) != got[n]).any(-1))
        if bad.size:
            print(f"client {n} test row {bad[0]}: distances "
                  f"{np.asarray(d[bad[0]]).tolist()}")
        np.testing.assert_array_equal(got[n], np.asarray(want))


def test_vote_table_is_repeated_addition():
    for k in (1, 3, 7, 10, 16):
        acc = jnp.zeros(k + 1).at[jnp.zeros(k, jnp.int32)].add(1.0 / k)
        table = tb._vote_table(k)
        assert table[k] == np.asarray(acc)[0]
        for c in range(k + 1):
            want = jnp.zeros(1).at[jnp.zeros(c, jnp.int32)].add(1.0 / k)
            assert table[c] == np.asarray(want)[0], (k, c)


def test_eval_flat_picks_the_tracked_model():
    """``eval_flat``'s table is what is validated and kept in
    ``best_flat``; ``eval_flat`` returning the aggregate is the default,
    bit for bit."""
    _, te = _engines("mlp")
    key = prng.PRNGKey(0)
    flat0 = te.flatten(te.init_clients(key))
    v = flat0 * 0.5
    step = make_round_step(te, tau=1, eval_flat=lambda f, a: a["v"])
    st = run_rounds(step, init_round_state(flat0, key, aux={"v": v}), 2)
    assert torch.equal(st.best_flat, v)
    acc, _ = te.eval_val(te.unflatten(v))
    assert torch.equal(st.best_val, acc)
    runs = [run_rounds(make_round_step(te, tau=1, eval_flat=ev),
                       init_round_state(flat0, key), 2)
            for ev in (None, lambda f, a: f)]
    for field in ("flat", "best_flat", "best_val"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
