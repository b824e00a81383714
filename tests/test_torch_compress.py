"""The port's codecs (`repro_torch.fl.compress`) and K3's plain version
against `repro`'s, and whole compressed runs.

Bytes per model are exact for every codec; top-k decoded tables equal
`repro`'s (decoded tables, not raw index order: `torch.topk` and
`lax.top_k` may order ties differently); int8 ``q`` and ``scale`` are
bitwise `repro`'s for the same key; EF residuals are ``xin - dec``; the
compressed mix keeps the self term exact. K3 (`ops.compressed_graph_mix`
on CPU tensors, plain version, no launch) matches the Pallas kernel in
interpret mode and `repro`'s oracle within 1e-5. The identity codec is
bitwise the codec-free run, and whole top-k and int8 runs hold the
tolerances of tests/test_torch_dpfl.py."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import CompressionConfig as JCompression  # noqa: E402
from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.core import run_dpfl as jrun  # noqa: E402
from repro.fl import compress as jcomp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.compressed_graph_mix import \
    compressed_graph_mix as pallas_compressed_mix  # noqa: E402

from repro_torch.core.dpfl import (DPFLConfig, run_dpfl,  # noqa: E402
                                   run_dpfl_reference)
from repro_torch.fl import compress as tcomp  # noqa: E402
from repro_torch.kernels import compressed_graph_mix as k3  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_dpfl import (_assert_same_run, _engines,  # noqa: E402
                             _RewardLog)

CODECS = {"topk": dict(codec="topk", topk_frac=0.1),
          "topk-half-noef": dict(codec="topk", topk_frac=0.5,
                                 error_feedback=False),
          "int8": dict(codec="int8"),
          "int4-noef": dict(codec="int8", quant_bits=4,
                            error_feedback=False)}


def _pair(**kw):
    return JCompression(**kw), tcomp.CompressionConfig(**kw)


def _table(N, P, seed):
    return np.random.default_rng(seed).standard_normal((N, P)).astype(
        np.float32)


# ------------------------------------------------------------- config


def test_config_validation_and_normalize():
    for bad in (dict(codec="gzip"), dict(codec="topk", topk_frac=0.0),
                dict(codec="topk", topk_frac=1.5),
                dict(codec="int8", quant_bits=1),
                dict(codec="int8", quant_bits=9)):
        with pytest.raises(ValueError):
            tcomp.CompressionConfig(**bad)
    assert tcomp.normalize(None) is None
    assert tcomp.normalize(tcomp.CompressionConfig("identity")) is None
    lossy = tcomp.CompressionConfig("topk")
    assert tcomp.normalize(lossy) is lossy
    assert tcomp.uses_ef(lossy) and not tcomp.uses_ef(None)
    assert not tcomp.uses_ef(tcomp.CompressionConfig("identity"))
    assert not tcomp.uses_ef(tcomp.CompressionConfig("topk",
                                                     error_feedback=False))


@pytest.mark.parametrize("P", [1, 7, 1000, 62006, 10**9 + 7])
def test_bytes_per_model_is_exact(P):
    specs = [None, dict(codec="identity")] + list(CODECS.values()) + \
        [dict(codec="topk", topk_frac=1e-9), dict(codec="topk",
                                                  topk_frac=1.0),
         dict(codec="int8", quant_bits=3)]
    for kw in specs:
        j, t = (None, None) if kw is None else _pair(**kw)
        assert tcomp.bytes_per_model(t, P) == jcomp.bytes_per_model(j, P)
        assert isinstance(tcomp.bytes_per_model(t, P), int)
        if kw is not None and kw["codec"] == "topk":
            assert tcomp.topk_k(t, P) == jcomp.topk_k(j, P)


# ------------------------------------------------------------- codecs


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(3, 40), (6, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_topk_decoded_tables_equal_repro(shape, frac):
    x = _table(*shape, seed=shape[1])
    jcfg, tcfg = _pair(codec="topk", topk_frac=frac)
    jpay = jcomp.encode(jcfg, jnp.asarray(x), None)
    want = np.asarray(jcomp.decode(jcfg, jpay, shape[1]))
    tpay = tcomp.encode(tcfg, torch.from_numpy(x), None)
    assert tpay["idx"].dtype == torch.int32
    assert tpay["vals"].shape == (shape[0], tcomp.topk_k(tcfg, shape[1]))
    np.testing.assert_array_equal(
        tcomp.decode(tcfg, tpay, shape[1]).numpy(), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 9])
def test_int8_payload_bitwise_equal_to_repro(bits, seed):
    x = _table(5, 777, seed) * 3.0
    key = jax.random.PRNGKey(seed + 100)
    jcfg, tcfg = _pair(codec="int8", quant_bits=bits)
    jpay = jcomp.encode(jcfg, jnp.asarray(x), key)
    tpay = tcomp.encode(tcfg, torch.from_numpy(x), common.key_to_torch(key))
    assert tpay["q"].dtype == torch.int8
    np.testing.assert_array_equal(tpay["q"].numpy(), np.asarray(jpay["q"]))
    np.testing.assert_array_equal(tpay["scale"].numpy(),
                                  np.asarray(jpay["scale"]))
    np.testing.assert_array_equal(
        tcomp.decode(tcfg, tpay, 777).numpy(),
        np.asarray(jcomp.decode(jcfg, jpay, 777)))


@pytest.mark.parametrize("codec", list(CODECS))
def test_exchange_and_ef_residuals(codec):
    flat = _table(6, 500, 1)
    ef = _table(6, 500, 2) * 0.1
    key = jax.random.PRNGKey(5)
    jcfg, tcfg = _pair(**CODECS[codec])
    use_ef = tcomp.uses_ef(tcfg)
    _, jdec, jef = jcomp.compress_exchange(
        jcfg, jnp.asarray(flat), jnp.asarray(ef) if use_ef else None, key)
    payload, dec, new_ef = tcomp.compress_exchange(
        tcfg, torch.from_numpy(flat), torch.from_numpy(ef) if use_ef
        else None, common.key_to_torch(key))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    if use_ef:
        xin = torch.from_numpy(flat) + torch.from_numpy(ef)
        np.testing.assert_array_equal(new_ef.numpy(), (xin - dec).numpy())
        np.testing.assert_array_equal(new_ef.numpy(), np.asarray(jef))
    else:
        assert new_ef is None and jef is None


# ------------------------------------------------------------- K3, plain


def _topk_payload(n, p, frac, seed):
    x = _table(n, p, seed)
    k = max(1, int(frac * p))
    idx = np.argsort(-np.abs(x), axis=1, kind="stable")[:, :k]
    return np.take_along_axis(x, idx, axis=1), idx.astype(np.int32)


def _mixing(n, seed):
    a = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    return a / a.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("n,p,frac,bp,bk", [
    (2, 2, 1.0, 64, 4), (3, 700, 0.02, 64, 64), (5, 900, 0.3, 128, 512),
    (8, 129, 0.5, 512, 4), (12, 515, 0.9, 128, 64), (6, 64, 0.1, 64, 512)])
def test_ops_compressed_graph_mix_cpu_matches_repro(n, p, frac, bp, bk):
    A = _mixing(n, n + p)
    vals, idx = _topk_payload(n, p, frac, p)
    j = (jnp.asarray(A), jnp.asarray(vals), jnp.asarray(idx))
    want_pallas = np.asarray(pallas_compressed_mix(
        *j, p, block_p=bp, block_k=bk, interpret=True))
    want_ref = np.asarray(jref.compressed_graph_mix_ref(*j, p))
    before = k3.compressed_graph_mix.launches
    got = ops.compressed_graph_mix(torch.from_numpy(A),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(idx), p)
    assert k3.compressed_graph_mix.launches == before, \
        "a CPU call launched the kernel"
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_compressed_plain_version_duplicate_indices_add():
    """tests/test_kernels.py's exact case: duplicates add."""
    A = torch.eye(2)
    vals = torch.tensor([[1.0, 2.0, 4.0], [0.5, 0.25, 0.125]])
    idx = torch.tensor([[3, 3, 0], [1, 1, 1]], dtype=torch.int32)
    want = np.array([[4.0, 0, 0, 3.0, 0], [0, 0.875, 0, 0, 0]])
    np.testing.assert_array_equal(
        ops.compressed_graph_mix(A, vals, idx, 5).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(pallas_compressed_mix(
            jnp.eye(2), jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()),
            5, block_p=4, block_k=2, interpret=True)), want)


def test_compressed_plain_version_skips_pads_as_the_pallas_kernel():
    """An idx of -1 lands nowhere, as in the Pallas kernel (whose own
    wrapper pads K with -1). `repro`'s jnp oracle scatters -1 to the last
    column instead (negative indices wrap in jax), so pads are held to
    the kernel only."""
    A = _mixing(4, 0)
    vals, idx = _topk_payload(4, 300, 0.2, 1)
    idx = np.where(np.random.default_rng(2).random(idx.shape) < 0.3, -1,
                   idx).astype(np.int32)
    want = np.asarray(pallas_compressed_mix(
        jnp.asarray(A), jnp.asarray(vals), jnp.asarray(idx), 300,
        block_p=128, block_k=16, interpret=True))
    got = ops.compressed_graph_mix(torch.from_numpy(A),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(idx), 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dense = ref.densify_topk(torch.ones((1, 2)),
                             torch.tensor([[0, -1]], dtype=torch.int32), 4)
    np.testing.assert_array_equal(dense.numpy(), [[1.0, 0.0, 0.0, 0.0]])


def test_compressed_kernel_wrapper_refuses_cpu_tensors():
    vals, idx = _topk_payload(3, 40, 0.5, 0)
    with pytest.raises(ValueError, match="CUDA"):
        k3.compressed_graph_mix(torch.from_numpy(_mixing(3, 0)),
                                torch.from_numpy(vals),
                                torch.from_numpy(idx), 40)


# ------------------------------------------------------------- mixing


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_mix_compressed_matches_repro_with_exact_self_term(codec):
    N, P = 6, 400
    flat = _table(N, P, 3)
    A = _mixing(N, 4)
    key = jax.random.PRNGKey(8)
    jcfg, tcfg = _pair(**CODECS[codec])
    jpay, jdec, _ = jcomp.compress_exchange(jcfg, jnp.asarray(flat), None,
                                            key)
    want = np.asarray(jcomp.mix_compressed(jcfg, jnp.asarray(A),
                                           jnp.asarray(flat), jpay, jdec,
                                           impl="ref"))
    tflat = torch.from_numpy(flat)
    pay, dec, _ = tcomp.compress_exchange(tcfg, tflat, None,
                                          common.key_to_torch(key))
    got = tcomp.mix_compressed(tcfg, torch.from_numpy(A), tflat, pay, dec)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # a diagonal A mixes nothing from peers: the self term is exact
    D = torch.diag(torch.from_numpy(A).diagonal())
    self_only = tcomp.mix_compressed(tcfg, D, tflat, pay, dec)
    np.testing.assert_array_equal(self_only.numpy(),
                                  (D.diagonal()[:, None] * tflat).numpy())


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_sparse_mix_compressed_matches_repro(codec):
    from repro.core import graph as jgraph

    from repro_torch.core import graph as tgraph
    N, P = 6, 300
    flat = _table(N, P, 6)
    rng = np.random.default_rng(7)
    idx = np.sort(np.stack([rng.choice(np.setdiff1d(np.arange(N), [k]), 2,
                                       replace=False) for k in range(N)]),
                  axis=1).astype(np.int32)
    p = rng.uniform(0.1, 1.0, N).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jcfg, tcfg = _pair(**CODECS[codec])
    jpay, jdec, _ = jcomp.compress_exchange(jcfg, jnp.asarray(flat), None,
                                            key)
    jsw, jnw = jgraph.sparse_mixing_weights(jnp.asarray(idx), jnp.asarray(p))
    want = np.asarray(jcomp.sparse_mix_compressed(
        jcfg, jsw, jnw, jnp.asarray(idx), jnp.asarray(flat), jpay, jdec,
        impl="ref"))
    tflat = torch.from_numpy(flat)
    pay, dec, _ = tcomp.compress_exchange(tcfg, tflat, None,
                                          common.key_to_torch(key))
    sw, nw = tgraph.sparse_mixing_weights(torch.from_numpy(idx),
                                          torch.from_numpy(p))
    got = tcomp.sparse_mix_compressed(tcfg, sw, nw, torch.from_numpy(idx),
                                      tflat, pay, dec)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- whole runs

RUNS = {
    "dense-topk": dict(codec="topk", topk_frac=0.1),
    "sparse-topk": dict(codec="topk", topk_frac=0.1, graph_repr="sparse"),
    "dense-int8": dict(codec="int8"),
    "sparse-int8-noef": dict(codec="int8", error_feedback=False,
                             graph_repr="sparse"),
    "dense-topk-refresh2-noef": dict(codec="topk", topk_frac=0.3,
                                     error_feedback=False,
                                     refresh_period=2),
}


def _configs(spec, kind):
    spec = dict(spec)
    base = dict(rounds=4, tau_init=2, tau_train=1, budget=3, seed=0) \
        if kind == "mlp" else dict(rounds=2, tau_init=2, tau_train=1,
                                   budget=2, seed=0)
    for key in ("graph_repr", "refresh_period"):
        if key in spec:
            base[key] = spec.pop(key)
    j, t = _pair(**spec)
    return base, JConfig(**base, compression=j), DPFLConfig(**base,
                                                            compression=t)


@pytest.mark.parametrize("setting", list(RUNS) + ["cnn-topk"])
def test_compressed_runs_match_repro_and_own_reference(setting):
    kind = "cnn" if setting.startswith("cnn") else "mlp"
    spec = RUNS.get(setting, dict(codec="topk", topk_frac=0.1))
    cfg_kw, jcfg, tcfg = _configs(spec, kind)
    je, te = _engines(kind)
    log = _RewardLog(te)
    try:
        want = jrun(je, jcfg)
        got = run_dpfl(te, tcfg)
        host = run_dpfl_reference(te, tcfg)
    finally:
        del te.make_reward_fn
    _assert_same_run(want, got, cfg_kw, log, f"{setting}: port vs repro")
    _assert_same_run(got, host, cfg_kw, log,
                     f"{setting}: run_dpfl vs run_dpfl_reference")
    P = te.n_params
    assert got.comm_bytes == [d * tcomp.bytes_per_model(tcfg.compression, P)
                              for d in got.comm_downloads]
    assert got.comm_bytes_preprocess == got.comm_preprocess * 4 * P


@pytest.mark.parametrize("graph_repr", ["dense", "sparse"])
def test_identity_codec_is_bitwise_the_codec_free_run(graph_repr):
    _, te = _engines("mlp")
    kw = dict(rounds=3, tau_init=2, tau_train=1, budget=3, seed=1,
              graph_repr=graph_repr)
    a = run_dpfl(te, DPFLConfig(**kw))
    b = run_dpfl(te, DPFLConfig(
        compression=tcomp.CompressionConfig("identity"), **kw))
    np.testing.assert_array_equal(a.best_flat, b.best_flat)
    np.testing.assert_array_equal(a.test_acc, b.test_acc)
    np.testing.assert_array_equal(a.omega, b.omega)
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    assert a.comm_downloads == b.comm_downloads
    assert a.comm_bytes == b.comm_bytes


def test_repro_compression_config_is_refused():
    """The port takes its own CompressionConfig only."""
    _, te = _engines("mlp")
    with pytest.raises(TypeError, match="CompressionConfig"):
        run_dpfl(te, DPFLConfig(rounds=1, tau_init=1, tau_train=1, budget=2,
                                compression=JCompression("topk")))


@pytest.mark.parametrize("codec,graph_repr", [("topk", "dense"),
                                              ("int8", "dense"),
                                              ("topk", "sparse")])
def test_compressed_kernel_calls_per_run(monkeypatch, codec, graph_repr):
    """Dense top-k: K1 per BGGC phase-1 batch, for the preprocessing mix
    and per greedy init, K3 once per round; dense int8 mixes its decoded
    table through K1; sparse runs mix through K2 with or without a codec.
    These are the counts chip_smoke.py asserts on the card."""
    _, te = _engines("mlp")
    names = ("graph_mix", "sparse_graph_mix", "compressed_graph_mix")
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ops, name, counted)
    rounds, budget = 3, 4
    run_dpfl(te, DPFLConfig(rounds=rounds, tau_init=1, tau_train=1,
                            budget=budget, seed=2, graph_repr=graph_repr,
                            compression=tcomp.CompressionConfig(codec)))
    pre = -(-te.data.n_clients // budget)
    want = {("topk", "dense"): (pre + 1 + rounds, 0, rounds),
            ("int8", "dense"): (pre + 1 + 2 * rounds, 0, 0),
            ("topk", "sparse"): (pre + rounds, 1 + rounds, 0)}
    assert tuple(calls[n] for n in names) == want[codec, graph_repr]
