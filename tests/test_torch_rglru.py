"""The port's hybrid family (RG-LRU + local attention) against `repro`'s
on the CPU.

K6's plain version (`repro_torch.kernels.ref.linear_scan_ref`, what
`ops.rglru_scan` takes for CPU tensors) against the Pallas
``rglru_scan`` kernel in interpret mode at tests/test_kernels.py's
shapes and tolerance (atol 1e-4), against `repro`'s ``linear_scan_ref``
at a ragged S and W that the Pallas kernel refuses, and against a
float64 recurrence; the building blocks (`rglru`, `rec_block` on both
branches, `init_rec_block`, `init_rec_cache`) against `repro`'s at 1e-6;
and reduced recurrentgemma-9b (d 256, lru 256, window 32) at 3 layers
(one (rec, rec, attn) group) and 5 (that group, then the (rec, rec)
remainder segment) served from `repro`'s weights on a 64-token prompt,
longer than the window, so the ring keeps the last 32 rows: prefill
logits, the ring and recurrent caches, eight decode-step logits and the
greedy tokens of `generate` at 1e-5, and the port's own init to the ulps
`prng.normal` allows. The port alone: decode against the teacher-forced
prefill, what it refuses, the full config's tree. The CUDA kernel itself
is held to its plain version on the card by tests/test_torch_cuda.py and
``chip_smoke.py``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import rglru_scan as k6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

ARCH = "recurrentgemma-9b"
KERNEL_TOL = 1e-4  # tests/test_kernels.py
TOL = 1e-5         # model outputs and caches
BLOCK_TOL = 1e-6   # building blocks
B = 2
PROMPT = 64        # longer than the reduced window of 32
NEW = 9            # the first token from the prefill, then eight steps
# tests/test_kernels.py's shapes (B, S, W, block_s, block_w)
PALLAS_SHAPES = [(1, 128, 256, 64, 128), (2, 256, 512, 128, 256),
                 (3, 64, 128, 64, 128)]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


def _scan_inputs(Bn, S, W, seed=0, lo=0.79, width=0.2):
    """(a, b, h0) as tests/test_kernels.py draws them: a = sigmoid(normal)
    * width + lo, b = normal * 0.1, h0 normal."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((Bn, S, W)))) * width + lo
    b = rng.standard_normal((Bn, S, W)) * 0.1
    h0 = rng.standard_normal((Bn, W))
    return tuple(x.astype(np.float32) for x in (a, b, h0))


# ------------------------------------------------- K6's plain version


@pytest.mark.parametrize("Bn,S,W,bs,bw", PALLAS_SHAPES)
def test_ops_rglru_scan_cpu_matches_pallas(Bn, S, W, bs, bw):
    a, b, h0 = _scan_inputs(Bn, S, W, seed=S)
    o, hl = pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(h0), block_s=bs, block_w=bw,
                              interpret=True)
    got, got_hl = ops.rglru_scan(_t(a), _t(b), _t(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (Bn, S, W)
    assert tuple(got_hl.shape) == (Bn, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(o), atol=KERNEL_TOL)
    np.testing.assert_allclose(got_hl.numpy(), np.asarray(hl),
                               atol=KERNEL_TOL)


def test_ops_rglru_scan_cpu_matches_pallas_without_h0():
    a, b, _ = _scan_inputs(2, 128, 128, seed=4, lo=0.49, width=0.5)
    o, hl = pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=64,
                              block_w=128, interpret=True)
    got, got_hl = ops.rglru_scan(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(o), atol=KERNEL_TOL)
    np.testing.assert_allclose(got_hl.numpy(), np.asarray(hl),
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_version_matches_repro_at_ragged_shapes(with_h0):
    """S 200 and W 100 do not divide tests/test_kernels.py's blocks (64,
    128), which the Pallas kernel refuses; `repro`'s model runs its
    associative-scan oracle at any S, and so does the port's plain
    version."""
    a, b, h0 = _scan_inputs(2, 200, 100, seed=5)
    with pytest.raises(ValueError, match="must divide"):
        pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=64,
                          block_w=128, interpret=True)
    h0 = h0 if with_h0 else None
    want, want_hl = jrglru.linear_scan_ref(
        jnp.asarray(a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0))
    got, got_hl = ops.rglru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL)
    np.testing.assert_allclose(got_hl.numpy(), np.asarray(want_hl),
                               atol=KERNEL_TOL)


# K6's backward: the plain version against jax.vjp of `repro`'s oracle
# (an associative scan, which sums in another order), each gradient as a
# share of its largest element
BWD_TOL = 1e-5


@pytest.mark.parametrize("Bn,S,W,with_h0,with_dhl", [
    (2, 200, 100, True, True), (2, 200, 100, False, True),
    (3, 64, 128, True, False), (1, 128, 256, False, False),
    (4, 1, 40, True, True)])
def test_linear_scan_bwd_ref_matches_jax_vjp(Bn, S, W, with_h0, with_dhl):
    a, b, h0 = _scan_inputs(Bn, S, W, seed=S + W)
    rng = np.random.default_rng(W)
    dy = rng.standard_normal((Bn, S, W)).astype(np.float32)
    dhl = rng.standard_normal((Bn, W)).astype(np.float32) if with_dhl \
        else None
    args = [a, b] + ([h0] if with_h0 else [])
    (h, hl), vjp = jax.vjp(jrglru.linear_scan_ref,
                           *(jnp.asarray(x) for x in args))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(hl) if dhl is None
                else jnp.asarray(dhl)))
    got = ref.linear_scan_bwd_ref(_t(a), _t(b), _t(h0) if with_h0 else None,
                                  _t(dy), None if dhl is None else _t(dhl))
    assert len(got) == 3 and (got[2] is None) == (not with_h0)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=BWD_TOL)


def test_linear_scan_bwd_ref_is_the_stepwise_recurrence():
    """g_t = dy_t + a_{t+1} g_{t+1} (g_{S-1} = dy_{S-1} + dh_last), da_t =
    g_t h_{t-1}, db_t = g_t, dh0 = a_0 g_0, each rounded once: what the
    kernel computes, bit for bit; and `ops.rglru_scan` on CPU tensors is
    differentiated so."""
    a, b, h0 = (_t(x) for x in _scan_inputs(2, 50, 7, seed=9))
    gen = torch.Generator().manual_seed(2)
    dy, dl = torch.randn((2, 50, 7), generator=gen), torch.randn(
        (2, 7), generator=gen)
    h, _ = ref.linear_scan_ref(a, b, h0)
    g = dl
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in reversed(range(50)):
        g = dy[:, t] + g if t == 49 else dy[:, t] + a[:, t + 1] * g
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else h0)
    want = (da, db, a[:, 0] * g)
    got = ref.linear_scan_bwd_ref(a, b, h0, dy, dl)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    out = ops.rglru_scan(*leaves)
    assert all(torch.equal(x, y) for x, y in zip(
        torch.autograd.grad(out, leaves, (dy, dl)), want))


def test_plain_version_matches_float64_recurrence():
    """The sequential float32 recurrence within a few float32 roundings of
    the same recurrence in float64, at the model's decays a in [0.3, 1)
    over 512 steps; `repro`'s associative scan sums in another order and
    sits as close."""
    a, b, h0 = _scan_inputs(2, 512, 64, seed=6, lo=0.3, width=0.7)
    h = h0.astype(np.float64)
    want = np.empty(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    got, got_hl = ref.linear_scan_ref(_t(a), _t(b), _t(h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_hl.numpy(), got[:, -1].numpy())
    jgot, _ = jrglru.linear_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0))
    np.testing.assert_allclose(np.asarray(jgot), want, rtol=1e-5, atol=1e-6)


def test_plain_version_is_the_stepwise_update():
    """Each step is the product rounded, then the sum rounded: one step
    from h0 is exactly ``a * h0 + b`` (the decode update, and `repro`'s
    one-step scan ``b + a * h0``), and no h0 is zeros."""
    a, b, h0 = _scan_inputs(3, 1, 40, seed=7)
    got, hl = ref.linear_scan_ref(_t(a), _t(b), _t(h0))
    assert torch.equal(got[:, 0], _t(a)[:, 0] * _t(h0) + _t(b)[:, 0])
    assert torch.equal(hl, got[:, 0])
    want, _ = jrglru.linear_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(ref.linear_scan_ref(_t(a), _t(b))[0], _t(b))
    assert trglru.linear_scan_ref is ref.linear_scan_ref


# ----------------------------------------------------- building blocks


def _block_pair():
    """A reduced RG-LRU block's weights from `repro`'s init, as numpy, in
    the port's `RecLayer` and in `repro`'s dict; non-zero biases, so ba
    and bx take part."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jp = jrglru.init_rec_block(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(8)
    W = jcfg.lru_width
    jp = dict(jp, ba=jnp.asarray(rng.standard_normal(W) * 0.5, jnp.float32),
              bx=jnp.asarray(rng.standard_normal(W) * 0.5, jnp.float32))
    tcfg = tconfigs.get_config(ARCH).reduced()
    layer = tlm.RecLayer(tcfg, torch.float32, "cpu")
    layer.load_state_dict({k: _t(v) for k, v in jp.items()}, assign=True)
    return jcfg, tcfg, jp, layer


@pytest.mark.parametrize("S,with_h0", [(40, False), (1, True), (16, True)])
def test_rglru_matches_repro(S, with_h0):
    _, tcfg, jp, layer = _block_pair()
    rng = np.random.default_rng(S)
    v = rng.standard_normal((B, S, tcfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((B, tcfg.lru_width)).astype(np.float32) \
        if with_h0 else None
    # serving's mode: the layer's weights take gradients, and serving
    # runs without autograd
    with torch.inference_mode():
        out, hl = trglru.rglru(_t(v), layer, None if h0 is None else _t(h0))
    jout, jhl = jrglru.rglru(jnp.asarray(v), jp,
                             None if h0 is None else jnp.asarray(h0))
    _close(out, jout, BLOCK_TOL)
    _close(hl, jhl, BLOCK_TOL)
    assert hl.dtype == torch.float32


def test_rec_block_matches_repro_on_both_branches():
    jcfg, tcfg, jp, layer = _block_pair()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 24, tcfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        y, cache = trglru.rec_block(layer, _t(x), tcfg)
        jy, jcache = jrglru.rec_block(jp, jnp.asarray(x), jcfg)
        _close(y, jy, BLOCK_TOL)
        for name in ("h", "conv"):
            _close(cache[name], jcache[name], BLOCK_TOL)
        assert cache["h"].dtype == torch.float32
        for t in range(3):   # three decode steps from that cache
            xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
            h_before = cache["h"]
            y, cache = trglru.rec_block(layer, _t(xt), tcfg, cache)
            assert cache["h"] is h_before   # written in place
            jy, jcache = jrglru.rec_block(jp, jnp.asarray(xt), jcfg, jcache)
            _close(y, jy, BLOCK_TOL)
            for name in ("h", "conv"):
                _close(cache[name], jcache[name], BLOCK_TOL)


def test_init_rec_block_and_cache_match_repro():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jkey = jax.random.PRNGKey(11)
    jp = jrglru.init_rec_block(jkey, jcfg, jnp.bfloat16)
    tp = trglru.init_rec_block(common.key_to_torch(jkey), tcfg,
                               torch.bfloat16)
    assert set(tp) == set(jp)
    for name, want in jp.items():
        got = tp[name]
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        want = np.asarray(want, np.float32)
        torch.testing.assert_close(got.float(), torch.from_numpy(want),
                                   rtol=1e-2, atol=1e-5 * float(
                                       np.abs(want).max() or 1), msg=name)
    for name in ("wa", "ba", "wx", "bx", "lam"):
        assert tp[name].dtype == torch.float32, name
    jc = jrglru.init_rec_cache(jcfg, 3, jnp.bfloat16)
    tc = trglru.init_rec_cache(tcfg, 3, torch.bfloat16)
    for name in ("h", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        assert not tc[name].any()


# -------------------------------------------------------------- the model


@pytest.fixture(scope="module", params=[3, 5])
def served(request):
    """Reduced recurrentgemma-9b with ``n_layers`` 3 or 5 in `repro`, its
    init for key 1, its prefill of a 64-token prompt and greedy decode
    loop, and the port's model on the CPU carrying that init."""
    n_layers = request.param
    jcfg = jconfigs.get_config(ARCH).reduced().replace(n_layers=n_layers)
    tcfg = tconfigs.get_config(ARCH).reduced().replace(n_layers=n_layers)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(n_layers).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    total = PROMPT + NEW
    logits, caches = jm.prefill(jparams, jnp.asarray(tokens), cache_len=total)
    jout = {"prefill_logits": np.asarray(logits),
            "prefill_caches": jax.tree.map(np.asarray, caches)}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(NEW - 1):
        logits, caches = dstep(jparams, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    jout.update(tokens=np.concatenate(toks, 1), step_logits=step_logits,
                caches=jax.tree.map(np.asarray, caches))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    model = build_model(tcfg, device="meta")
    model.load_state_dict(params, assign=True)
    return dict(cfg=tcfg, model=model, params=params, total=total,
                prompts=torch.from_numpy(tokens).long(), jax=jout)


def _check_caches(cfg, caches, jcaches):
    """Each layer's cache against `repro`'s segment tree: layer i at
    (si, g, bi) is row g of ``caches[si][f"b{bi}"]``."""
    layout = tlm.hybrid_layout(cfg)
    assert len(caches) == len(layout) == cfg.n_layers
    for i, (si, g, bi, kind) in enumerate(layout):
        want = jcaches[si][f"b{bi}"]
        names = ("h", "conv") if kind == "rec" else ("k", "v")
        assert set(caches[i]) == set(want), i
        for name in names:
            _close(caches[i][name], want[name][g])
        if kind == "rec":
            assert caches[i]["h"].dtype == torch.float32
        else:
            np.testing.assert_array_equal(caches[i]["pos"].numpy(),
                                          want["pos"][g])


def test_layout_follows_repro_segments(served):
    cfg = served["cfg"]
    kinds = [kind for *_, kind in tlm.hybrid_layout(cfg)]
    assert kinds == ["rec", "rec", "attn", "rec", "rec"][:cfg.n_layers]
    segs = tlm.hybrid_segments(cfg)
    assert segs[0] == (("rec", "rec", "attn"), 1)
    assert len(segs) == (2 if cfg.n_layers == 5 else 1)
    assert served["model"].window == cfg.local_window == 32


def test_prefill_logits_and_caches_match_repro(served):
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        logits, caches = model.prefill(served["prompts"],
                                       cache_len=served["total"])
    _close(logits, j["prefill_logits"])
    _check_caches(served["cfg"], caches, j["prefill_caches"])
    # the ring keeps the last 32 of the 64 prompt rows
    assert caches[2]["k"].shape[1] == 32 < PROMPT
    assert int(caches[2]["pos"].min()) == PROMPT - 32


def test_decode_steps_match_repro(served):
    """Eight decode_step logits and the caches after them, teacher-forced
    with `repro`'s greedy tokens."""
    model, j = served["model"], served["jax"]
    assert len(j["step_logits"]) == 8
    with torch.inference_mode():
        _, caches = model.prefill(served["prompts"], cache_len=served["total"])
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               PROMPT + t)
            _close(logits, want)
    _check_caches(served["cfg"], caches, j["caches"])


def test_generate_matches_repro_greedy_serve(served):
    before = (k6.rglru_scan.launches, k4.flash_attention.launches)
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         NEW)
    # the CPU's plain path
    assert (k6.rglru_scan.launches, k4.flash_attention.launches) == before
    j = served["jax"]
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])


def test_init_matches_repro_within_ulps(served):
    """The port's own init draws `repro`'s key tree (``fold_in(ks[2],
    si * 16 + bi)`` split over the groups, then ``split(key, 6)`` per
    recurrent block); each leaf within 1e-5 of its largest value
    (`prng.normal`'s ulps), the five gate leaves float32."""
    model = build_model(served["cfg"], device="meta")
    own = model.init(prng.PRNGKey(1))
    assert set(own) == set(served["params"])
    for name, want in served["params"].items():
        assert own[name].dtype == want.dtype, name
        assert own[name].device.type == "cpu", name
        torch.testing.assert_close(own[name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_decode_matches_teacher_forced():
    """The port alone, 5 layers: prefill 40 then decode 8 (the ring of 32
    slots wraps) equals the prefills of 41 .. 48 tokens; decoding from an
    empty cache equals the prefill of the same tokens."""
    cfg = tconfigs.get_config(ARCH).reduced().replace(n_layers=5)
    model = build_model(cfg, device="meta")
    model.init(prng.PRNGKey(2))
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, 48))).long()
    with torch.inference_mode():
        _, caches = model.prefill(tokens[:, :40], cache_len=48)
        for t in range(40, 48):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
            want, _ = model.prefill(tokens[:, :t + 1])
            torch.testing.assert_close(logits, want, atol=5e-5, rtol=1e-4)
        caches = model.init_cache(B, 8)
        for t in range(6):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
        want, _ = model.prefill(tokens[:, :6])
        torch.testing.assert_close(logits, want, atol=5e-5, rtol=1e-4)


def test_short_prompt_raises():
    """`repro` builds no recurrent cache for a prompt shorter than
    ssm_conv - 1 and then decodes without state; the port refuses it."""
    cfg = tconfigs.get_config(ARCH).reduced()
    model = build_model(cfg, device="meta")
    model.init(prng.PRNGKey(0))
    with torch.inference_mode(), pytest.raises(ValueError, match="conv"):
        model.prefill(torch.zeros((1, 2), dtype=torch.long))
    with torch.inference_mode():
        logits, caches = model.prefill(torch.zeros((1, 3), dtype=torch.long))
    assert caches[0]["conv"].shape[1] == 3 and torch.isfinite(logits).all()


# --------------------------------------------------- building and carrying


def test_full_config_builds_on_meta_and_carries_repro_tree():
    cfg = tconfigs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    state = model.state_dict()
    assert sum(t.numel() for t in state.values()) == 6_518_902_784
    kinds = [kind for *_, kind in tlm.hybrid_layout(cfg)]
    assert kinds.count("rec") == 26 and kinds.count("attn") == 12
    assert isinstance(model.layers[37], tlm.RecLayer)
    assert isinstance(model.layers[35], tlm.DenseLayer)
    assert model.window == 2048
    # `repro`'s bf16 tree, read by jax.eval_shape (nothing allocated)
    jcfg = jconfigs.get_config(ARCH)
    jtree = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    assert len(jtree["segments"]) == 2
    for name in ("tok_embed", "final_norm", "lm_head"):
        assert tuple(state[name].shape) == jtree[name].shape, name
        assert str(state[name].dtype).split(".")[-1] == \
            str(jtree[name].dtype), name
    n = 0
    for i, (si, g, bi, _) in enumerate(tlm.hybrid_layout(cfg)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                jtree["segments"][si][f"b{bi}"]):
            name = f"layers.{i}." + ".".join(k.key for k in path)
            assert tuple(state[name].shape) == leaf.shape[1:], name
            assert str(state[name].dtype).split(".")[-1] == \
                str(leaf.dtype), name
            n += 1
    assert n == len(state) - 3
    for name in ("wa", "ba", "wx", "bx", "lam"):
        assert state[f"layers.0.{name}"].dtype == torch.float32
    assert state["layers.0.w_gate"].dtype == torch.bfloat16
    # a reduced bf16 tree carried by lm_params_from_jax, the five float32
    jcfg = jconfigs.get_config(ARCH).reduced().replace(dtype="bfloat16",
                                                       n_layers=5)
    tcfg = tconfigs.get_config(ARCH).reduced().replace(dtype="bfloat16",
                                                       n_layers=5)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = lm_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        device="cpu")
    small = build_model(tcfg, device="meta")
    assert set(params) == set(small.state_dict())
    for name, t in params.items():
        assert t.shape == small.state_dict()[name].shape, name
        assert t.dtype == small.state_dict()[name].dtype, name
    assert params["layers.4.lam"].dtype == torch.float32
    assert params["layers.4.conv_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers.4.wa"].numpy(),
        np.asarray(jparams["segments"][1]["b1"]["wa"][0]))
    small.load_state_dict(params, assign=True)


# ------------------------------------------------------------ refusals


def test_kernel_wrapper_never_takes_the_plain_version():
    """On CPU tensors the wrapper raises (ops picks the plain version by
    device); it refuses what the kernel does not take before any build."""
    a, b, h0 = (_t(x) for x in _scan_inputs(2, 16, 8))
    before = k6.rglru_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        k6.rglru_scan(a, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        k6.rglru_scan(a, b)
    with pytest.raises(TypeError, match="float32"):
        k6.rglru_scan(a.bfloat16(), b.bfloat16())
    with pytest.raises(TypeError):
        k6.rglru_scan(a, b, h0.double())
    with pytest.raises(ValueError, match="one"):
        k6.rglru_scan(a, b[:, :8])
    with pytest.raises(ValueError, match="h0"):
        k6.rglru_scan(a, b, h0[:, :4])
    with pytest.raises(ValueError, match=">= 1"):
        k6.rglru_scan(a[:, :0], b[:, :0])
    assert k6.rglru_scan.launches == before


def test_kernel_source_is_registered_for_nvcc():
    assert _build.SOURCES["rglru_scan"] == "rglru_scan.cu"
    src = (_build.CSRC / "rglru_scan.cu").read_text()
    assert 'extern "C" int rglru_scan_f32(' in src
    assert 'extern "C" const char* rglru_scan_error_string(' in src
    assert "repro/kernels/rglru_scan.py::rglru_scan" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src   # no FMA contraction


def test_backward_source_is_registered_for_nvcc():
    assert _build.SOURCES["rglru_scan_bwd"] == "rglru_scan_bwd.cu"
    src = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    assert 'extern "C" int rglru_scan_bwd_f32(' in src
    assert 'extern "C" const char* rglru_scan_bwd_error_string(' in src
    assert "repro/kernels/rglru_scan.py::rglru_scan" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src   # no FMA contraction
    assert "constexpr int kU = 32;" in src   # the forward's load depth


def test_backward_wrapper_never_takes_the_plain_version():
    a, b, h0 = (_t(x) for x in _scan_inputs(2, 16, 8))
    before = k6.rglru_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        k6.rglru_scan_bwd(a, b, h0, torch.zeros_like(a), None)
    with pytest.raises(TypeError):
        k6.rglru_scan_bwd(a.bfloat16(), b.bfloat16(), None,
                          torch.zeros_like(a), None)
    assert k6.rglru_scan_bwd.launches == before


def test_serve_main_on_cpu(capsys):
    before = (k6.rglru_scan.launches, k4.flash_attention.launches)
    serve.main(["--arch", ARCH, "--device", "cpu"])
    assert (k6.rglru_scan.launches, k4.flash_attention.launches) == before
    out = capsys.readouterr().out
    assert "prefill B=4 S=32" in out
    assert "decoded 15 steps x 4 seqs" in out
