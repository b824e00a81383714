"""The port's SSM family against `repro`'s on the CPU.

K5's plain version (`repro_torch.kernels.ref.ssd_ref`, what
`ops.ssd` takes for CPU tensors) against the Pallas ``ssd`` kernel in
interpret mode at tests/test_kernels.py's shapes and tolerance (atol
2e-4, rtol 1e-3), with an h0 and at the reduced model's shape; the
chunked scan against the per-step recurrence; the building blocks
(`segsum`, `ssd_ref`, `ssd_decode_step`, `depthwise_causal_conv`;
`mamba_block` on both branches within 1e-6 of its outputs' scale)
against `repro`'s at 1e-6; and reduced
mamba2-370m served from `repro`'s weights (prompts of 64 and 16 tokens):
prefill logits, the h and conv caches, eight decode-step logits and the
greedy tokens of `generate` at 1e-5, and the port's own init to the ulps
`prng.normal` allows. The port alone: decode against the teacher-forced
prefill, and what it refuses. The CUDA kernel itself is held to its
plain version on the card by tests/test_torch_cuda.py and
``chip_smoke.py``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd import ssd as pallas_ssd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd as k5  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "mamba2-370m"
KERNEL_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_kernels.py
TOL = 1e-5        # model outputs and caches
BLOCK_TOL = 1e-6  # building blocks
B = 2
NEW = 9           # the first token from the prefill, then eight steps
# tests/test_kernels.py's shapes (b, l, H, p, n, chunk), then the
# reduced model's (H 16 heads of 32, n 16, chunk 32) at a 64-token prompt
PALLAS_SHAPES = [(1, 128, 2, 16, 8, 32), (2, 256, 4, 32, 16, 64),
                 (1, 64, 1, 64, 32, 64)]
MODEL_SHAPE = (2, 64, 16, 32, 16, 32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


def _close_to_scale(got, want, tol=BLOCK_TOL):
    """Within ``tol`` of the largest |value|: a block's two matmuls (K 256
    and 512 at the reduced width) sum in another order than XLA's, which
    alone moves in_proj's outputs (scale 4.4) by 3.1e-6."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * float(np.abs(want).max()),
                               rtol=tol)


def _scan_inputs(b, l, H, p, n, seed=0, model_dt=False):
    """(x, dlogA, B, C) as tests/test_kernels.py draws them (x, B, C
    normal * 0.3, dlogA = -|normal| * 0.1), or with ``model_dt`` as the
    model makes them: dt = softplus(normal logits), A = -1 at init,
    x = normal * dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, H, p)) * 0.3
    if model_dt:
        dt = np.logaddexp(rng.standard_normal((b, l, H)), 0.0)
        x, dlogA = x * dt[..., None], -dt
    else:
        dlogA = -np.abs(rng.standard_normal((b, l, H))) * 0.1
    Bm = rng.standard_normal((b, l, n)) * 0.3
    Cm = rng.standard_normal((b, l, n)) * 0.3
    return tuple(a.astype(np.float32) for a in (x, dlogA, Bm, Cm))


# ------------------------------------------------- K5's plain version


@pytest.mark.parametrize("b,l,H,p,n,ch,case", [
    *(s + ("test_kernels",) for s in PALLAS_SHAPES),
    (2, 256, 4, 32, 16, 64, "h0"),
    MODEL_SHAPE + ("model dt",)])
def test_ops_ssd_cpu_matches_pallas(b, l, H, p, n, ch, case):
    arrays = _scan_inputs(b, l, H, p, n, seed=len(case),
                          model_dt=case == "model dt")
    h0 = None
    if case == "h0":
        h0 = (np.random.default_rng(7).standard_normal((b, H, p, n))
              * 0.5).astype(np.float32)
    y, hl = pallas_ssd(*(jnp.asarray(a) for a in arrays), chunk=ch,
                       h0=None if h0 is None else jnp.asarray(h0),
                       interpret=True)
    got_y, got_h = ops.ssd(*(_t(a) for a in arrays), chunk=ch,
                           h0=None if h0 is None else _t(h0))
    assert got_y.dtype == torch.float32 and tuple(got_y.shape) == (b, l, H, p)
    assert tuple(got_h.shape) == (b, H, p, n)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **KERNEL_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hl), **KERNEL_TOL)


def test_ssd_matches_sequential_recurrence():
    """tests/test_kernels.py's check: the chunked scan (the Pallas kernel
    and the port's plain version) equals the literal per-step recurrence
    of the port's `ssd_decode_step`."""
    b, l, H, p, n = 1, 32, 2, 8, 4
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((b, l, H, p)) * 0.3).astype(np.float32)
    dlogA = (-np.abs(rng.standard_normal((b, l, H))) * 0.2).astype(np.float32)
    Bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    h = torch.zeros((b, H, p, n))
    ys = []
    for t in range(l):
        yt, h = tssm.ssd_decode_step(h, _t(x[:, t]), _t(dlogA[:, t]),
                                     _t(Bm[:, t]), _t(Cm[:, t]))
        ys.append(yt)
    yseq = torch.stack(ys, 1).numpy()
    y, _ = pallas_ssd(*(jnp.asarray(a) for a in (x, dlogA, Bm, Cm)),
                      chunk=16, interpret=True)
    np.testing.assert_allclose(np.asarray(y), yseq, atol=2e-4)
    got, hl = ops.ssd(*(_t(a) for a in (x, dlogA, Bm, Cm)), chunk=16)
    np.testing.assert_allclose(got.numpy(), yseq, atol=2e-4)
    np.testing.assert_allclose(hl.numpy(), h.numpy(), atol=2e-4)


# ----------------------------------------------------- building blocks


def test_segsum_matches_repro():
    x = np.random.default_rng(1).standard_normal((3, 2, 9)).astype(
        np.float32)
    got = tssm.segsum(_t(x))
    assert tssm.segsum is ref.segsum
    _close(got, jssm.segsum(jnp.asarray(x)), BLOCK_TOL)
    assert torch.isneginf(got[..., 0, 1:]).all()


@pytest.mark.parametrize("chunk,with_h0", [(8, False), (16, True), (64, False)])
def test_ssd_ref_matches_repro(chunk, with_h0):
    b, l, H, p, n = 2, 32, 3, 8, 4
    arrays = _scan_inputs(b, l, H, p, n, seed=2, model_dt=True)
    h0 = (np.random.default_rng(3).standard_normal((b, H, p, n))
          .astype(np.float32) if with_h0 else None)
    y, hl = tssm.ssd_ref(*(_t(a) for a in arrays), chunk,
                         None if h0 is None else _t(h0))
    jy, jhl = jssm.ssd_ref(*(jnp.asarray(a) for a in arrays), chunk,
                           None if h0 is None else jnp.asarray(h0))
    _close(y, jy, BLOCK_TOL)
    _close(hl, jhl, BLOCK_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        tssm.ssd_ref(*(_t(a[:, :30]) for a in arrays), 16)


# K5's backward: the plain version's gradients against jax.vjp of
# `repro`'s oracle, each as a share of the gradient's largest element
# (fp32 sums in other orders: measured at most 6.4e-7); d dlogA's row and
# column terms nearly cancel, so it is held to its largest element too
BWD_TOL = 1e-5


@pytest.mark.parametrize("b,l,H,p,n,ch,with_h0,with_dhl,model_dt", [
    (2, 96, 3, 8, 4, 32, True, True, False),     # three chunks
    (2, 256, 4, 32, 16, 64, True, True, True),   # four, the model's dt
    (1, 128, 2, 16, 8, 32, False, True, False),  # no h0
    (2, 64, 16, 32, 16, 32, False, False, True),  # the reduced model's
    (1, 64, 1, 64, 32, 64, True, False, False)])  # one chunk
def test_ssd_bwd_ref_matches_jax_vjp(b, l, H, p, n, ch, with_h0, with_dhl,
                                     model_dt):
    x, dA, Bm, Cm = _scan_inputs(b, l, H, p, n, seed=l, model_dt=model_dt)
    rng = np.random.default_rng(n)
    h0 = (rng.standard_normal((b, H, p, n)) * 0.5).astype(np.float32) \
        if with_h0 else None
    dy = rng.standard_normal((b, l, H, p)).astype(np.float32)
    dhl = rng.standard_normal((b, H, p, n)).astype(np.float32) \
        if with_dhl else None
    args = [x, dA, Bm, Cm] + ([] if h0 is None else [h0])

    def f(*a):
        return jssm.ssd_ref(*a[:4], ch, a[4] if len(a) > 4 else None)
    (y, hl), vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(hl) if dhl is None
                else jnp.asarray(dhl)))
    got = ref.ssd_bwd_ref(*(_t(a) for a in (x, dA, Bm, Cm)), ch,
                          None if h0 is None else _t(h0), _t(dy),
                          None if dhl is None else _t(dhl))
    assert len(got) == 5 and (got[4] is None) == (h0 is None)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert tuple(g.shape) == w.shape
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=BWD_TOL)


def test_ops_ssd_on_cpu_is_differentiated_as_the_plain_version():
    """On CPU tensors `ops.ssd` is the plain version under autograd: its
    gradients are `ssd_bwd_ref`'s bit for bit, and no kernel launches."""
    x, dA, Bm, Cm = (_t(a) for a in _scan_inputs(2, 96, 3, 8, 4, seed=2))
    h0 = _t(np.random.default_rng(3).standard_normal((2, 3, 8, 4)))
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm, h0)]
    dy = torch.randn((2, 96, 3, 8), generator=torch.Generator().manual_seed(1))
    before = (k5.ssd.launches, k5.ssd_bwd.launches)
    y, _ = ops.ssd(*leaves[:4], chunk=32, h0=leaves[4])
    got = torch.autograd.grad(y, leaves, dy)
    assert (k5.ssd.launches, k5.ssd_bwd.launches) == before
    want = ref.ssd_bwd_ref(x, dA, Bm, Cm, 32, h0, dy, None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssd_decode_step_matches_repro():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((2, 3))).astype(np.float32)
    Bt, Ct = (rng.standard_normal((2, 4)).astype(np.float32)
              for _ in range(2))
    got = tssm.ssd_decode_step(*(_t(a) for a in (h, x, dA, Bt, Ct)))
    want = jssm.ssd_decode_step(*(jnp.asarray(a) for a in (h, x, dA, Bt, Ct)))
    for g, w in zip(got, want):
        _close(g, w, BLOCK_TOL)


@pytest.mark.parametrize("S", [1, 3, 20])
def test_depthwise_causal_conv_matches_repro(S):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    _close(tssm.depthwise_causal_conv(_t(x), _t(w)),
           jssm.depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w)),
           BLOCK_TOL)


def _block_pair(cfg_name=ARCH):
    """A reduced Mamba2 block's weights from `repro`'s init, as numpy, in
    the port's `MambaLayer` and in `repro`'s dict."""
    jcfg = jconfigs.get_config(cfg_name).reduced()
    jp = jssm.init_mamba_block(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # non-trivial scalars, so A, D and dt_bias take part
    rng = np.random.default_rng(8)
    H = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(rng.standard_normal(H) * 0.3, jnp.float32),
              D=jnp.asarray(rng.standard_normal(H), jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(H) * 0.5, jnp.float32))
    tcfg = tconfigs.get_config(cfg_name).reduced()
    layer = tlm.MambaLayer(tcfg, torch.float32, "cpu")
    layer.load_state_dict({k: _t(v) for k, v in jp.items()}, assign=True)
    return jcfg, tcfg, jp, layer


def test_mamba_block_matches_repro_on_both_branches():
    jcfg, tcfg, jp, layer = _block_pair()
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((B, 32, tcfg.d_model))).astype(np.float32)
    with torch.inference_mode():
        y, cache = tssm.mamba_block(layer, _t(x), tcfg)
        jy, jcache = jssm.mamba_block(jp, jnp.asarray(x), jcfg)
        _close_to_scale(y, jy)
        for name in ("h", "conv"):
            _close_to_scale(cache[name], jcache[name])
        assert cache["h"].dtype == torch.float32
        for t in range(3):   # three decode steps from that cache
            xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
            y, cache = tssm.mamba_block(layer, _t(xt), tcfg, cache)
            jy, jcache = jssm.mamba_block(jp, jnp.asarray(xt), jcfg, jcache)
            _close_to_scale(y, jy)
            for name in ("h", "conv"):
                _close_to_scale(cache[name], jcache[name])


def test_init_mamba_block_and_cache_match_repro():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jkey = jax.random.PRNGKey(11)
    jp = jssm.init_mamba_block(jkey, jcfg, jnp.bfloat16)
    tp = tssm.init_mamba_block(common.key_to_torch(jkey), tcfg,
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
    jc = jssm.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    tc = tssm.init_mamba_cache(tcfg, 3, torch.bfloat16)
    for name in ("h", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        assert not tc[name].any()


# -------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def jmodel():
    """Reduced mamba2-370m in `repro` with its init for key 1, and the
    port's model on the CPU carrying that init."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    model = build_model(tcfg, device="meta")
    model.load_state_dict(params, assign=True)
    return dict(jcfg=jcfg, cfg=tcfg, jm=jm, jparams=jparams, model=model,
                params=params)


@pytest.fixture(scope="module", params=[64, 16])
def served(request, jmodel):
    """`repro`'s prefill and greedy decode loop on a prompt of 64 (two
    chunks of 32, so the carried state runs) or 16 tokens (one short
    chunk)."""
    prompt = request.param
    jm, jparams = jmodel["jm"], jmodel["jparams"]
    tokens = np.random.default_rng(prompt).integers(
        0, jmodel["cfg"].vocab_size, (B, prompt)).astype(np.int32)
    logits, caches = jm.prefill(jparams, jnp.asarray(tokens),
                                cache_len=prompt + NEW)
    out = {"prefill_logits": np.asarray(logits),
           "prefill_caches": jax.tree.map(np.asarray, caches)}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(NEW - 1):
        logits, caches = dstep(jparams, caches, tok, jnp.int32(prompt + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    out.update(tokens=np.concatenate(toks, 1), step_logits=step_logits,
               caches=jax.tree.map(np.asarray, caches))
    return dict(jmodel, prompt=prompt, prompts=torch.from_numpy(tokens).long(),
                jax=out)


def _stacked(caches, name):
    return torch.stack([c[name] for c in caches]).numpy()


def test_prefill_logits_and_caches_match_repro(served):
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        logits, caches = model.prefill(served["prompts"],
                                       cache_len=served["prompt"] + NEW)
    _close(logits, j["prefill_logits"])
    assert len(caches) == served["cfg"].n_layers
    for name in ("h", "conv"):
        _close(_stacked(caches, name), j["prefill_caches"][name])
    assert caches[0]["h"].dtype == torch.float32


def test_decode_steps_match_repro(served):
    """Eight decode_step logits and the caches after them, teacher-forced
    with `repro`'s greedy tokens."""
    model, j = served["model"], served["jax"]
    assert len(j["step_logits"]) == 8
    with torch.inference_mode():
        _, caches = model.prefill(served["prompts"])
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               served["prompt"] + t)
            _close(logits, want)
    for name in ("h", "conv"):
        _close(_stacked(caches, name), j["caches"][name])


def test_generate_matches_repro_greedy_serve(served):
    before = k5.ssd.launches
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         NEW)
    assert k5.ssd.launches == before   # the CPU's plain path
    j = served["jax"]
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])


def test_init_matches_repro_within_ulps(jmodel):
    """The port's own init draws `repro`'s key tree (``split(ks[2],
    n_layers)``, then ``split(key, 5)`` per block); each leaf within 1e-5
    of its largest value (`prng.normal`'s ulps), the SSM scalars float32."""
    model = build_model(jmodel["cfg"], device="cpu")
    own = model.init(prng.PRNGKey(1))
    assert set(own) == set(jmodel["params"])
    for name, want in jmodel["params"].items():
        assert own[name].dtype == want.dtype, name
        torch.testing.assert_close(own[name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_decode_matches_teacher_forced(jmodel):
    """The port alone: prefill 16 then decode 8 equals the prefills of
    17 .. 24 tokens (each one chunk), and decoding from an empty cache
    equals the prefill of the same tokens."""
    model, cfg = jmodel["model"], jmodel["cfg"]
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, 24))).long()
    with torch.inference_mode():
        _, caches = model.prefill(tokens[:, :16])
        for t in range(16, 24):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
            want, _ = model.prefill(tokens[:, :t + 1])
            torch.testing.assert_close(logits, want, atol=5e-5, rtol=1e-4)
        caches = model.init_cache(B, 24)
        for t in range(6):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
        want, _ = model.prefill(tokens[:, :6])
        torch.testing.assert_close(logits, want, atol=5e-5, rtol=1e-4)


def test_short_prompt_raises(jmodel):
    """`repro` builds no cache for a prompt shorter than ssm_conv - 1 and
    then decodes without state; the port refuses it."""
    with torch.inference_mode(), pytest.raises(ValueError, match="conv"):
        jmodel["model"].prefill(torch.zeros((1, 2), dtype=torch.long))
    with torch.inference_mode():
        logits, caches = jmodel["model"].prefill(
            torch.zeros((1, 3), dtype=torch.long))
    assert caches[0]["conv"].shape[1] == 3 and torch.isfinite(logits).all()


# --------------------------------------------------- building and carrying


def test_full_config_builds_on_meta_and_carries_repro_tree():
    cfg = tconfigs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == 419_714_560
    assert isinstance(model.layers[0], tlm.MambaLayer)
    assert model.layers[0].A_log.dtype == torch.float32
    assert model.layers[0].in_proj.dtype == torch.bfloat16
    # the tree of `repro`'s init (shapes only: an (abstract) bf16 init)
    jcfg = jconfigs.get_config(ARCH).reduced().replace(dtype="bfloat16")
    tcfg = tconfigs.get_config(ARCH).reduced().replace(dtype="bfloat16")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = lm_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        device="cpu")
    small = build_model(tcfg, device="meta")
    assert set(params) == set(small.state_dict())
    for name, t in params.items():
        assert t.shape == small.state_dict()[name].shape, name
        assert t.dtype == small.state_dict()[name].dtype, name
    assert params["layers.1.dt_bias"].dtype == torch.float32
    assert params["layers.1.conv_w"].dtype == torch.bfloat16
    small.load_state_dict(params, assign=True)


# ------------------------------------------------------------ refusals


def test_backward_source_is_registered_for_nvcc():
    assert _build.SOURCES["ssd_bwd"] == "ssd_bwd.cu"
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    assert 'extern "C" int ssd_bwd_f32(' in src
    assert 'extern "C" const char* ssd_bwd_error_string(' in src
    assert '#include "ssd.cuh"' in src
    assert "repro/kernels/ssd.py::ssd" in src and "atomic" not in \
        src.replace("no atomics", "")
    # the six launches with the plan's grids and shared memory
    for launch in ("static_cast<size_t>(grid[1])",
                   "static_cast<size_t>(grid[5])",
                   "static_cast<size_t>(grid[7])",
                   "static_cast<size_t>(grid[9])",
                   "static_cast<size_t>(grid[11])"):
        assert launch in src
    assert k5.BWD_WORKSPACES == ("dst", "sc", "bt", "lam", "wp", "mp", "sd",
                                 "sv")


def test_backward_wrapper_never_takes_the_plain_version():
    """On CPU tensors `ssd_bwd` raises before any build (ops picks the
    plain version, which autograd differentiates, by device)."""
    x, dA, Bm, Cm = (_t(a) for a in _scan_inputs(1, 64, 2, 16, 8))
    plan = k5.launch_plan(1, 64, 2, 16, 8, 32)
    cum = torch.zeros(plan.workspace["cum"])
    states = torch.zeros(plan.workspace["states"])
    before = k5.ssd_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        k5.ssd_bwd(x, dA, Bm, Cm, 32, None, torch.zeros_like(x), None, cum,
                   states)
    with pytest.raises(TypeError):
        k5.ssd_bwd(x.bfloat16(), dA, Bm, Cm, 32, None, torch.zeros_like(x),
                   None, cum, states)
    assert k5.ssd_bwd.launches == before


def test_kernel_wrapper_never_takes_the_plain_version():
    """On CPU tensors the wrapper raises (ops picks the plain version by
    device); it refuses what the kernel does not take before any build."""
    x, dA, Bm, Cm = (_t(a) for a in _scan_inputs(1, 64, 2, 16, 8))
    before = k5.ssd.launches
    with pytest.raises(ValueError, match="CUDA"):
        k5.ssd(x, dA, Bm, Cm, chunk=32)
    with pytest.raises(TypeError):
        k5.ssd(x.bfloat16(), dA, Bm, Cm, chunk=32)
    with pytest.raises(TypeError):
        k5.ssd(x, dA.double(), Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="not divisible"):
        k5.ssd(x, dA, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="state"):
        k5.ssd(x, dA, Bm[..., :6], Cm[..., :6], chunk=32)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 64, 2, 129))
        k5.ssd(big, dA, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dA, Bm, Cm,
               chunk=32)
    with pytest.raises(ValueError, match="h0"):
        k5.ssd(x, dA, Bm, Cm, chunk=32, h0=torch.zeros((1, 2, 16, 4)))
    with pytest.raises(ValueError, match="match"):
        k5.ssd(x, dA[:, :32], Bm, Cm, chunk=32)
    # a chunk of 16,384 steps at p 128 is taken (no block's shared memory
    # grows with the chunk), so on the CPU only the device is refused
    with pytest.raises(ValueError, match="CUDA"):
        k5.ssd(torch.zeros((1, 16384, 1, 128)), torch.zeros((1, 16384, 1)),
               torch.zeros((1, 16384, 128)), torch.zeros((1, 16384, 128)),
               chunk=16384)
    assert k5.ssd.launches == before


def test_kernel_source_is_registered_for_nvcc():
    assert _build.SOURCES["ssd"] == "ssd.cu"
    # the tile shapes and copies live in the header the backward shares
    src = (_build.CSRC / "ssd.cu").read_text() + \
        (_build.CSRC / "ssd.cuh").read_text()
    assert '#include "ssd.cuh"' in src
    assert 'extern "C" int ssd_f32(' in src
    assert 'extern "C" const char* ssd_error_string(' in src
    assert "repro/kernels/ssd.py::ssd" in src
    # the shared memory the wrapper launches each kernel with
    # (smem_bytes) covers what the kernel carves out of it: pass 1's state
    # blocks, B and x tiles two deep, the scan's 4 warp totals and its last
    # sum; its score blocks, C and B tiles of 64 rows of n + 4; pass 3's
    # transposed score tiles (rows of 68), x tiles two deep and 192 prefix
    # sums; pass 2 has only static shared memory
    for carve in ("float* x_s = b_s + 2 * kT * kN;",
                  "float* warp_s = x_s + 2 * kT * PW;  // [kWarps + 1]",
                  "float* b_s = c_s + kT * kCP;  // [kT][kCP]",
                  "float* x_s = g_s + 2 * kT * kGP;",
                  "float* cq_s = x_s + 2 * kT * PW;",
                  "float* ck_s = cq_s + kT;                       // [2][kT]",
                  "kThreads = 128", "kN = 128", "kGP = kT + 4"):
        assert carve in src
    assert k5.smem_bytes(64) == {
        "chunk": 4 * (2 * 64 * 128 + 2 * 64 * 64 + 5),
        "output": 4 * (2 * 64 * 68 + 2 * 64 * 64 + 192)}
    assert k5.smem_bytes(128) == {
        "chunk": 4 * (2 * 64 * 128 + 2 * 64 * 128 + 5),
        "output": 4 * (2 * 64 * 68 + 2 * 64 * 128 + 192)}
    # and the kernels launch with it, not with sizes of their own
    assert "static_cast<size_t>(grid[1])" in src and \
        "static_cast<size_t>(grid[5])" in src


def test_serve_main_on_cpu(capsys):
    before = k5.ssd.launches
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "4"])
    assert k5.ssd.launches == before   # the CPU's plain path
    out = capsys.readouterr().out
    assert "prefill B=2 S=8" in out
    assert "decoded 3 steps x 2 seqs" in out
