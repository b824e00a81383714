"""The port's audio family (`repro_torch.models.whisper`) against `repro`'s
`WhisperModel` on the CPU, at whisper-medium's reduced config (2 encoder
and 2 decoder layers of width 256, 4 heads of 64, 16 frames, vocab 512),
from seeded numpy inputs:

* the building blocks: `layer_norm`, `sinusoidal_positions` (1,500
  positions; the frequencies with XLA's exp bits, `xla_exp`) and the
  tanh GELU, within 1e-6;
* the reduced init bit for bit (the attention's K and V with n_heads
  heads: (256, 256), where n_kv_heads 2 would give (256, 128)), and a
  meta build of the full config: 758,248,448 weights, every leaf's shape
  `jax.eval_shape`'s;
* from `repro`'s weights (TOL = 1e-5): `encode`, the prefill's logits
  and every cache tensor (positions exactly), 8 decode steps
  (teacher-forced with `repro`'s greedy tokens) and `serve.generate`'s
  tokens; decode from an empty cache equal to the prefill
  (tests/test_models.py's check);
* the loss and every gradient against ``jax.value_and_grad`` (GRAD_TOL
  of each leaf's largest element), remat "full" bit for bit "none";
  zero frames keep the gradients finite at 24 + 24 layers, in both;
* where each attention runs: K4 (`ops.flash_attention`) causal or not,
  counted through a spy;
* both CLIs' lines against `repro`'s, the audio steps of `launch.steps`,
  checkpoints crossing both ways;
* K4's plain version against the Pallas kernel in interpret mode, non-
  causal at Sq 64 against Sk 1,500 (``block_k`` 300).
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_fa  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.interop import (LM_FAMILIES,  # noqa: E402
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import WhisperModel  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

ROOT = common.ROOT
ARCH = "whisper-medium"
TOL = 1e-5
BLOCK_TOL = 1e-6
GRAD_TOL = 2e-4     # tests/test_torch_train.py's, per leaf
B = 2
PROMPT, NEW = 8, 9        # 8 decode steps after the prefill's token
SEQ = 16                  # the loss's tokens
#: whisper-medium's weights (jax.eval_shape of `repro`'s init)
FULL_WEIGHTS = 758_248_448


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=msg)


# --------------------------------------------------------- building blocks


@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 5, 1024)])
def test_layer_norm_matches_repro(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tcommon.layer_norm(_t(x), _t(w), _t(b))
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("d_model", [256, 1024])
def test_sinusoidal_positions_match_repro(d_model):
    """1,500 positions (whisper's frames): the frequencies bit for bit
    (`xla_exp`), the table within an ulp of each value."""
    pos = np.arange(1500)
    want = np.asarray(jcommon.sinusoidal_positions(jnp.asarray(pos),
                                                   d_model))
    got = tcommon.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (1500, d_model)
    _close(got, want, BLOCK_TOL)
    half = d_model // 2
    arg = -jnp.arange(half, dtype=jnp.float32) * (
        np.log(10000.0) / max(half - 1, 1))
    np.testing.assert_array_equal(
        tcommon.xla_exp(torch.from_numpy(np.array(arg))).numpy(),
        np.asarray(jnp.exp(arg)))


def test_xla_exp_is_xlas_exp_bit_for_bit():
    """Over the normal results (XLA flushes subnormal ones, below
    exp(-87.33), to zero)."""
    x = np.linspace(-87, 88, 40001, dtype=np.float32)
    np.testing.assert_array_equal(tcommon.xla_exp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.exp(jnp.asarray(x))))


def test_gelu_matches_repro():
    x = np.random.default_rng(1).standard_normal((4, 4096)).astype(
        np.float32) * 3
    want = jax.nn.gelu(jnp.asarray(x), approximate=True)
    _close(tcommon.gelu_tanh(_t(x)), want, BLOCK_TOL)


# -------------------------------------------------------------------- init


def test_reduced_init_is_repros_bit_for_bit():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    assert tcfg.n_kv_heads == 2 and tcfg.n_heads == 4
    want = lm_params_from_jax(
        jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0))),
        tcfg, device="cpu")
    model = build_model(tcfg, device="meta")
    assert isinstance(model, WhisperModel) and "audio" in LM_FAMILIES
    own = model.init(prng.PRNGKey(0))
    assert sorted(own) == sorted(want)
    for name, t in own.items():
        assert torch.equal(t, want[name]), name
    for name in ("enc_layers.0.attn.wk", "dec_layers.1.cross_attn.wv",
                 "dec_layers.0.self_attn.wk"):
        assert own[name].shape == (256, 256), name


def test_full_config_builds_on_meta_with_repros_shapes():
    jcfg = jconfigs.get_config(ARCH)
    cfg = tconfigs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == FULL_WEIGHTS
    tree = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        if keys[0] in ("enc_layers", "dec_layers"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = \
                    tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    assert shapes == want


def test_building_whisper_imports_no_jax():
    code = ("import sys\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.models import WhisperModel, build_model\n"
            "m = build_model(get_config('whisper-medium'), device='meta')\n"
            "assert isinstance(m, WhisperModel)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules), 'repro was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


# --------------------------------------------------------- serving vs repro


@pytest.fixture(scope="module")
def served():
    """The reduced whisper served by both packages on `repro`'s init of
    PRNGKey(1): `repro`'s prefill of seeded frames and prompts and its
    greedy decode loop, and the port's model on the CPU carrying that
    init."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = rng.standard_normal(
        (B, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
    total = PROMPT + NEW
    logits, state = jm.prefill(jparams, jnp.asarray(tokens),
                               jnp.asarray(frames), cache_len=total)
    jout = {"enc_out": np.asarray(jm.encode(jparams, jnp.asarray(frames))),
            "prefill_logits": np.asarray(logits),
            "prefill_enc": np.asarray(state[0]),
            "prefill_caches": jax.tree.map(np.asarray, state[1])}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(NEW - 1):
        logits, state = dstep(jparams, state, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    jout.update(tokens=np.concatenate(toks, 1), step_logits=step_logits,
                caches=jax.tree.map(np.asarray, state[1]))
    np_params = jax.tree.map(np.asarray, jparams)
    model = build_model(tcfg, device="meta")
    params = lm_params_from_jax(np_params, tcfg, device="cpu")
    model.load_state_dict(params, assign=True)
    return dict(jcfg=jcfg, cfg=tcfg, model=model, params=params,
                np_params=np_params, jparams=jparams, jm=jm,
                prompts=torch.from_numpy(tokens).long(),
                frames=_t(frames), total=total, jax=jout)


def _stacked(caches, name):
    return torch.stack([c[name] for c in caches]).numpy()


def test_model_layers_hold_repros_leaves(served):
    model = served["model"]
    assert len(model.enc_layers) == served["cfg"].n_enc_layers == 2
    assert len(model.dec_layers) == served["cfg"].n_layers == 2
    assert sorted(model.state_dict()) == sorted(served["params"])
    assert "dec_layers.1.cross_attn.wk" in served["params"]
    assert "enc_norm.b" in served["params"]


def test_encode_matches_repro(served):
    with torch.inference_mode():
        got = served["model"].encode(served["frames"])
    _close(got, served["jax"]["enc_out"])


def test_prefill_logits_and_caches_match_repro(served):
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        logits, (enc_out, caches) = model.prefill(
            served["prompts"], served["frames"], cache_len=served["total"])
    _close(logits, j["prefill_logits"])
    _close(enc_out, j["prefill_enc"])
    assert len(caches) == served["cfg"].n_layers
    assert caches[0]["k"].shape == (B, served["total"], 4, 64)
    for name in ("k", "v"):
        _close(_stacked(caches, name), j["prefill_caches"][name])
    np.testing.assert_array_equal(_stacked(caches, "pos"),
                                  j["prefill_caches"]["pos"])


def test_prefill_cache_is_at_least_the_prompt(served):
    """`repro`'s ``max(cache_len or S, S)``: a shorter cache_len still
    holds the prompt."""
    with torch.inference_mode():
        _, (_, caches) = served["model"].prefill(
            served["prompts"], served["frames"], cache_len=3)
    assert caches[0]["k"].shape[1] == PROMPT


def test_decode_steps_match_repro(served):
    """Eight decode_step logits and the caches after them, teacher-forced
    with `repro`'s greedy tokens, from position S."""
    model, j = served["model"], served["jax"]
    assert len(j["step_logits"]) == 8
    with torch.inference_mode():
        _, state = model.prefill(served["prompts"], served["frames"],
                                 cache_len=served["total"])
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, state = model.decode_step(state, tokens[:, t:t + 1],
                                              PROMPT + t)
            _close(logits, want)
    for name in ("k", "v"):
        _close(_stacked(state[1], name), j["caches"][name])
    np.testing.assert_array_equal(_stacked(state[1], "pos"),
                                  j["caches"]["pos"])


def test_generate_matches_repro_greedy_serve(served):
    before = k4.flash_attention.launches
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         NEW, frames=served["frames"])
    assert k4.flash_attention.launches == before   # the CPU's plain path
    j = served["jax"]
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])
    again = serve.generate(served["model"], None, served["prompts"], NEW,
                           frames=served["frames"])
    assert torch.equal(again.tokens, gen.tokens)
    with pytest.raises(ValueError, match="frames"):
        serve.generate(served["model"], None, served["prompts"], NEW)


def test_decode_from_an_empty_cache_equals_the_prefill(served):
    """tests/test_models.py's check on the port: the prompt decoded token
    by token from empty rings gives the prefill's last logits."""
    model = served["model"]
    with torch.inference_mode():
        logits_p, _ = model.prefill(served["prompts"], served["frames"],
                                    cache_len=12)
        state = (model.encode(served["frames"]), model.init_cache(B, 12))
        for t in range(PROMPT):
            logits, state = model.decode_step(
                state, served["prompts"][:, t:t + 1], t)
    torch.testing.assert_close(logits, logits_p, atol=5e-5, rtol=1e-4)


def test_steps_are_repros_audio_steps(served):
    """`make_prefill_step` takes the batch's frames and `make_decode_step`
    (enc_out, caches, token, pos), as `repro.launch.steps`; both equal
    the model's methods and `repro`'s steps."""
    model, j = served["model"], served["jax"]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    jprefill = jsteps.make_prefill_step(served["jm"], served["jcfg"])
    jdecode = jsteps.make_decode_step(served["jm"], served["jcfg"])
    with torch.inference_mode():
        # no cache_len: rings of the prompt's length in both packages, so
        # the first decode step overwrites slot 0 in both
        logits, (enc_out, caches) = prefill(
            {"tokens": served["prompts"], "frames": served["frames"]})
        want, (_, want_caches) = model.prefill(served["prompts"],
                                               served["frames"])
        assert torch.equal(logits, want)
        tok = logits.argmax(-1, keepdim=True)
        got, caches = decode(enc_out, caches, tok, PROMPT)
        assert isinstance(caches, list) and len(caches) == 2
        want, _ = model.decode_step((enc_out, want_caches), tok, PROMPT)
        assert torch.equal(got, want)
    jlogits, (jenc, jcaches) = jprefill(
        served["jparams"], {"tokens": jnp.asarray(served["prompts"].numpy()),
                            "frames": jnp.asarray(served["frames"].numpy())})
    _close(jlogits, j["prefill_logits"])
    jgot, _ = jdecode(served["jparams"], jenc, jcaches,
                      jnp.asarray(tok.numpy(), jnp.int32), jnp.int32(PROMPT))
    _close(got, jgot)


def test_attention_runs_on_k4_where_the_keys_are_one_tensor(served,
                                                            monkeypatch):
    """The K4 op (`ops.flash_attention`) in the encoder (non-causal over
    the frames), the decoder's self-attention (causal) and every
    cross-attention (non-causal, Sk = frames), in the prefill, in decode
    (cross only) and in the loss (under remat "full" twice a layer when
    the backward recomputes)."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True, window=None):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ops, "flash_attention", spy)
    model, T = served["model"], served["cfg"].n_audio_frames
    with torch.inference_mode():
        _, state = model.prefill(served["prompts"], served["frames"],
                                 cache_len=served["total"])
        assert calls == [(False, T, T)] * 2 + [(True, PROMPT, PROMPT),
                                               (False, PROMPT, T)] * 2
        calls.clear()
        model.decode_step(state, served["prompts"][:, :1], PROMPT)
        assert calls == [(False, 1, T)] * 2
    calls.clear()
    train_model = _train_model(served, "full")
    _, tb = _loss_batches(served)
    loss, _ = train_model.loss(tb)
    assert len(calls) == 6
    torch.autograd.grad(loss, list(train_model.parameters()))
    assert len(calls) == 12   # each layer's forward again in the backward


# ----------------------------------------------------------------- training


def _loss_batches(served, seed=3, frames=None):
    rng = np.random.default_rng(seed)
    cfg = served["jcfg"]
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    if frames is None:
        frames = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": _t(tokens, torch.long), "frames": _t(frames)})


def _train_model(served, remat="full"):
    m = build_model(served["cfg"], device="meta", remat=remat,
                    loss_chunks=4)
    m.load_state_dict(lm_params_from_jax(served["np_params"], served["cfg"],
                                         device="cpu"), assign=True)
    return m


def test_loss_and_gradients_match_repro(served):
    """`loss` (frames encoded, every position weighted) and its gradients
    against ``jax.value_and_grad(model.loss)`` of a model with
    loss_chunks 4."""
    jm = jbuild(served["jcfg"], loss_chunks=4)
    jb, tb = _loss_batches(served)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        served["jparams"], jb)
    model = _train_model(served)
    loss, aux = model.loss(tb)
    _close(loss.detach(), jloss)
    _close(aux["ce"].detach(), jaux["ce"])
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = lm_params_from_jax(jax.tree.map(np.asarray, jgrads),
                              served["cfg"], device="cpu")
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_remat_full_equals_none_bit_for_bit(served):
    _, tb = _loss_batches(served)
    out = {}
    for remat in ("full", "none"):
        model = _train_model(served, remat)
        loss, _ = model.loss(tb)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                list(model.parameters())))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_zero_frames_keep_the_gradients_finite_at_full_depth_in_both():
    """`repro.launch.train` feeds zero frames. Unlike the vlm's zero
    vision rows (tests/test_torch_lm_families.py), the encoder adds its
    sinusoidal positions, so no row is zero: at whisper-medium's 24 + 24
    layers (reduced width) the gradients stay finite in `repro` and in
    the port, and agree."""
    jcfg = jconfigs.get_config(ARCH).reduced().replace(n_layers=24,
                                                       n_enc_layers=24)
    tcfg = tconfigs.get_config(ARCH).reduced().replace(n_layers=24,
                                                       n_enc_layers=24)
    jm = jbuild(jcfg, loss_chunks=4)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(tcfg, device="meta", loss_chunks=4)
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), assign=True)
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    frames = np.zeros((2, tcfg.n_audio_frames, tcfg.d_model), np.float32)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, {
        "tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})[0])(
        jparams)
    loss, _ = model.loss({"tokens": _t(tokens, torch.long),
                          "frames": _t(frames)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree.leaves(jgrads))
    assert all(torch.isfinite(g).all() for g in grads)
    _close(loss.detach(), jloss)


def test_checkpoints_cross_both_ways(served, tmp_path):
    """The port's state as `repro`'s tree, saved by the port and loaded by
    `repro.checkpoint` into `repro`'s init, is `repro`'s weights; and
    `repro`'s saved tree loads into the port's state."""
    cfg = served["cfg"]
    tree = lm_params_to_jax(served["params"], cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(
        served["np_params"])
    save_pytree(str(tmp_path / "port"), tree)
    back = jckpt.load_pytree(str(tmp_path / "port"), served["jparams"])
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(served["np_params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_pytree(str(tmp_path / "repro"), served["jparams"])
    got = load_pytree(str(tmp_path / "repro"), tree)
    got = lm_params_from_jax(jax.tree.map(lambda t: t.numpy(), got), cfg,
                             device="cpu")
    assert sorted(got) == sorted(served["params"])
    for name, t in got.items():
        assert torch.equal(t, served["params"][name]), name
    with pytest.raises(ValueError, match="enc_layers"):
        lm_params_from_jax({**served["np_params"], "enc_layers": jax.tree.map(
            lambda a: a[:1], served["np_params"]["enc_layers"])}, cfg,
            device="cpu")


def test_train_defaults_to_repros_zero_frames(served, monkeypatch):
    """`launch.train.train` feeds zero frames unless given others."""
    seen = []
    model = _train_model(served)
    real = model.loss

    def spy(batch):
        seen.append(batch["frames"].clone())
        return real(batch)
    monkeypatch.setattr(model, "loss", spy)
    corpus = ttrain.lm_corpus(served["cfg"], B, 8)
    ttrain.train(model, corpus, steps=1, batch=B, lr=1e-4)
    frames = torch.ones((B, served["cfg"].n_audio_frames,
                         served["cfg"].d_model))
    ttrain.train(model, corpus, steps=1, batch=B, lr=1e-4, frames=frames)
    assert seen[0].shape == frames.shape and not seen[0].any()
    assert torch.equal(seen[1], frames)


# ------------------------------------------------------- the entry points


def test_serve_cli_matches_repro_cli(monkeypatch, capsys):
    """The same flags give `repro`'s CLI run: `repro`'s prompts, zero
    frames, and `repro`'s sample ids from the port's own init."""
    seen = []
    generate = serve.generate

    def spy(model, params, prompts, *args, **kw):
        seen.append(kw.get("frames"))
        return generate(model, params, prompts, *args, **kw)

    monkeypatch.setattr(serve, "generate", spy)
    flags = ["--arch", ARCH, "--batch", "2", "--prompt-len", "8",
             "--new-tokens", "6"]
    serve.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    jax_out = capsys.readouterr().out
    cfg = jconfigs.get_config(ARCH).reduced()
    assert seen[0].shape == (2, cfg.n_audio_frames, cfg.d_model)
    assert not seen[0].any()

    def lines(out, prefix):
        return [re.sub(r":.*", "", line) if prefix == "prefill" else line
                for line in out.splitlines() if line.startswith(prefix)]
    assert lines(port_out, "prefill") == lines(jax_out, "prefill")
    ids = lines(port_out, "sample token ids:")
    assert len(ids) == 1 and ids == lines(jax_out, "sample token ids:")


def _loss_lines(text):
    return [(int(m.group(1)), float(m.group(2))) for m in
            re.finditer(r"step\s+(\d+) loss (\d+\.\d+) \(", text)]


def test_train_main_matches_repros_loss_lines(monkeypatch, capsys):
    """`launch.train.main` against `repro.launch.train` for 3 steps from
    the same seed (zero frames): the same first line and loss lines
    within 1e-4, and no K4 launch on the CPU."""
    flags = ["--reduced", "--arch", ARCH, "--steps", "3", "--batch", "2",
             "--seq", "16", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    before = (k4.flash_attention.launches, k4.flash_attention_bwd.launches)
    run = ttrain.main(["--device", "cpu", *flags])
    got = capsys.readouterr().out
    assert (k4.flash_attention.launches,
            k4.flash_attention_bwd.launches) == before
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    assert got.splitlines()[-1] == "done."
    jl, tl = _loss_lines(want), _loss_lines(got)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2]
    for (_, a), (_, b), full in zip(tl, jl, run.losses):
        assert abs(a - b) <= 1e-4 and abs(full - b) <= 5e-5 + 1e-5


# ---------------------------------------------------- K4 at whisper's shape


def test_k4_plain_version_matches_pallas_non_causal_over_1500_keys():
    """The cross-attention's shape cut in batch and heads: 64 queries
    against 1,500 keys, non-causal, the Pallas kernel in interpret mode
    with key blocks of 300."""
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((1, 64, 2, 64)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((1, 1500, 2, 64)) * 0.5).astype(np.float32)
    v = rng.standard_normal((1, 1500, 2, 64)).astype(np.float32)
    want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, block_q=64, block_k=300, interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
