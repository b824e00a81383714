"""The port's vlm and moe LM families against `repro`'s on the CPU, at
their reduced configs: internvl2-2b (dense layers behind 8 vision
embeddings), qwen3-moe-30b-a3b (qk-norm, 4 experts top 2) and
kimi-k2-1t-a32b (4 experts top 2), with `repro`'s weights carried across
(`repro_torch.interop.lm_params_from_jax`), within TOL = 1e-5:

* prefill logits, every cache tensor, 8 decode steps (teacher-forced
  with `repro`'s greedy tokens) and `serve.generate`'s greedy tokens;
  the vlm's vision embeddings drawn from a seed, its decode positions
  counted after them;
* the port's own init within `prng.normal`'s ulps, the router float32;
* `DecoderLM.loss`: the total, its ce and the router's aux, and every
  gradient (GRAD_TOL of each leaf's largest element); remat "full"
  bit for bit "none"; the ragged dispatch against `repro`'s;
* the serve CLI's sample ids and `launch.train.main`'s loss lines (3
  steps, within 1e-4) against `repro`'s CLIs;
* checkpoints crossing both ways.

The smallest gap between the k-th and (k+1)-th router probability is
checked in each moe run: a tie within an ulp could route differently
in the two packages without a fault of the port's.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import re  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.interop import (lm_params_from_jax,  # noqa: E402
                                 lm_params_to_jax)
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5
GRAD_TOL = 2e-4     # tests/test_torch_train.py's, per leaf
B = 2
ARCHS = ("internvl2-2b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
PROMPT, NEW = 16, 9       # 8 decode steps after the prefill's token
SEQ = 16                  # the loss's tokens


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=msg)


def router_gap(model, tokens, vision=None):
    """The smallest top-k gap of the MoE layers' routers over a prefill of
    ``tokens`` (forward hooks on each layer's `MoE`), or None for a model
    without MoE layers."""
    gaps = []

    def hook(mod, args, out):
        x = args[0]
        probs = tmoe.router_probs(x.reshape(-1, x.shape[-1]), mod.router)
        gaps.append(float(tmoe.router_gap(probs, args[1].topk)))
    hooks = [layer.moe.register_forward_hook(hook) for layer in model.layers
             if isinstance(layer, tlm.MoELayer)]
    try:
        with torch.inference_mode():
            model.prefill(tokens, vision=vision)
    finally:
        for h in hooks:
            h.remove()
    return min(gaps) if gaps else None


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch served by both packages on `repro`'s init of
    PRNGKey(1): `repro`'s prefill (after seeded vision embeddings for the
    vlm) and greedy decode loop, and the port's model on the CPU carrying
    that init."""
    arch = request.param
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    vision = None
    Nv = 0
    if jcfg.family == "vlm":
        Nv = jcfg.n_vision_tokens
        vision = rng.standard_normal((B, Nv, jcfg.d_model)).astype(
            np.float32)
    total = Nv + PROMPT + NEW
    jvis = None if vision is None else jnp.asarray(vision)
    logits, caches = jm.prefill(jparams, jnp.asarray(tokens), vision=jvis,
                                cache_len=total)
    jout = {"prefill_logits": np.asarray(logits),
            "prefill_caches": jax.tree.map(np.asarray, caches)}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(NEW - 1):
        logits, caches = dstep(jparams, caches, tok,
                               jnp.int32(Nv + PROMPT + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    jout.update(tokens=np.concatenate(toks, 1), step_logits=step_logits,
                caches=jax.tree.map(np.asarray, caches))
    np_params = jax.tree.map(np.asarray, jparams)
    model = build_model(tcfg, device="meta")
    params = lm_params_from_jax(np_params, tcfg, device="cpu")
    model.load_state_dict(params, assign=True)
    gap = router_gap(model, torch.from_numpy(tokens).long())
    if gap is not None:
        assert gap > 1e-6, f"{arch}: a router near-tie ({gap}), not the port's"
    return dict(arch=arch, jcfg=jcfg, cfg=tcfg, model=model, params=params,
                np_params=np_params, jparams=jparams, jm=jm,
                prompts=torch.from_numpy(tokens).long(),
                vision=None if vision is None else _t(vision), Nv=Nv,
                total=total, jax=jout)


def _stacked(caches, name):
    return torch.stack([c[name] for c in caches]).numpy()


def test_model_layers_are_the_familys(served):
    cfg, model = served["cfg"], served["model"]
    kind = tlm.MoELayer if cfg.family == "moe" else tlm.DenseLayer
    assert all(type(layer) is kind for layer in model.layers)
    assert sorted(model.state_dict()) == sorted(served["params"])
    if cfg.family == "moe":
        assert served["params"]["layers.0.moe.router"].shape == \
            (cfg.d_model, cfg.n_experts)


def test_prefill_logits_and_caches_match_repro(served):
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        logits, caches = model.prefill(served["prompts"],
                                       vision=served["vision"],
                                       cache_len=served["total"])
    _close(logits, j["prefill_logits"])
    assert len(caches) == served["cfg"].n_layers
    assert caches[0]["k"].shape[1] == served["total"]
    for name in ("k", "v"):
        _close(_stacked(caches, name), j["prefill_caches"][name])
    np.testing.assert_array_equal(_stacked(caches, "pos"),
                                  j["prefill_caches"]["pos"])


def test_decode_steps_match_repro(served):
    """Eight decode_step logits and the caches after them, teacher-forced
    with `repro`'s greedy tokens, from position Nv + S."""
    model, j = served["model"], served["jax"]
    start = served["Nv"] + PROMPT
    assert len(j["step_logits"]) == 8
    with torch.inference_mode():
        _, caches = model.prefill(served["prompts"], vision=served["vision"],
                                  cache_len=served["total"])
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               start + t)
            _close(logits, want)
    for name in ("k", "v"):
        _close(_stacked(caches, name), j["caches"][name])
    np.testing.assert_array_equal(_stacked(caches, "pos"), j["caches"]["pos"])


def test_generate_matches_repro_greedy_serve(served):
    before = k4.flash_attention.launches
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         NEW, vision=served["vision"])
    assert k4.flash_attention.launches == before   # the CPU's plain path
    j = served["jax"]
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])
    again = serve.generate(served["model"], None, served["prompts"], NEW,
                           vision=served["vision"])
    assert torch.equal(again.tokens, gen.tokens)
    assert torch.equal(again.last_logits, gen.last_logits)


def test_steps_are_the_model_methods(served):
    model = served["model"]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    batch = {"tokens": served["prompts"]}
    if served["vision"] is not None:
        batch["vision"] = served["vision"]
    with torch.inference_mode():
        logits, caches = prefill(batch, cache_len=served["total"])
        want, want_caches = model.prefill(served["prompts"],
                                          vision=served["vision"],
                                          cache_len=served["total"])
        assert torch.equal(logits, want)
        tok = logits.argmax(-1, keepdim=True)
        pos = served["Nv"] + PROMPT
        got, _ = decode(caches, tok, pos)
        want, _ = model.decode_step(want_caches, tok, pos)
        assert torch.equal(got, want)


def test_init_matches_repro_within_ulps(served):
    """The port's own init draws `repro`'s key tree (an MoE layer's from
    split(key, 2), its experts from split(ks[1], 4)); its normal sampler
    may differ from jax's by a few ulps, so each leaf is held within
    1e-5 of its largest value. The router is float32 in a bf16 model."""
    model = build_model(served["cfg"], device="cpu")
    own = model.init(prng.PRNGKey(1))
    assert set(own) == set(served["params"])
    for name, want in served["params"].items():
        torch.testing.assert_close(own[name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)
    bf16 = served["cfg"].replace(dtype="bfloat16")
    state = lm_params_from_jax(served["np_params"], bf16, device="cpu")
    for name, t in state.items():
        want = torch.float32 if name.endswith("moe.router") \
            else torch.bfloat16
        assert t.dtype == want, name
    assert build_model(bf16, device="meta").load_state_dict(
        state, assign=True)


def _loss_batches(served, seed=3):
    rng = np.random.default_rng(seed)
    cfg = served["jcfg"]
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    mask = (rng.random((B, SEQ + 1)) > 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    tb = {"tokens": _t(tokens, torch.long), "mask": _t(mask)}
    if cfg.family == "vlm":
        vis = rng.standard_normal((B, cfg.n_vision_tokens,
                                   cfg.d_model)).astype(np.float32)
        jb["vision"], tb["vision"] = jnp.asarray(vis), _t(vis)
    return jb, tb


def _train_model(served, remat="full", moe_impl="capacity"):
    m = build_model(served["cfg"], device="meta", remat=remat,
                    loss_chunks=4, moe_impl=moe_impl)
    m.load_state_dict(lm_params_from_jax(served["np_params"], served["cfg"],
                                         device="cpu"), assign=True)
    return m


def test_loss_aux_and_gradients_match_repro(served):
    """`loss` (vision prepended with zero labels and mask for the vlm; the
    router's aux summed over the moe layers) and its gradients against
    ``jax.value_and_grad(model.loss)`` of a model with loss_chunks 4."""
    jm = jbuild(served["jcfg"], loss_chunks=4)
    jb, tb = _loss_batches(served)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        served["jparams"], jb)
    model = _train_model(served)
    loss, aux = model.loss(tb)
    _close(loss.detach(), jloss)
    _close(aux["ce"].detach(), jaux["ce"])
    _close(aux["aux"].detach(), jaux["aux"])
    if served["cfg"].family == "moe":
        assert float(aux["aux"].detach()) > 0
    else:
        assert float(aux["aux"]) == 0.0
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
        loss, aux = model.loss(tb)
        out[remat] = (loss, aux["aux"], torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.equal(out["full"][0], out["none"][0])
    assert torch.equal(out["full"][1], out["none"][1])
    for a, b in zip(out["full"][2], out["none"][2]):
        assert torch.equal(a, b)


def test_ragged_dispatch_model_matches_repro(served):
    """The dropless dispatch in the whole model (``moe_impl="ragged"``):
    prefill logits and the loss against `repro`'s; the vlm has no MoE
    layer and ignores it."""
    jm = jbuild(served["jcfg"], moe_impl="ragged", loss_chunks=4)
    jb, tb = _loss_batches(served, seed=6)
    jloss, jaux = jm.loss(served["jparams"], jb)
    model = _train_model(served, moe_impl="ragged")
    with torch.no_grad():
        loss, aux = model.loss(tb)
        jvis = None if served["vision"] is None else \
            jnp.asarray(served["vision"].numpy())
        want, _ = jm.prefill(served["jparams"],
                             jnp.asarray(served["prompts"].numpy()),
                             vision=jvis)
        got, _ = model.prefill(served["prompts"], vision=served["vision"])
    _close(loss, jloss)
    _close(aux["aux"], jaux["aux"])
    _close(got, want)


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


def test_decode_matches_teacher_forced(served):
    """tests/test_models.py's check on the port: prefill (with the vision
    prefix) then decode equals the full forward over the same positions.
    The moe models dispatch dropless, as there: a capacity counted from
    the tokens of each call drops other copies in a decode step than in
    the full forward."""
    model = build_model(served["cfg"], device="meta", moe_impl="ragged")
    model.load_state_dict(served["params"], assign=True)
    S = 12
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, served["cfg"].vocab_size, (B, S))).long()
    Nv, half = served["Nv"], S // 2
    with torch.inference_mode():
        x = model._embed(tokens)
        if served["vision"] is not None:
            x = torch.cat([served["vision"], x], dim=1)
        x, _ = model._apply_stack(x, torch.arange(x.shape[1]))
        ref = model._logits(tlm.rms_norm(x, model.final_norm,
                                         model.cfg.norm_eps))
        logits, caches = model.prefill(tokens[:, :half],
                                       vision=served["vision"],
                                       cache_len=Nv + S)
        torch.testing.assert_close(logits, ref[:, Nv + half - 1], atol=5e-5,
                                   rtol=1e-4)
        for t in range(half, S):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               Nv + t)
            torch.testing.assert_close(logits, ref[:, Nv + t], atol=5e-5,
                                       rtol=1e-4)


def test_zero_vision_overflows_the_gradients_at_full_depth_in_both():
    """`repro.launch.train` feeds a vlm zero vision embeddings. A zero row
    stays zero through every layer, and each RMS norm of it scales its
    gradient by 1/sqrt(eps) = 1000: at internvl2-2b's 24 layers (48
    norms) the gradients overflow to non-finite values in `repro` and in
    the port alike (reduced width, the same init carried across); seeded
    embeddings keep them finite. So the card's whole-depth train run
    feeds seeded embeddings (`launch.train.train(vision=)`)."""
    jcfg = jconfigs.get_config("internvl2-2b").reduced().replace(
        n_layers=24)
    tcfg = tconfigs.get_config("internvl2-2b").reduced().replace(
        n_layers=24)
    jm = jbuild(jcfg, loss_chunks=4)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(tcfg, device="meta", loss_chunks=4)
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), assign=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    shape = (2, tcfg.n_vision_tokens, tcfg.d_model)
    for vision, finite in ((np.zeros(shape, np.float32), False),
                           (rng.standard_normal(shape).astype(np.float32),
                            True)):
        jgrads = jax.grad(lambda p: jm.loss(p, {
            "tokens": jnp.asarray(tokens), "vision": jnp.asarray(vision)})[0]
        )(jparams)
        loss, _ = model.loss({"tokens": _t(tokens, torch.long),
                              "vision": _t(vision)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads)) is finite
        assert all(torch.isfinite(g).all() for g in grads) is finite
        assert np.isfinite(float(loss.detach()))


# ------------------------------------------------------- the entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_matches_repro_cli(arch, monkeypatch, capsys):
    """The same flags give `repro`'s CLI run: `repro`'s prompts (and, for
    the vlm, zero vision embeddings, its prefill counting their
    positions) and `repro`'s sample ids from the port's own init of the
    same key tree."""
    seen = []
    generate = serve.generate

    def spy(model, params, prompts, *args, **kw):
        seen.append(kw.get("vision"))
        return generate(model, params, prompts, *args, **kw)

    monkeypatch.setattr(serve, "generate", spy)
    flags = ["--arch", arch, "--batch", "2", "--prompt-len", "8",
             "--new-tokens", "6"]
    serve.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    jax_out = capsys.readouterr().out
    cfg = jconfigs.get_config(arch).reduced()
    if cfg.family == "vlm":
        assert seen[0].shape == (2, cfg.n_vision_tokens, cfg.d_model)
        assert not seen[0].any()
    else:
        assert seen[0] is None

    def lines(out, prefix):
        return [re.sub(r":.*", "", line) if prefix == "prefill" else line
                for line in out.splitlines() if line.startswith(prefix)]
    assert lines(port_out, "prefill") == lines(jax_out, "prefill")
    ids = lines(port_out, "sample token ids:")
    assert len(ids) == 1 and ids == lines(jax_out, "sample token ids:")


def _loss_lines(text):
    return [(int(m.group(1)), float(m.group(2))) for m in
            re.finditer(r"step\s+(\d+) loss (\d+\.\d+) \(", text)]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_matches_repros_loss_lines(arch, monkeypatch, capsys):
    """`launch.train.main` against `repro.launch.train` for 3 steps from
    the same seed (the vlm's batches with zero vision embeddings, the
    moe's loss with its router's aux): the same first line and loss lines
    within 1e-4, and no K4 launch on the CPU."""
    flags = ["--reduced", "--arch", arch, "--steps", "3", "--batch", "2",
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
