"""The port's LM training path against `repro`'s on the CPU.

Each piece from seeded numpy inputs (or `repro`'s own init carried
across with `repro_torch.interop.lm_params_from_jax`), with its
tolerance stated where it is not exact:

* the schedules, step for step at steps 0-60 (exact: the port computes
  what XLA compiles, `repro_torch.optim.schedules`);
* AdamW over 5 updates, weight decay 0 and 0.1 (1e-6: one rounding
  order of its elementwise passes against XLA's fused ones), its global
  norm and clipping;
* `chunked_softmax_xent` at 1 and 4 chunks, with a mask, and the fall
  back to one chunk when S % n_chunks != 0 (1e-6);
* `DecoderLM.loss` and its gradients against
  ``jax.value_and_grad(model.loss)`` on reduced qwen3-0.6b,
  h2o-danube-1.8b (window 32 under 48 positions), mamba2-370m (two SSM
  chunks) and recurrentgemma-9b (rec, rec, attn; window 32 under 48),
  and 3 steps of `make_train_step` against `repro`'s jitted step
  (LOSS_TOL, GRAD_TOL, PARAM_TOL);
* remat "full" equal to "none" bit for bit;
* the entry point, `launch.train.main`, printing `repro.launch.train`'s loss
  lines (the printed 4 decimals, within 1e-4), dense, SSM and hybrid;
* `make_dpfl_mix` and `mix_pytree` (1e-6);
* a train checkpoint loading into `repro`'s tree, and back.
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
from repro import optim as joptim  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.interop import (lm_params_from_jax,  # noqa: E402
                                 lm_params_to_jax)
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

# the loss and each gradient leaf relative to the leaf's largest |g|:
# fp32 sums in another order than XLA's. The weights after 3 AdamW steps
# at `launch.train`'s default lr: Adam's step is about +-lr wherever |g| >> eps
# (1e-8), so an element whose gradient is at the rounding noise of its
# sums (|g| far below its leaf's largest) can step either way. So all but
# PARAM_OUTLIERS of each leaf's elements are held within PARAM_TOL, and
# every element within the 2 lr a step that a flipped sign allows
# (measured on the CPU: at most 3 elements of 131,072 in one leaf past
# 1e-6, the largest 0.23 lr).
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
LR = 3e-4
PARAM_TOL = 1e-6
PARAM_OUTLIERS = 1e-4
# arch: sequence length. mamba2-370m's reduced chunk is 32, so 64
# positions make two chunks (the state passed between them, and back);
# recurrentgemma-9b's reduced window of 32 binds under 48
ARCHS = {"qwen3-0.6b": 16, "h2o-danube-1.8b": 48, "mamba2-370m": 64,
         "recurrentgemma-9b": 48}
B = 2


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ----------------------------------------------------------------- optim

SCHEDULES = [(3e-4, 10, 50), (3e-4, 10, 3), (3e-4, 10, 10), (1e-3, 5, 60),
             (0.1, 0, 30), (1e-2, 3, 7)]


@pytest.mark.parametrize("peak,warmup,total", SCHEDULES)
def test_warmup_cosine_equals_repros_jitted_schedule(peak, warmup, total):
    want = jax.jit(joptim.warmup_cosine(peak, warmup, total))
    got = toptim.warmup_cosine(peak, warmup, total)
    for step in range(61):
        assert np.float32(got(step)) == np.float32(want(step)), step


def test_constant_schedule():
    assert toptim.constant(0.1)(7) == float(joptim.constant(0.1)(7))


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (5, 7), "b": (13,), "c": (3, 4, 6)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_repro_over_five_updates(weight_decay):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(5)]
    jopt = joptim.adamw(joptim.warmup_cosine(1e-2, 2, 5),
                        weight_decay=weight_decay)
    topt = toptim.adamw(toptim.warmup_cosine(1e-2, 2, 5),
                        weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for g in grads:
        ju, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tp)
        tp = toptim.apply_updates(tp, tu)
    assert ts["count"] == int(js["count"]) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(ts[m][k].numpy(), np.asarray(js[m][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=m)


def test_global_norm_and_clip_match_repro():
    tree = _tree(np.random.default_rng(1), SHAPES)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: _t(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(toptim.global_norm(ttree)),
                               float(joptim.optimizers.global_norm(jtree)),
                               rtol=1e-6)
    for max_norm in (1.0, 1e3):
        (jc, jn), (tc, tn) = (joptim.clip_by_global_norm(jtree, max_norm),
                              toptim.clip_by_global_norm(ttree, max_norm))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("S,n_chunks,masked", [(12, 1, True), (12, 4, True),
                                               (12, 4, False),
                                               (10, 4, True)])
def test_chunked_softmax_xent_matches_repro(S, n_chunks, masked):
    """S 10 under 4 chunks takes repro's fall back to one chunk."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, 8)).astype(np.float32)
    w = rng.standard_normal((8, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked \
        else np.ones((B, S), np.float32)
    want, wsum = jcommon.chunked_softmax_xent(
        lambda xs: xs @ jnp.asarray(w), jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(mask), n_chunks=n_chunks)
    got, tsum = tcommon.chunked_softmax_xent(
        lambda xs: xs @ _t(w), _t(x), _t(labels), _t(mask), n_chunks=n_chunks)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tsum) == float(wsum)


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """One reduced arch in both packages on `repro`'s init of PRNGKey(1),
    float32, with loss_chunks 4, and a batch of (B, S + 1) tokens with a
    mask that zeroes some positions."""
    arch = request.param
    S = ARCHS[arch]
    jcfg = jconfigs.get_config(arch).reduced().replace(dtype="float32")
    tcfg = tconfigs.get_config(arch).reduced().replace(dtype="float32")
    jm = jbuild(jcfg, loss_chunks=4)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S + 1)) > 0.2).astype(np.float32)
    np_params = jax.tree.map(np.asarray, jparams)

    def model(remat="full"):
        m = build_model(tcfg, device="meta", remat=remat, loss_chunks=4)
        m.load_state_dict(lm_params_from_jax(np_params, tcfg, device="cpu"),
                          assign=True)
        return m
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, jparams=jparams,
                model=model, tokens=tokens, mask=mask)


def _batches(pair, masked):
    jb = {"tokens": jnp.asarray(pair["tokens"])}
    tb = {"tokens": _t(pair["tokens"], torch.long)}
    if masked:
        jb["mask"], tb["mask"] = jnp.asarray(pair["mask"]), _t(pair["mask"])
    return jb, tb


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_match_repro(pair, masked):
    jb, tb = _batches(pair, masked)
    (jloss, jaux), jgrads = jax.value_and_grad(
        pair["jm"].loss, has_aux=True)(pair["jparams"], jb)
    model = pair["model"]()
    loss, aux = model.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]), rtol=0,
                               atol=LOSS_TOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = lm_params_from_jax(jax.tree.map(np.asarray, jgrads), pair["tcfg"],
                              device="cpu")
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        _grad_close(g.numpy(), want[name].numpy(), name)


def test_remat_full_equals_none_bit_for_bit(pair):
    _, tb = _batches(pair, True)
    out = {}
    for remat in ("full", "none"):
        model = pair["model"](remat)
        loss, _ = model.loss(tb)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                list(model.parameters())))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_three_train_steps_match_repros_jitted_step(pair):
    jb, tb = _batches(pair, False)
    jopt = joptim.adamw(joptim.warmup_cosine(LR, 1, 3))
    topt = toptim.adamw(toptim.warmup_cosine(LR, 1, 3))
    jstep = jax.jit(jsteps.make_train_step(pair["jm"], jopt))
    jp, js = pair["jparams"], jopt.init(pair["jparams"])
    model = pair["model"]()
    tstep = tsteps.make_train_step(model, topt)
    ts = topt.init(dict(model.named_parameters()))
    for i in range(3):
        jp, js, jloss = jstep(jp, js, jb)
        ts, tloss = tstep(ts, tb)
        assert tloss.shape == () and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=LOSS_TOL, err_msg=f"step {i}")
    want = lm_params_from_jax(jax.tree.map(np.asarray, jp), pair["tcfg"],
                              device="cpu")
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert (diff > PARAM_TOL).mean() <= PARAM_OUTLIERS, name
        assert diff.max() <= 2 * LR * 3, name
    assert ts["count"] == 3


def test_train_step_casts_gradients_to_grad_dtype(pair):
    """grad_dtype=bf16 rounds each gradient before AdamW: the step equals
    one on gradients rounded by hand."""
    _, tb = _batches(pair, False)
    seen = {}

    def spy(grads, state, params):
        seen.update(grads)
        return {k: torch.zeros_like(p) for k, p in params.items()}, state
    model = pair["model"]()
    step = tsteps.make_train_step(model, toptim.Optimizer(lambda p: {}, spy),
                                  grad_dtype=torch.bfloat16)
    step({}, tb)
    loss, _ = model.loss(tb)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for (name, _), g in zip(model.named_parameters(), grads):
        assert seen[name].dtype == torch.bfloat16
        assert torch.equal(seen[name], g.to(torch.bfloat16))


# ------------------------------------------------------- the entry point


def _loss_lines(text):
    return [(int(m.group(1)), float(m.group(2))) for m in
            re.finditer(r"step\s+(\d+) loss (\d+\.\d+) \(", text)]


def test_train_main_prints_repros_loss_lines(monkeypatch, capsys):
    flags = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
             "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    before = k4.flash_attention.launches
    run = ttrain.main(["--device", "cpu", *flags])
    got = capsys.readouterr().out
    assert k4.flash_attention.launches == before   # the CPU's plain path
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    assert got.splitlines()[-1] == "done."
    jl, tl = _loss_lines(want), _loss_lines(got)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2]
    for (_, a), (_, b), full in zip(tl, jl, run.losses):
        assert abs(a - b) <= 1e-4 and abs(full - b) <= 5e-5 + 1e-5
    assert len(run.step_seconds) == 3 and run.n_params == sum(
        p.numel() for p in run.model.parameters())


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_train_main_prints_repros_loss_lines_for_ssm_and_hybrid(
        monkeypatch, capsys, arch):
    """The SSM and hybrid families through the same entry point, at the
    CLI's own sequence (128: four SSM chunks; the hybrid's window binds):
    `repro.launch.train`'s loss lines, the K5 and K6 kernels never taken
    on CPU tensors."""
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import ssd as k5

    flags = ["--reduced", "--arch", arch, "--steps", "3", "--log-every",
             "1"]
    monkeypatch.setattr(sys, "argv", ["train", *flags])
    jtrain.main()
    want = capsys.readouterr().out
    before = (k5.ssd.launches, k5.ssd_bwd.launches, k6.rglru_scan.launches,
              k6.rglru_scan_bwd.launches, k4.flash_attention.launches)
    run = ttrain.main(["--device", "cpu", *flags])
    got = capsys.readouterr().out
    assert (k5.ssd.launches, k5.ssd_bwd.launches, k6.rglru_scan.launches,
            k6.rglru_scan_bwd.launches, k4.flash_attention.launches) == \
        before
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    assert got.splitlines()[-1] == "done."
    jl, tl = _loss_lines(want), _loss_lines(got)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2]
    for (_, a), (_, b), full in zip(tl, jl, run.losses):
        assert abs(a - b) <= 1e-4 and abs(full - b) <= 5e-5 + 1e-5


def test_train_checkpoints_load_into_repro_and_back(tmp_path):
    """`launch.train`'s checkpoint is `repro`'s stacked tree:
    `repro.checkpoint` loads it into a tree like `repro`'s init, equal to
    the trained weights; and a tree `repro` saves loads into the port's
    model."""
    run = ttrain.main(["--device", "cpu", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir",
                       str(tmp_path / "port"), "--ckpt-every", "2"])
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced().replace(
        dtype="float32")
    tcfg = tconfigs.get_config("qwen3-0.6b").reduced().replace(
        dtype="float32")
    like = jbuild(jcfg).init(jax.random.PRNGKey(0))
    step, tree = jckpt.CheckpointManager(str(tmp_path / "port")) \
        .restore_latest(like)
    assert step == 2
    back = lm_params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                              device="cpu")
    for name, p in run.model.state_dict().items():
        assert torch.equal(back[name], p), name
    # repro's file into the port: its init, saved by repro, restored
    # into the port's tree and made the port's state dict
    jckpt.save_pytree(str(tmp_path / "repro"), like)
    got = load_pytree(str(tmp_path / "repro"),
                      lm_params_to_jax(run.model.state_dict(), tcfg))
    got = lm_params_from_jax(jax.tree.map(lambda t: t.numpy(), got), tcfg,
                             device="cpu")
    want = lm_params_from_jax(jax.tree.map(np.asarray, like), tcfg,
                              device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b",
                                  "mamba2-370m"])
def test_lm_params_to_jax_inverts_from_jax(arch):
    cfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jparams = jax.tree.map(np.asarray, jbuild(cfg).init(
        jax.random.PRNGKey(2)))
    state = lm_params_from_jax(jparams, tcfg, device="cpu")
    back = lm_params_to_jax(state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ------------------------------------------------------------- DPFL mix


def _stacked(rng, C=4):
    return {"w": rng.standard_normal((C, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((C, 7)).astype(np.float32),
            "h": rng.standard_normal((C, 2, 2, 3)).astype(np.float32)}


def _row_stochastic(rng, C=4):
    A = rng.random((C, C)).astype(np.float32)
    return A / A.sum(1, keepdims=True)


def test_make_dpfl_mix_and_mix_pytree_match_repro():
    rng = np.random.default_rng(4)
    A, tree = _row_stochastic(rng), _stacked(rng)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: _t(v) for k, v in tree.items()}
    want = jsteps.make_dpfl_mix(jnp.asarray(A))(jtree)
    want_p = jgraph.mix_pytree(jnp.asarray(A), jtree)
    got = tsteps.make_dpfl_mix(_t(A))(ttree)
    got_p = tgraph.mix_pytree(_t(A), ttree)
    for k in tree:
        assert got[k].shape == tree[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=1e-6, atol=1e-6)
    # bf16 leaves mix in fp32 and come back in bf16
    bf = {k: v.to(torch.bfloat16) for k, v in ttree.items()}
    out = tsteps.make_dpfl_mix(_t(A))(bf)
    for k, v in out.items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(
            v, (torch.einsum("ij,j...->i...", _t(A), bf[k].float())
                ).to(torch.bfloat16))
