"""bf16 training, as `repro` defines it, against `repro` on the CPU.

`repro`'s models default to bf16 (``ArchConfig.dtype``) and differentiate
their plain attention at bf16: bf16 operands, fp32 sums, the
probabilities rounded to bf16 before P V, the output rounded to bf16
(`repro.models.common.attention_ref`). The port trains the same way on
the CPU through the plain versions, and on the card through K4's bf16
backward (tests/test_torch_cuda.py holds the kernel to its plain
version there). From seeded numpy inputs, with each tolerance stated:

* the plain bf16 backward (`ref.flash_attention_bwd_ref`) against
  ``jax.vjp`` of `repro`'s ``flash_attention_ref`` at bf16: causal,
  non-causal, windowed and ragged, GQA 2 and 8, hd 64 and 128
  (BWD_TOL of each gradient's largest element: both round each gradient
  to bf16 once, after fp32 sums in another order, so an element on a
  rounding boundary may differ by one bf16 ulp, 2^-8 of itself);
* `DecoderLM.loss` / `WhisperModel.loss` and every gradient at bf16
  against ``jax.value_and_grad(model.loss)`` at bf16 on the reduced
  configs of each family that trains: dense, SSM, hybrid, vlm, moe and
  audio (LOSS_TOL absolute, GRAD_TOL of each leaf's largest element).
  Each test prints `repro`'s own bf16-against-fp32 gap beside them: the
  port's gap to `repro` at bf16 is of that order, since every bf16
  rounding of an activation lands on one side or the other of a
  boundary (XLA also rounds fused elementwise chains once where PyTorch
  rounds each op), and a tolerance of the order of K4's bf16 forward
  test (3e-2, tests/test_torch_flash_attention.py) was the guide;
* 3 AdamW steps of reduced qwen3-0.6b at bf16 against `repro`'s jitted
  step (the moments in fp32, `repro`'s default ``state_dtype``; then in
  bf16).
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

BWD_TOL = 1e-2
LOSS_TOL = 5e-3
GRAD_TOL = 5e-2
LR = 3e-4

# ----------------------------------------------- the plain bf16 backward

# (B, Sq, Sk, Hq, Hkv, hd, causal, window): GQA 2 and 8, hd 64 and 128,
# causal, non-causal, a window, ragged (Sq != Sk, and lengths off the
# kernel's 64-row tiles)
BWD_CASES = [(2, 64, 64, 4, 2, 64, True, None),
             (1, 96, 96, 8, 1, 128, True, None),
             (2, 48, 80, 4, 2, 64, False, None),
             (1, 77, 77, 16, 2, 128, True, 24),
             (1, 50, 70, 8, 4, 64, True, None),
             (1, 70, 50, 2, 1, 128, False, 16)]


def _bf16_inputs(B, Sq, Sk, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
              (B, Sq, Hq, hd))
    scales = (0.5, 0.5, 1.0, 1.0)
    arrays = [(rng.standard_normal(s) * c).astype(np.float32)
              for s, c in zip(shapes, scales)]
    # round through bf16 once, so both packages see the same values
    jarrs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tarrs = [torch.from_numpy(np.asarray(a.astype(jnp.float32)))
             .to(torch.bfloat16) for a in jarrs]
    return jarrs, tarrs


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window",
                         BWD_CASES)
def test_plain_bf16_backward_matches_jax_grad_of_repros_attention(
        B, Sq, Sk, Hq, Hkv, hd, causal, window):
    (jq, jk, jv, jdo), (q, k, v, dout) = _bf16_inputs(B, Sq, Sk, Hq, Hkv,
                                                      hd)
    # Sq > Sk with aligned positions: every row must see a key
    kw = dict(causal=causal, window=window)
    jout, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, **kw), jq, jk, jv)
    want = vjp(jdo)
    out = ref.flash_attention_ref(q, k, v, **kw)
    got = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=0,
                               atol=BWD_TOL * float(jnp.abs(jout).max()))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max()) / scale
        print(f"d{name}: {err:.3e} of its largest element (BWD_TOL "
              f"{BWD_TOL})")
        assert err <= BWD_TOL, f"d{name}"


# ------------------------------------------------------- the families

# arch: sequence length (mamba2-370m's reduced chunk is 32: two chunks;
# recurrentgemma-9b's reduced window of 32 binds under 48); a vlm batch
# carries 4 seeded vision embeddings, an audio batch its frames
ARCHS = {"qwen3-0.6b": 16, "mamba2-370m": 64, "recurrentgemma-9b": 48,
         "internvl2-2b": 16, "qwen3-moe-30b-a3b": 16,
         "whisper-medium": 16}
B = 2


def _family(arch, dtype):
    """(jax model, its params, the port's model on them, the jax and the
    port's batch) of a reduced arch at ``dtype``, from `repro`'s init of
    PRNGKey(1), loss_chunks 4."""
    S = ARCHS[arch]
    jcfg = jconfigs.get_config(arch).reduced().replace(dtype=dtype)
    tcfg = tconfigs.get_config(arch).reduced().replace(dtype=dtype)
    jm = jbuild(jcfg, loss_chunks=4)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long()}
    if jcfg.family == "vlm":
        vis = rng.standard_normal((B, 4, jcfg.d_model)).astype(np.float32)
        jb["vision"], tb["vision"] = jnp.asarray(vis), torch.from_numpy(vis)
    if jcfg.family == "audio":
        frames = rng.standard_normal((B, jcfg.n_audio_frames,
                                      jcfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = (jnp.asarray(frames),
                                      torch.from_numpy(frames))
    model = build_model(tcfg, device="meta", loss_chunks=4)
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        device="cpu"), assign=True)
    return jm, jparams, model, tcfg, jb, tb


def _flat(tree, tcfg):
    return {k: v.float().numpy() for k, v in lm_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), tree), tcfg,
        device="cpu").items()}


def _worst(got, want):
    """The largest |got - want| of any leaf, relative to the leaf's
    largest |want|."""
    return max(float(np.abs(got[k] - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-12) for k in want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_loss_and_gradients_match_repro(arch):
    jm, jp, model, tcfg, jb, tb = _family(arch, "bfloat16")
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, _ = model.loss(tb)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = _flat(jgrads, tcfg)
    assert sorted(names) == sorted(want)
    for (name, p), g in zip(model.named_parameters(), grads):
        assert g.dtype == p.dtype, name    # bf16 leaves, bf16 gradients
        assert torch.isfinite(g).all(), name
    got = {n: g.float().numpy() for n, g in zip(names, grads)}
    # `repro`'s own gap: the same model at fp32 (the bf16 init rounded)
    jm32, jp32, _, tcfg32, jb32, _ = _family(arch, "float32")
    (jloss32, _), jgrads32 = jax.value_and_grad(jm32.loss, has_aux=True)(
        jp32, jb32)
    own = (abs(float(jloss) - float(jloss32)),
           _worst(_flat(jgrads, tcfg), _flat(jgrads32, tcfg32)))
    gap = (abs(float(loss.detach()) - float(jloss)), _worst(got, want))
    print(f"{arch}: port vs repro at bf16: loss {gap[0]:.2e} (LOSS_TOL "
          f"{LOSS_TOL}), gradients {gap[1]:.2e} of a leaf's largest "
          f"(GRAD_TOL {GRAD_TOL}); repro bf16 vs fp32: loss {own[0]:.2e}, "
          f"gradients {own[1]:.2e}")
    assert gap[0] <= LOSS_TOL
    assert gap[1] <= GRAD_TOL


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_three_bf16_adamw_steps_match_repros_jitted_step(state_dtype):
    """3 steps of `make_train_step` on reduced qwen3-0.6b's bf16 leaves
    (gradients bf16, AdamW's moments at ``state_dtype``) against
    `repro`'s jitted step: each loss within LOSS_TOL, and every weight
    within the 2 lr a step that a flipped Adam sign allows (an element
    whose gradient is at the bf16 noise steps either way) plus one bf16
    ulp of the weight (the update's rounding to bf16 before the add)."""
    jm, jp, model, tcfg, jb, tb = _family("qwen3-0.6b", "bfloat16")
    jdt, tdt = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    jopt = joptim.adamw(joptim.warmup_cosine(LR, 1, 3), state_dtype=jdt)
    topt = toptim.adamw(toptim.warmup_cosine(LR, 1, 3), state_dtype=tdt)
    jstep = jax.jit(jsteps.make_train_step(jm, jopt))
    js = jopt.init(jp)
    tstep = tsteps.make_train_step(model, topt)
    ts = topt.init(dict(model.named_parameters()))
    assert all(m.dtype == tdt for m in ts["mu"].values())
    for i in range(3):
        jp, js, jloss = jstep(jp, js, jb)
        ts, tloss = tstep(ts, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=LOSS_TOL, err_msg=f"step {i}")
    want = _flat(jp, tcfg)
    for name, p in model.state_dict().items():
        assert p.dtype == torch.bfloat16 or name.endswith(
            ("A_log", "D", "dt_bias")), name
        w = want[name]
        ulp = np.abs(w) * 2.0 ** -7
        diff = np.abs(p.float().numpy() - w)
        assert (diff <= 2 * LR * 3 + ulp).all(), name
