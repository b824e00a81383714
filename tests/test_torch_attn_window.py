"""`build_model(cfg, attn_window=)` against `repro`'s on the CPU: the
argument sets the attention window of every decoder-only family, over
``cfg.attn_window`` and over the hybrid's ``local_window`` (`repro`'s
precedence, `repro.models.lm.DecoderLM.__init__`), and the audio family
drops it as `repro` does. Reduced qwen3-0.6b, h2o-danube-1.8b and
recurrentgemma-9b at window 8 under a 16-token prompt (K4's window binds
and the prefill keeps the last 8 rows of a wrapped ring), carrying
`repro`'s weights: prefill logits and eight decode steps within 1e-5, the
same greedy tokens from `repro_torch.launch.serve.generate`."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = 1e-5
WINDOW = 8
B, PROMPT, STEPS = 2, 16, 8
SERVED = ["qwen3-0.6b", "h2o-danube-1.8b", "recurrentgemma-9b"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("arch", sorted(jconfigs.REGISTRY))
@pytest.mark.parametrize("window", [None, WINDOW])
def test_window_equals_repro(arch, window):
    """Every arch of the registry, reduced and whole (built on "meta":
    nothing is allocated): the window `repro` resolves, or, for the audio
    family, a model built with the argument dropped."""
    for reduce in (False, True):
        jcfg = jconfigs.get_config(arch)
        tcfg = tconfigs.get_config(arch)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jm = jbuild(jcfg, attn_window=window)
        tm = build_model(tcfg, device="meta", attn_window=window)
        if jcfg.family == "audio":
            assert not hasattr(jm, "window") and not hasattr(tm, "window")
            continue
        assert tm.window == jm.window
        if window is not None:
            assert tm.window == WINDOW


def test_argument_beats_the_hybrid_local_window():
    cfg = tconfigs.get_config("recurrentgemma-9b").reduced()
    assert cfg.attn_window is None and cfg.local_window == 32
    assert build_model(cfg, device="meta").window == 32
    assert build_model(cfg, device="meta", attn_window=WINDOW).window == WINDOW


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    """One reduced arch at window 8 in both packages: `repro`'s prefill
    and greedy decode loop, and the port's model on the CPU carrying
    `repro`'s init."""
    arch = request.param
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jm = jbuild(jcfg, attn_window=WINDOW)
    jparams = jm.init(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    total = PROMPT + STEPS + 1
    logits, caches = jm.prefill(jparams, jnp.asarray(tokens), cache_len=total)
    jout = {"prefill_logits": np.asarray(logits)}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(STEPS):
        logits, caches = dstep(jparams, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    jout.update(tokens=np.concatenate(toks, 1), step_logits=step_logits)
    model = build_model(tcfg, device="meta", attn_window=WINDOW)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    model.load_state_dict(params, assign=True)
    return dict(arch=arch, model=model, params=params, total=total,
                prompts=torch.from_numpy(tokens).long(), jax=jout)


def test_prefill_and_decode_steps_match_repro(served):
    """The windowed prefill logits and eight decode steps, teacher-forced
    with `repro`'s greedy tokens; the attention rings hold 8 slots."""
    model, j = served["model"], served["jax"]
    assert model.window == WINDOW < PROMPT
    with torch.inference_mode():
        logits, caches = model.prefill(served["prompts"],
                                       cache_len=served["total"])
        _close(logits, j["prefill_logits"])
        rings = [c["k"].shape[1] for c in caches
                 if isinstance(c, dict) and "k" in c]
        assert rings and set(rings) == {WINDOW}
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               PROMPT + t)
            _close(logits, want)
    assert len(j["step_logits"]) == STEPS


def test_generate_matches_repro_greedy_tokens(served):
    j = served["jax"]
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         STEPS + 1)
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])
