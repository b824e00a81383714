"""The port's LM substrate (dense family) against `repro`'s on the CPU: the
config registry field by field; `rms_norm`, `apply_rope`,
`attention_ref` and `cache_from_prefill`; and reduced qwen3-0.6b and
h2o-danube-1.8b (window 32 under a 48-token prompt, so the prefill keeps
the last C rows of a wrapped ring) with `repro`'s weights carried across
(`repro_torch.interop.lm_params_from_jax`): prefill logits, every cache
tensor, eight decode steps and the greedy tokens of
`repro_torch.launch.serve.generate` (1e-5; building blocks 1e-6). The
port alone: decode against the teacher-forced forward, as
tests/test_models.py asserts for `repro`, and the families it does not
serve raise (the SSM family is tests/test_torch_ssm.py's, the hybrid
tests/test_torch_rglru.py's). The serve CLI against `repro`'s: the same
prompts and sample ids from the same flags, and the temperature sampler
against ``jax.random.categorical``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import dataclasses  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = 1e-5        # model outputs and caches
BLOCK_TOL = 1e-6  # building blocks
B = 2
# reduced configs served in parity: prompt length, new tokens
LM_CASES = {"qwen3-0.6b": (16, 8), "h2o-danube-1.8b": (48, 8)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", sorted(jconfigs.REGISTRY))
def test_config_registry_equals_repro(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert dataclasses.asdict(t.with_window(4096)) == \
        dataclasses.asdict(j.with_window(4096))
    for c, d in ((t, j), (t.reduced(), j.reduced())):
        if d.n_heads:   # mamba2 has no attention heads
            assert c.resolved_head_dim == d.resolved_head_dim
        assert c.is_decoder_only == d.is_decoder_only
        assert c.supports_long_context == d.supports_long_context
        for multiple in (1, 128, 2048):
            assert c.padded_vocab(multiple) == d.padded_vocab(multiple)


def test_registry_ids_and_lookup_match_repro():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# --------------------------------------------------------- building blocks


def test_rms_norm_matches_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(tcommon.rms_norm(_t(x), _t(w), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), BLOCK_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_repro(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    for pos in (np.arange(7, dtype=np.int32),
                rng.integers(0, 600, (2, 7)).astype(np.int32)):
        _close(tcommon.apply_rope(_t(x), _t(pos, torch.int64), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               BLOCK_TOL)


def _ring_positions(Bsz, C, pos, empty):
    """kv positions of a ring of C slots after writing positions
    0..pos (slot p % C), with the last ``empty`` slots never written."""
    kv = np.full((Bsz, C), -1, np.int32)
    for p in range(pos + 1):
        kv[:, p % C] = p
    if empty:
        kv[:, C - empty:] = -1
    return kv


@pytest.mark.parametrize("case", ["prefill", "chunked", "ring", "ring-window",
                                  "non-causal"])
def test_attention_ref_matches_repro(case):
    rng = np.random.default_rng(2)
    Sq, Sk, window, causal, q_chunk = {
        "prefill": (16, 16, None, True, 1024),
        "chunked": (64, 64, 24, True, 16),
        "ring": (1, 12, None, True, 1024),
        "ring-window": (1, 12, 6, True, 1024),
        "non-causal": (9, 9, 4, False, 1024)}[case]
    q = rng.standard_normal((B, Sq, 4, 32)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, Sk, 2, 32)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, Sk, 2, 32)).astype(np.float32)
    if case.startswith("ring"):
        q_pos = np.array([9], np.int32)     # slots 10, 11 still empty
        kv_pos = _ring_positions(B, Sk, 9, 0)
        assert (kv_pos == -1).sum() == 2 * B
    else:
        q_pos = np.arange(Sq, dtype=np.int32)
        kv_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    got = tcommon.attention_ref(_t(q), _t(k), _t(v), _t(q_pos, torch.int64),
                                _t(kv_pos, torch.int32), causal=causal,
                                window=window, q_chunk=q_chunk)
    want = jcommon.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(q_pos),
                                 jnp.asarray(kv_pos), causal=causal,
                                 window=window, q_chunk=q_chunk)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("S,cache_len,window", [(10, 16, None), (10, 10, None),
                                                (48, 56, 32), (13, 40, 5)])
def test_cache_from_prefill_matches_repro(S, cache_len, window):
    rng = np.random.default_rng(3)
    k = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = tlm.cache_from_prefill(_t(k), _t(v), _t(pos, torch.int64),
                                 cache_len, window)
    want = jlm.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), cache_len, window)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    assert got["pos"].dtype == torch.int32


# -------------------------------------------------------------- the models


@pytest.fixture(scope="module", params=list(LM_CASES))
def served(request):
    """One reduced arch served by both packages on the same weights and
    prompts: `repro`'s prefill and greedy decode loop, and the port's
    model on the CPU carrying `repro`'s init."""
    arch = request.param
    prompt, new = LM_CASES[arch]
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    total = prompt + new
    logits, caches = jm.prefill(jparams, jnp.asarray(tokens), cache_len=total)
    jout = {"prefill_logits": np.asarray(logits),
            "prefill_caches": jax.tree.map(np.asarray, caches)}
    dstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    for t in range(new - 1):
        logits, caches = dstep(jparams, caches, tok, jnp.int32(prompt + t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
    jout.update(tokens=np.concatenate(toks, 1), step_logits=step_logits,
                caches=jax.tree.map(np.asarray, caches))
    model = build_model(tcfg, device="meta")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    model.load_state_dict(params, assign=True)
    return dict(arch=arch, cfg=tcfg, model=model, params=params,
                jparams=jparams, jm=jm, prompts=torch.from_numpy(tokens).long(),
                prompt=prompt, new=new, total=total, jax=jout)


def _stacked(caches, name):
    return torch.stack([c[name] for c in caches]).numpy()


def test_prefill_logits_and_caches_match_repro(served):
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        logits, caches = model.prefill(served["prompts"],
                                       cache_len=served["total"])
    _close(logits, j["prefill_logits"])
    assert len(caches) == served["cfg"].n_layers
    for name in ("k", "v"):
        _close(_stacked(caches, name), j["prefill_caches"][name])
    np.testing.assert_array_equal(_stacked(caches, "pos"),
                                  j["prefill_caches"]["pos"])
    if served["arch"] == "h2o-danube-1.8b":   # the keep-last-C branch ran
        C = caches[0]["k"].shape[1]
        assert C == served["cfg"].attn_window < served["prompt"]


def test_decode_steps_match_repro(served):
    """Eight decode_step logits and the caches after them, teacher-forced
    with `repro`'s greedy tokens."""
    model, j = served["model"], served["jax"]
    with torch.inference_mode():
        _, caches = model.prefill(served["prompts"], cache_len=served["total"])
        tokens = torch.from_numpy(j["tokens"]).long()
        for t, want in enumerate(j["step_logits"]):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                               served["prompt"] + t)
            _close(logits, want)
    for name in ("k", "v"):
        _close(_stacked(caches, name), j["caches"][name])
    np.testing.assert_array_equal(_stacked(caches, "pos"), j["caches"]["pos"])


def test_generate_matches_repro_greedy_serve(served):
    before = k4.flash_attention.launches
    gen = serve.generate(served["model"], served["params"], served["prompts"],
                         served["new"])
    assert k4.flash_attention.launches == before   # the CPU's plain path
    j = served["jax"]
    np.testing.assert_array_equal(gen.tokens.numpy(), j["tokens"])
    _close(gen.prefill_logits, j["prefill_logits"])
    _close(gen.last_logits, j["step_logits"][-1])
    assert gen.prefill_seconds > 0 and gen.decode_seconds > 0


def test_init_matches_repro_within_ulps(served):
    """The port's own init draws `repro`'s key tree; its normal sampler
    may differ from jax's by a few ulps (up to 1.9e-5 on unit normals,
    prng.py), so each leaf is held within 1e-5 of its largest value."""
    model = build_model(served["cfg"], device="cpu")
    own = model.init(prng.PRNGKey(1))
    assert set(own) == set(served["params"])
    for name, want in served["params"].items():
        torch.testing.assert_close(own[name], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_steps_are_the_model_methods(served):
    model, cfg = served["model"], served["cfg"]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    with torch.inference_mode():
        logits, caches = prefill({"tokens": served["prompts"]},
                                 cache_len=served["total"])
        want, want_caches = model.prefill(served["prompts"],
                                          cache_len=served["total"])
        assert torch.equal(logits, want)
        tok = logits.argmax(-1, keepdim=True)
        got, _ = decode(caches, tok, served["prompt"])
        want, _ = model.decode_step(want_caches, tok, served["prompt"])
        assert torch.equal(got, want)


def _full_logits(model, tokens):
    x = model._embed(tokens)
    x, _ = model._apply_stack(x, torch.arange(tokens.shape[1]), None)
    return model._logits(tcommon.rms_norm(x, model.final_norm,
                                          model.cfg.norm_eps))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-1.8b",
                                  "granite-20b", "qwen3-4b"])
def test_decode_matches_teacher_forced(arch):
    """tests/test_models.py's check on the port: step-by-step decode from
    an empty cache equals the full forward, and so does prefill then
    decode."""
    cfg = tconfigs.get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    model.init(prng.PRNGKey(1))
    S = 40 if cfg.attn_window else 16          # past the window of 32
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S))).long()
    with torch.inference_mode():
        ref = _full_logits(model, tokens)
        caches = model.init_cache(B, S)
        for t in range(S):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
            torch.testing.assert_close(logits, ref[:, t], atol=5e-5,
                                       rtol=1e-4)
        half = S // 2
        logits, caches = model.prefill(tokens[:, :half], cache_len=S)
        torch.testing.assert_close(logits, ref[:, half - 1], atol=5e-5,
                                   rtol=1e-4)
        for t in range(half, S):
            logits, caches = model.decode_step(caches, tokens[:, t:t + 1], t)
            torch.testing.assert_close(logits, ref[:, t], atol=5e-5,
                                       rtol=1e-4)


def test_vocab_pad_mask_and_separate_head():
    cfg = tconfigs.get_config("h2o-danube-1.8b").reduced().replace(
        vocab_size=500)
    model = build_model(cfg, device="cpu", vocab_pad_multiple=128)
    params = model.init(prng.PRNGKey(2))
    assert model.vp == 512 and params["lm_head"].shape == (cfg.d_model, 512)
    with torch.inference_mode():
        logits, _ = model.prefill(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 512)
    assert torch.all(logits[:, 500:] == tcommon.NEG_INF)
    assert torch.isfinite(logits[:, :500]).all()


# --------------------------------------------------------- what raises


@pytest.mark.parametrize("case", ["bf16", "ssm", "hybrid", "fp32 dense"])
def test_model_refuses_gradients_through_the_attention_kernel(case):
    """The weights take gradients. What has no backward yet refuses them:
    a bf16 model (K4's backward is fp32 only, item 14d-3) in the kernel
    check. fp32 gradients flow on the CPU, through the plain attention
    (dense), the plain SSD scan (SSM) and the plain RG-LRU recurrence and
    attention (hybrid), into the leaves before each kernel."""
    arch = {"ssm": "mamba2-370m", "hybrid": "recurrentgemma-9b"}.get(
        case, "qwen3-0.6b")
    cfg = tconfigs.get_config(arch).reduced().replace(
        dtype="bfloat16" if case == "bf16" else "float32")
    model = build_model(cfg, device="cpu")
    model.init(prng.PRNGKey(0))
    assert all(p.requires_grad for p in model.parameters())
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.long)}
    if case == "bf16":
        with pytest.raises(NotImplementedError, match="item 14d-3"):
            model.loss(batch)
        with torch.no_grad():   # the forward alone still runs
            assert torch.isfinite(model.loss(batch)[0])
        return
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    leaves = {"fp32 dense": ["layers.0.attn.wq"],
              "ssm": ["layers.0.A_log", "layers.0.dt_bias"],
              "hybrid": ["layers.0.lam", "layers.0.wa", "layers.2.attn.wq"]}
    for name in leaves[case]:
        assert by_name[name].abs().max() > 0, name


# ------------------------------------------------------ the serve entry


def test_serve_main_on_cpu(capsys):
    before = k4.flash_attention.launches
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--new-tokens", "4"])
    assert k4.flash_attention.launches == before   # the CPU's plain path
    out = capsys.readouterr().out
    assert "prefill B=2 S=8" in out
    assert "decoded 3 steps x 2 seqs" in out
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_generate_samples_at_a_temperature():
    cfg = tconfigs.get_config("qwen3-0.6b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(prng.PRNGKey(0))
    prompts = serve.make_prompts(cfg.vocab_size, 2, 6, 0, "cpu")
    assert torch.equal(prompts, serve.make_prompts(cfg.vocab_size, 2, 6, 0,
                                                   "cpu"))
    runs = [serve.generate(model, params, prompts, 6, temperature=1.0,
                           key=prng.PRNGKey(7)).tokens for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 6)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size
    greedy = serve.generate(model, params, prompts, 6).tokens
    assert torch.equal(greedy[:, 0], runs[0][:, 0])   # first token greedy
    with pytest.raises(ValueError):
        serve.generate(model, params, prompts, 4, temperature=1.0)
    before = k4.flash_attention.launches
    serve.generate(model, None, prompts, 1)
    assert k4.flash_attention.launches == before


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_next_token_samples_as_jax_categorical(temperature):
    """`serve._next_token` at a temperature is `repro`'s sampler: split the
    key, ``jax.random.categorical`` of the scaled logits under the second
    half, carry the first; 20 seeds on (4, 1000) logits."""
    rng = np.random.default_rng(0)
    for seed in range(20):
        logits = (rng.standard_normal((4, 1000)) * 2).astype(np.float32)
        carried, sub = jax.random.split(jax.random.PRNGKey(seed))
        want = jax.random.categorical(sub, jnp.asarray(logits) / temperature)
        tok, key = serve._next_token(_t(logits), temperature,
                                     prng.PRNGKey(seed))
        np.testing.assert_array_equal(tok[:, 0].numpy(), np.asarray(want))
        np.testing.assert_array_equal(key.numpy(),
                                      np.asarray(carried).astype(np.int64))


@pytest.mark.parametrize("arch,flags", [
    ("qwen3-0.6b", []), ("qwen3-0.6b", ["--temperature", "1.0"]),
    ("mamba2-370m", []), ("recurrentgemma-9b", [])])
def test_serve_cli_matches_repro_cli(arch, flags, monkeypatch, capsys):
    """The same flags give `repro`'s CLI run: the prompts are
    ``jax.random.randint(PRNGKey(0), (B, S), 0, vocab)`` (`prng.randint`),
    and the sample ids, from the port's own init of the same key tree
    (within `prng.normal`'s ulps of `repro`'s, far from a greedy tie
    here) and the same sampling key, are `repro`'s."""
    seen = []
    generate = serve.generate

    def spy(model, params, prompts, *args, **kw):
        seen.append(prompts)
        return generate(model, params, prompts, *args, **kw)

    monkeypatch.setattr(serve, "generate", spy)
    flags = ["--arch", arch, "--batch", "2", "--prompt-len", "8",
             "--new-tokens", "6"] + flags
    serve.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    jax_out = capsys.readouterr().out
    vocab = jconfigs.get_config(arch).reduced().vocab_size
    want = jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, vocab)
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(want))

    def ids(out):
        return [line for line in out.splitlines()
                if line.startswith("sample token ids:")]
    assert len(ids(port_out)) == 1 and ids(port_out) == ids(jax_out)
