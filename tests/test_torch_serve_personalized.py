"""Personalized serving (`examples/serve_personalized_torch.py`) against
`repro`'s `examples/serve_personalized.py`: the stacked init is
``jax.vmap(model.init)`` of the split keys bit for bit, each request's
12 greedy tokens are `repro`'s, the vmapped decode is per-request
`generate` on that client's weights, and the ring-cache writes run under
``torch.func.vmap`` without the per-slice fallback.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import runpy  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "serve_personalized_torch",
    common.ROOT / "examples" / "serve_personalized_torch.py")
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)


@pytest.fixture(scope="module")
def port():
    """(config, "meta" model, stacked init, client ids, prompts) of the
    example on the CPU."""
    cfg = ex.example_config()
    model = build_model(cfg, device="meta", remat="none")
    stacked = ex.stacked_init(model, ex.CLIENTS, common.CPU)
    ids = torch.tensor([c for c, _ in ex.REQUESTS])
    return cfg, model, stacked, ids, ex.example_prompts(common.CPU)


@pytest.fixture(scope="module")
def repro_lines():
    """What `repro`'s example prints, run unchanged."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(common.ROOT / "examples" /
                           "serve_personalized.py"), run_name="__main__")
    return out.getvalue().splitlines()


def test_stacked_init_is_jax_vmap_of_init(port):
    from repro.configs import get_config
    from repro.models import build_model as jbuild

    cfg, _, stacked, _, _ = port
    jcfg = get_config("qwen3-0.6b").reduced().replace(dtype="float32")
    jstacked = jax.vmap(jbuild(jcfg).init)(
        jax.random.split(jax.random.PRNGKey(0), ex.CLIENTS))
    for i in range(ex.CLIENTS):
        want = lm_params_from_jax(
            jax.tree.map(lambda a: np.asarray(a[i]), jstacked), cfg,
            device=common.CPU)
        assert sorted(want) == sorted(stacked)
        for k, w in want.items():
            assert torch.equal(stacked[k][i], w), f"client {i} {k}"


def test_tokens_equal_repros(port, repro_lines, monkeypatch):
    """Each request's 12 greedy tokens, and the lines the port's example
    prints: `repro`'s, the decode loop's seconds aside."""
    cfg, model, stacked, ids, prompts = port
    served = ex.serve_personalized(model, stacked, ids, prompts,
                                   ex.NEW_TOKENS)
    assert served.tokens.shape == (len(ex.REQUESTS), ex.NEW_TOKENS)
    for i, (c, _) in enumerate(ex.REQUESTS):
        assert repro_lines[1 + i] == \
            f"  req{i} -> client {c}: {served.tokens[i].tolist()}"
    monkeypatch.setattr(sys, "argv", ["serve_personalized_torch.py",
                                      "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ex.main()
    lines = out.getvalue().splitlines()
    assert lines[1:] == repro_lines[1:]
    assert lines[0].rsplit(" in ", 1)[0] == \
        repro_lines[0].rsplit(" in ", 1)[0]


def test_vmapped_decode_equals_generate_per_request(port):
    """Per request, `generate` on its client's weights alone: the same
    tokens, and prefill logits within 1e-5."""
    cfg, model, stacked, ids, prompts = port
    served = ex.serve_personalized(model, stacked, ids, prompts,
                                   ex.NEW_TOKENS)
    alone = build_model(cfg, device="meta")
    for r, c in enumerate(ids.tolist()):
        gen = generate(alone, {k: v[c] for k, v in stacked.items()},
                       prompts[r:r + 1], ex.NEW_TOKENS)
        assert torch.equal(gen.tokens[0], served.tokens[r]), f"request {r}"
        torch.testing.assert_close(served.prefill_logits[r],
                                   gen.prefill_logits[0], rtol=0,
                                   atol=1e-5)


def test_decode_under_vmap_takes_no_fallback(port):
    """Every op of the vmapped prefill and decode has a batching rule: no
    "performance drop" warning, so no per-request loop (the ring's
    index_copy_ had none), and no write into a broadcast tensor."""
    cfg, model, stacked, ids, prompts = port
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        served = ex.serve_personalized(model, stacked, ids, prompts, 4)
    assert served.tokens.shape == (len(ex.REQUESTS), 4)
