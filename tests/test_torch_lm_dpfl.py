"""DPFL over LM clients (`examples/lm_dpfl_torch.py`) against `repro`'s
`examples/lm_dpfl.py`, and the pieces it runs on: `vmap_clients`, the
bridge from a one-client loss to the engine's stacked contract, and
K4's vmap rules (the client axis folded into the kernel's batch axis).

`repro`'s example runs unchanged (its `run_dpfl` wrapped to keep the
engine and the result); the port's copy runs on the CPU from the bitwise
`prng` init. The port must select `repro`'s Omega and every graph, give
its test accuracies (fractions of counts) exactly and its validation
losses within 1e-5.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import runpy  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core import DPFLConfig, run_dpfl  # noqa: E402
from repro_torch.fl.engine import vmap_clients  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, common.ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = _load("lm_dpfl_torch")


@pytest.fixture(scope="module")
def runs():
    """(repro's engine, its result, its printed lines; the port's engine,
    its result, its printed lines) of the example's setting."""
    import repro.core

    kept = {}
    inner = repro.core.run_dpfl

    def keeping(engine, cfg):
        kept["engine"], kept["res"] = engine, inner(engine, cfg)
        return kept["res"]

    out = io.StringIO()
    repro.core.run_dpfl = keeping
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(common.ROOT / "examples" / "lm_dpfl.py"),
                           run_name="__main__")
    finally:
        repro.core.run_dpfl = inner
    engine, cluster_of = ex.lm_engine(ex.example_config(), ex.CLIENTS,
                                      common.CPU)
    res = run_dpfl(engine, DPFLConfig(**ex.RUN))
    same, cross = ex.graph_split(res.graph_history[-1], cluster_of)
    lines = ["next-token acc per client: "
             + " ".join(f"{a:.3f}" for a in res.test_acc),
             f"graph edges within corpus-cluster {same:.2f} vs across "
             f"{cross:.2f}"]
    return (kept["engine"], kept["res"], out.getvalue().splitlines(),
            engine, res, lines)


def test_port_selects_repros_graphs(runs):
    _, jres, _, _, tres, _ = runs
    np.testing.assert_array_equal(jres.omega, tres.omega)
    assert len(jres.graph_history) == len(tres.graph_history) == \
        ex.RUN["rounds"]
    for t, (a, b) in enumerate(zip(jres.graph_history, tres.graph_history)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {t}")
    assert jres.comm_downloads == tres.comm_downloads
    assert jres.comm_bytes == tres.comm_bytes


def test_port_gives_repros_accuracies_and_losses(runs):
    """Accuracies are fractions of counts: equal. The best models'
    validation losses (each package evaluating its own) within 1e-5."""
    je, jres, jlines, te, tres, tlines = runs
    np.testing.assert_array_equal(np.asarray(jres.test_acc), tres.test_acc)
    np.testing.assert_array_equal(np.asarray(jres.val_acc_history),
                                  np.asarray(tres.val_acc_history))
    _, jl = je.eval_val(je.unflatten(jnp.asarray(jres.best_flat)))
    _, tl = te.eval_val(te.unflatten(torch.from_numpy(tres.best_flat)))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0,
                               atol=1e-5)
    assert tlines == jlines


def test_lm_engine_keeps_tokens_integer(runs):
    te = runs[3]
    for x, _ in (te.train_data, te.val_data, te.test_data):
        assert x.dtype == torch.int64
    assert te.n_params == sum(v.numel()
                              for v in te.model.state_dict().values())


def _clients(cfg, n, seed=1):
    """A "meta"-built model of ``cfg`` (remat "none") and n clients'
    weights drawn from split(PRNGKey(seed), n), stacked."""
    model = build_model(cfg, device="meta", remat="none", loss_chunks=1)
    keys = prng.split(prng.PRNGKey(seed), n)
    inits = [model.init(keys[i]) for i in range(n)]
    return model, {k: torch.stack([p[k] for p in inits]) for k in inits[0]}


def _batch(cfg, n, b=3, seed=2):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (n, b, 17)))}


def test_vmap_clients_equals_a_per_client_loop():
    """The bridge's losses and every gradient leaf within 1e-6 of one
    client at a time on the plain module, the accuracy equal."""
    cfg = ex.example_config()
    model, stacked = _clients(cfg, 3)
    batch = _batch(cfg, 3)
    leaves = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    losses = vmap_clients(model, ex.lm_loss)(leaves, batch)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    with torch.no_grad():
        accs = vmap_clients(model, ex.lm_acc)(stacked, batch)
    assert losses.shape == accs.shape == (3,)
    for i in range(3):
        one = build_model(cfg, device="meta", remat="none", loss_chunks=1)
        one.load_state_dict({k: v[i].clone() for k, v in stacked.items()},
                            assign=True)
        params = dict(one.named_parameters())
        loss = ex.lm_loss(one, {"x": batch["x"][i]})
        want = torch.autograd.grad(loss, [params[k] for k in leaves])
        torch.testing.assert_close(losses[i], loss, rtol=0, atol=1e-6)
        for k, g, w in zip(leaves, grads, want):
            torch.testing.assert_close(g[i], w, rtol=0, atol=1e-6, msg=k)
        with torch.no_grad():
            assert accs[i] == ex.lm_acc(one, {"x": batch["x"][i]})


def test_vmap_clients_refuses_activation_recompute():
    model = build_model(ex.example_config(), device="meta", remat="full")
    with pytest.raises(ValueError, match="remat='none'"):
        vmap_clients(model, ex.lm_loss)


def _plain_launches(monkeypatch):
    """K4's launches replaced by its plain versions, counted with the
    shapes they see; the kernel cannot run on the CPU, the fold can."""
    seen = {"fwd": [], "bwd": []}

    def forward(q, k, v, causal, window, with_lse):
        seen["fwd"].append((tuple(q.shape), with_lse))
        lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1])) \
            if with_lse else None
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window), lse

    def backward(q, k, v, out, lse, dout, causal=True, window=None):
        seen["bwd"].append(tuple(q.shape))
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                           window=window)

    monkeypatch.setattr(k4, "_forward", forward)
    monkeypatch.setattr(k4, "flash_attention_bwd", backward)
    return seen


@pytest.mark.parametrize("kv_dims", [0, None])
def test_k4_vmap_rule_folds_clients_into_the_batch(monkeypatch, kv_dims):
    """`kernels.flash_attention` under ``torch.func.vmap``: one forward
    launch on the folded (N * B) batch and, under autograd, one backward
    call, equal to a per-client loop of the plain version (forward, and
    gradients within 1e-6); k and v vmapped (`_Forward`'s rule folds) or
    shared by every client (k and v require grad unbatched, so
    `_Attention`'s own rule folds); without grad the forward launches
    without its LSE."""
    seen = _plain_launches(monkeypatch)
    N, B, S, Hq, Hkv, hd = 3, 2, 31, 4, 2, 16
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q, dout = t(N, B, S, Hq, hd), t(N, B, S, Hq, hd)
    kv_shape = (N, B, S, Hkv, hd) if kv_dims == 0 else (B, S, Hkv, hd)
    k, v = t(*kv_shape), t(*kv_shape)
    f = torch.func.vmap(k4.flash_attention, in_dims=(0, kv_dims, kv_dims))

    def kv(i):
        return (k[i], v[i]) if kv_dims == 0 else (k, v)
    with torch.no_grad():
        out = f(q, k, v)
    assert seen == {"fwd": [((N * B, S, Hq, hd), False)], "bwd": []}
    each = [ref.flash_attention_ref(q[i], *kv(i)) for i in range(N)]
    assert torch.equal(out, torch.stack(each))

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(f(*leaves), leaves, dout)
    assert seen["fwd"][1:] == [((N * B, S, Hq, hd), True)]
    assert seen["bwd"] == [(N * B, S, Hq, hd)]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    outs = torch.stack([ref.flash_attention_ref(
        plain[0][i], *((plain[1][i], plain[2][i]) if kv_dims == 0
                       else plain[1:])) for i in range(N)])
    want = torch.autograd.grad(outs, plain, dout)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=f"d{name}")


def test_k4_launches_directly_outside_a_transform(monkeypatch):
    """Without grad and outside any ``torch.func`` transform (the serve
    prefill, the classifier runs) K4 launches `_forward` itself, not
    through the `_Forward` Function; a vmapped call goes through it once
    and launches once on the folded batch."""
    seen = _plain_launches(monkeypatch)
    through = []
    apply = k4._Forward.apply
    monkeypatch.setattr(k4._Forward, "apply", lambda *a: (
        through.append(tuple(a[0].shape)), apply(*a))[1])
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 3, 8, 4, 16), (2, 3, 8, 2, 16),
                         (2, 3, 8, 2, 16)))
    with torch.no_grad():
        out = k4.flash_attention(q[0], k[0], v[0])
        assert through == [] and seen["fwd"] == [((3, 8, 4, 16), False)]
        folded = torch.func.vmap(k4.flash_attention)(q, k, v)
    assert through == [(3, 8, 4, 16)]     # a batched tensor's slice shape
    assert seen["fwd"][1:] == [((6, 8, 4, 16), False)]
    assert torch.equal(folded[0], out)


def test_lm_loss_under_vmap_launches_k4_once_a_layer(monkeypatch):
    """The LM's loss through the bridge with the kernel path taken (CPU
    tensors sent to the wrappers, K4's launches the plain versions): one
    forward launch a layer on the folded client and batch axes, one
    backward call a layer, and the losses and gradients of the plain
    path within 1e-6."""
    cfg = ex.example_config()
    model, stacked = _clients(cfg, 3, seed=4)
    batch = _batch(cfg, 3, b=2, seed=5)
    loss_fn = vmap_clients(model, ex.lm_loss)

    def run():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
        losses = loss_fn(leaves, batch)
        return losses, torch.autograd.grad(losses.sum(),
                                           list(leaves.values()))
    want_losses, want_grads = run()
    seen = _plain_launches(monkeypatch)
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    losses, grads = run()
    S, L = batch["x"].shape[2] - 1, cfg.n_layers
    shape = (3 * 2, S, cfg.n_heads, cfg.resolved_head_dim)
    assert seen == {"fwd": [(shape, True)] * L, "bwd": [shape] * L}
    torch.testing.assert_close(losses, want_losses, rtol=0, atol=1e-6)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
