"""Granite-4.0-H through the port's normal path, on the CPU.

A tiny granite `DecoderLM` (mamba, attention, mamba; every width cut,
every switch of the published config kept: the conv's bias, no rotary
positions, the softmax scale and the three multipliers) against the
plain reference `repro_torch.models.granite_ref` on seeded random
weights: logits, loss and every leaf's gradient, and the serving path
(prefill, then decode through the caches). `vmap_clients` over tiny
granite clients against a per-client loop, with K4's and K5's launches
replaced by their plain versions so that the vmap rules fold the client
axis (one launch a layer). The GGC / BGGC refresh in client blocks
against the whole batch, bit for bit, dense and lists, and the probe
buffer against the stacked probes. The published config itself, built
on "meta": its parameter count and the benchmark's cut. No JAX: `repro`
has no such family.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import obs, prng
from repro_torch.configs.granite_4_0_h_micro import (CONFIG, LAYER_TYPES,
                                                      GraniteConfig)
from repro_torch.core import graph
from repro_torch.fl.engine import vmap_clients
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as k5
from repro_torch.models import build_model, granite_ref
from repro_torch.models.common import rms_norm

#: the tiny model: 2 chunks of 8 over 16 positions, 4 heads of 16 over 2
#: KV heads, 8 SSM heads of 16 with a state of 16
TINY = dict(n_layers=3, layer_types=("mamba", "attention", "mamba"),
            d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
            vocab_size=67, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
            dtype="float32")


def tiny_config(**kw) -> GraniteConfig:
    return CONFIG.replace(**{**TINY, **kw})


def _model(cfg, seed=0):
    """A "meta"-built model and its weights: the port's init from the
    seed, every vector leaf (norms, A_log, D, dt_bias, the conv's bias)
    moved off its constant init by 0.3 of a normal draw."""
    model = build_model(cfg, device="meta", remat="none", loss_chunks=1)
    params = model.init(prng.PRNGKey(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in params.values():
            if v.dim() == 1:
                v.add_(0.3 * torch.randn(v.shape, generator=g))
    return model, dict(model.named_parameters())


def _tokens(cfg, b=2, T=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, T + 1), generator=g)


def lm_loss(model, batch):
    return model.loss({"tokens": batch["x"]})[0]


def model_logits(model, toks):
    x = model._embed(toks)
    h, _ = model._apply_stack(x, torch.arange(x.shape[1]))
    return model._logits(rms_norm(h, model.final_norm, model.cfg.norm_eps))


def _close(got, want, tol, msg=""):
    """``got`` within ``tol`` of ``want``, as a share of want's largest
    element."""
    scale = want.abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=tol,
                               msg=msg)


def test_tiny_granite_matches_the_plain_reference():
    """Logits, loss and every leaf's gradient. The port scans in chunks
    (`kernels.ref.ssd_ref`: exponentials of prefix-sum differences,
    einsums) where the reference steps the recurrence, and both are
    float32: 2e-5 of the largest logit and 1e-6 of the loss (relative)
    cover that rounding; the gradients, summed over 32 positions through
    three layers, 1e-4 of each leaf's largest element."""
    cfg = tiny_config()
    model, params = _model(cfg)
    toks = _tokens(cfg)
    with torch.no_grad():
        _close(model_logits(model, toks[:, :-1]),
               granite_ref.logits(params, cfg, toks[:, :-1]), 2e-5)
    loss, _ = model.loss({"tokens": toks})
    grads = torch.autograd.grad(loss, list(params.values()))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    want = granite_ref.loss(leaves, cfg, toks)
    want_grads = torch.autograd.grad(want, list(leaves.values()))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert set(params) >= {"layers.0.conv_b", "layers.1.attn.wq",
                           "layers.1.ln2", "layers.2.wo_mlp"}
    for k, g, w in zip(params, grads, want_grads):
        _close(g, w, 1e-4, msg=k)


@pytest.mark.parametrize("fault", ["residual", "rope", "conv_bias",
                                   "scale"])
def test_reference_tells_each_granite_switch_apart(fault):
    """Each switch of the published config moves the logits well past the
    tolerance above: the model run without it differs from the reference
    by more than 1e-3 of the largest logit."""
    cfg = tiny_config()
    model, params = _model(cfg)
    bad = {"residual": dict(residual_multiplier=1.0),
           "rope": dict(use_rope=True),
           "conv_bias": dict(ssm_conv_bias=False),
           "scale": dict(attention_multiplier=None)}[fault]
    off = build_model(cfg.replace(**bad), device="meta", remat="none")
    off.load_state_dict({k: v for k, v in params.items()
                         if k in off.state_dict()}, assign=True)
    toks = _tokens(cfg)[:, :-1]
    with torch.no_grad():
        want = granite_ref.logits(params, cfg, toks)
        gap = (model_logits(off, toks) - want).abs().max()
    assert gap > 1e-3 * want.abs().max()


def test_tiny_granite_serves_through_its_caches():
    """Prefill of 8 tokens, then 8 decode steps through the conv and SSM
    states and the attention ring: each step's logits within 2e-5 of the
    reference's full forward at that position (the decode steps the
    recurrence, as the reference does; the prefill scans in chunks)."""
    cfg = tiny_config()
    model, params = _model(cfg, seed=3)
    toks = _tokens(cfg, T=15, seed=4)
    with torch.no_grad():
        want = granite_ref.logits(params, cfg, toks)
        last, caches = model.prefill(toks[:, :8], cache_len=16)
        _close(last, want[:, 7], 2e-5)
        for t in range(8, 16):
            last, caches = model.decode_step(caches, toks[:, t:t + 1], t)
            _close(last, want[:, t], 2e-5, msg=f"position {t}")


def _stacked(cfg, n, seed=5):
    model, _ = _model(cfg)
    inits = [_model(cfg, seed + i)[1] for i in range(n)]
    return model, {k: torch.stack([p[k].detach() for p in inits])
                   for k in inits[0]}


def test_vmap_clients_over_granite_equals_a_per_client_loop():
    """`vmap_clients` over 3 granite clients: losses and every gradient
    leaf within 1e-6 of one client at a time on the plain module."""
    cfg = tiny_config()
    model, stacked = _stacked(cfg, 3)
    batch = {"x": torch.stack([_tokens(cfg, seed=i) for i in range(3)])}
    leaves = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    losses = vmap_clients(model, lm_loss)(leaves, batch)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    for i in range(3):
        one = build_model(cfg, device="meta", remat="none", loss_chunks=1)
        one.load_state_dict({k: v[i].clone() for k, v in stacked.items()},
                            assign=True)
        params = dict(one.named_parameters())
        loss = lm_loss(one, {"x": batch["x"][i]})
        want = torch.autograd.grad(loss, [params[k] for k in leaves])
        torch.testing.assert_close(losses[i], loss, rtol=0, atol=1e-6)
        for k, g, w in zip(leaves, grads, want):
            torch.testing.assert_close(g[i], w, rtol=0, atol=1e-6, msg=k)


def _plain_launches(monkeypatch):
    """K4's and K5's launches replaced by their plain versions, counted
    with the shapes they see (the kernels cannot run on the CPU, their
    folds can), and `ops` sending CPU tensors to the wrappers."""
    seen = {"k4": [], "k4_bwd": [], "k5": [], "k5_bwd": []}

    def k4_forward(q, k, v, causal, window, with_lse):
        seen["k4"].append(tuple(q.shape))
        lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1])) \
            if with_lse else None
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window), lse

    def k4_backward(q, k, v, out, lse, dout, causal=True, window=None):
        seen["k4_bwd"].append(tuple(q.shape))
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                           window=window)

    def k5_forward(x, dlogA, B, C, chunk, h0):
        seen["k5"].append(tuple(x.shape))
        y, h_last = ref.ssd_ref(x, dlogA, B, C, chunk, h0)
        # stand-ins for the workspaces, batched along b as the kernel's
        return y, h_last, torch.zeros(x.shape[0]), torch.zeros(x.shape[0])

    def k5_backward(x, dlogA, B, C, chunk, h0, dy, dh_last, cum, states):
        seen["k5_bwd"].append(tuple(x.shape))
        return ref.ssd_bwd_ref(x, dlogA, B, C, chunk, h0, dy, dh_last)

    monkeypatch.setattr(k4, "_forward", k4_forward)
    monkeypatch.setattr(k4, "flash_attention_bwd", k4_backward)
    monkeypatch.setattr(k5, "_forward", k5_forward)
    monkeypatch.setattr(k5, "ssd_bwd", k5_backward)
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    return seen


@pytest.mark.parametrize("h0", [False, True])
def test_k5_vmap_rules_fold_clients_into_the_batch(monkeypatch, h0):
    """`kernels.ssd` under ``torch.func.vmap``: one forward launch on the
    folded (N b) batch and, under autograd, one backward call, equal to a
    per-client loop of the plain version (forward, and gradients within
    1e-6); with h0 vmapped too. Both go through `_Scan`'s rule: without
    grad the forward alone on the folded tensors, under grad mode `_Scan`
    recorded on them."""
    seen = _plain_launches(monkeypatch)
    N, b, l, H, p, n, L = 3, 2, 16, 4, 8, 12, 8
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    x, B, C = t(N, b, l, H, p), t(N, b, l, n), t(N, b, l, n)
    dlogA = -torch.rand((N, b, l, H), generator=torch.Generator()
                        .manual_seed(1))
    h = t(N, b, H, p, n) if h0 else None
    dy, dh = t(N, b, l, H, p), t(N, b, H, p, n)

    def run(x, dlogA, B, C, h):
        return k5.ssd(x, dlogA, B, C, chunk=L, h0=h)
    f = torch.func.vmap(run, in_dims=(0, 0, 0, 0, 0 if h0 else None))
    with torch.no_grad():
        y, h_last = f(x, dlogA, B, C, h)
    assert seen["k5"] == [(N * b, l, H, p)] and seen["k5_bwd"] == []
    for i in range(N):
        yi, hi = ref.ssd_ref(x[i], dlogA[i], B[i], C[i], L,
                             None if h is None else h[i])
        assert torch.equal(y[i], yi) and torch.equal(h_last[i], hi)

    ins = [v for v in (x, dlogA, B, C, h) if v is not None]
    leaves = [v.clone().requires_grad_(True) for v in ins]
    args = leaves + ([] if h0 else [None])
    got = torch.autograd.grad(f(*args), leaves, (dy, dh))
    assert seen["k5"][1:] == [(N * b, l, H, p)]
    assert seen["k5_bwd"] == [(N * b, l, H, p)]
    plain = [v.clone().requires_grad_(True) for v in ins]
    outs = [ref.ssd_ref(*(v[i] for v in plain[:4]), L,
                        plain[4][i] if h0 else None) for i in range(N)]
    want = torch.autograd.grad(
        [torch.stack([o[0] for o in outs]),
         torch.stack([o[1] for o in outs])], plain, (dy, dh))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_granite_loss_under_vmap_launches_each_kernel_once_a_layer(
        monkeypatch):
    """The granite clients' loss through the bridge with the kernel path
    taken: one K5 forward and backward a Mamba2 layer, one K4 forward and
    backward an attention layer, each on the folded client and batch
    axes, and the losses and gradients of the plain path within 1e-6."""
    cfg = tiny_config()
    model, stacked = _stacked(cfg, 3)
    batch = {"x": torch.stack([_tokens(cfg, seed=i) for i in range(3)])}
    loss_fn = vmap_clients(model, lm_loss)

    def run():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
        losses = loss_fn(leaves, batch)
        return losses, torch.autograd.grad(losses.sum(),
                                           list(leaves.values()))
    want_losses, want_grads = run()
    seen = _plain_launches(monkeypatch)
    losses, grads = run()
    T, Hs = batch["x"].shape[2] - 1, cfg.d_model * cfg.ssm_expand \
        // cfg.ssm_headdim
    k5_shape = (3 * 2, T, Hs, cfg.ssm_headdim)
    k4_shape = (3 * 2, T, cfg.n_heads, cfg.resolved_head_dim)
    assert seen == {"k4": [k4_shape], "k4_bwd": [k4_shape],
                    "k5": [k5_shape] * 2, "k5_bwd": [k5_shape] * 2}
    torch.testing.assert_close(losses, want_losses, rtol=0, atol=1e-6)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ----------------------------------------------------- the refresh in blocks

_N, _P = 7, 12


def _toy(seed=0):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((_N, _P), generator=g)
    p = torch.rand(_N, generator=g) + 0.1
    target = torch.randn(_P, generator=g)
    calls = []

    def reward(probes, k_idx):
        # each row's reward reads only that row: a client's decisions
        # cannot depend on the block it is scanned in
        calls.append(tuple(k_idx.tolist()))
        return -((probes - target) ** 2).sum(-1) \
            - 0.05 * k_idx[:, None] * (probes ** 2).sum(-1)
    cand = torch.rand((_N, _N), generator=g) < 0.6
    return flat, p / p.sum(), cand, reward, calls


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("build", ["ggc", "bggc", "sparse", "bggc_sparse"])
def test_blocked_refresh_selects_what_the_whole_batch_selects(build,
                                                              chunk):
    """GGC and BGGC, dense and lists, run in blocks of ``chunk`` clients:
    the same selections, bit for bit, each client's reward calls in the
    same order, one ``ggc.block`` span a block, and the same tally of
    candidate probes."""
    flat, p, cand, reward, calls = _toy()
    key = prng.PRNGKey(11)
    budget = 2

    def run(c):
        calls.clear()
        obs.reset()
        with obs.tracing():
            if build == "ggc":
                out = graph.all_clients_graph(key, flat, p, cand, reward,
                                              budget, client_chunk=c)
            elif build == "bggc":
                out = graph.all_clients_bggc(key, flat, p, cand, reward,
                                             budget, client_chunk=c)
            elif build == "sparse":
                lists = graph.neighbors_from_adjacency(cand, 4)
                out = graph.all_clients_graph_sparse(
                    key, flat, p, lists, reward, budget, client_chunk=c)
            else:
                out = graph.all_clients_bggc_sparse(key, flat, p, reward,
                                                    budget, client_chunk=c)
        snap = obs.snapshot()
        per_client = {k: [i for i, ks in enumerate(calls) if k in ks]
                      for k in range(_N)}
        blocks = sum(r.name == "ggc.block" for r in snap["records"])
        return out, [len(v) for v in per_client.values()], blocks, \
            snap["tallies"]["ggc.candidate_probe_models"]
    whole, whole_calls, no_blocks, tally = run(None)
    out, got_calls, blocks, got_tally = run(chunk)
    assert torch.equal(out, whole)
    assert got_calls == whole_calls and got_tally == tally
    assert no_blocks == 0 and blocks == math.ceil(_N / chunk)


def test_probe_buffer_holds_the_stacked_probes():
    """The decision step's (K, 4, P) probe buffer holds the bits of the
    four set averages stacked."""
    flat, p, cand, _, _ = _toy(1)
    seen = []

    def reward(probes, k_idx):
        seen.append(probes.clone())
        return -(probes ** 2).sum(-1)
    step = graph.greedy_decision_step(reward)
    K = 3
    k_idx = torch.arange(K)
    carry = graph.GreedyCarry(
        maskX=torch.eye(K, _N, dtype=torch.bool),
        maskY=torch.ones(K, _N, dtype=torch.bool),
        wX=p[:K, None] * flat[:K], wY=(p[:, None] * flat).sum(0).expand(
            K, _P).clone(), pX=p[:K], pY=p.sum().expand(K).clone(),
        nsel=torch.zeros(K, dtype=torch.int64))
    j = torch.tensor([4, 5, 6])
    step(carry, j, flat[j], u=torch.full((K,), 0.5), k_idx=k_idx,
         is_cand=torch.ones(K, dtype=torch.bool), p_j=p[j], budget=2)
    pw = p[j][:, None] * flat[j]
    want = torch.stack([
        carry.wX / carry.pX[:, None],
        (carry.wX + pw) / (carry.pX + p[j])[:, None],
        carry.wY / carry.pY[:, None],
        (carry.wY - pw) / torch.clamp_min(carry.pY - p[j], 1e-12)[:, None]],
        dim=1)
    assert torch.equal(seen[0], want)


# ------------------------------------------------------------ the config


def test_published_config_and_the_benchmark_cut():
    """The published model built on "meta": 3.19 B weights over its 40
    layers of the published order; the benchmark's cut (layers 0-9, one
    period of 9 Mamba2 : 1 attention, the vocabulary's first eighth)
    holds 772,160,448, as its configuration states."""
    full = build_model(CONFIG, device="meta")
    assert CONFIG.layer_types == LAYER_TYPES
    assert LAYER_TYPES.count("attention") == 4 and len(LAYER_TYPES) == 40
    n_full = sum(v.numel() for v in full.state_dict().values())
    assert round(n_full / 1e9, 2) == 3.19
    cut = CONFIG.replace(n_layers=10, layer_types=LAYER_TYPES[:10],
                         vocab_size=12544, dtype="float32")
    model = build_model(cut, device="meta")
    assert cut.layer_types.count("attention") == 1
    assert sum(v.numel() for v in model.state_dict().values()) == \
        772_160_448


def test_granite_config_refuses_a_layer_list_of_the_wrong_length():
    with pytest.raises(ValueError):
        CONFIG.replace(n_layers=10)
    with pytest.raises(ValueError):
        tiny_config(layer_types=("mamba", "rec", "mamba"))
