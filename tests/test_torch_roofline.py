"""The kernels' shape-only calls on "meta" tensors and the roofline counts
(`repro_torch.kernels.meta`, `repro_torch.roofline`).

Each kernel and backward on "meta" tensors runs its checks, allocates
what its launch allocates (outputs, workspaces, scratch: the plan
functions' shapes) and records its ``work``; it refuses what the card
refuses. `count_step`'s aten flops of a reduced train step on "meta"
(`OpCounter`'s, by FlopCounterMode's formulas) equal FlopCounterMode's
of the same step on the CPU's plain path, op by op, outside the kernels
(whose plain versions run inside a module there, so their flops are
told apart). The peak it counts is the one the tracker alone counts.
"""
from __future__ import annotations

import contextlib

import test_torch_common  # noqa: F401  (the jax patch; first)
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.kernels import cnn_features as k7
from repro_torch.kernels import compressed_graph_mix as k3
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import graph_mix as k1
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as k6
from repro_torch.kernels import sparse_graph_mix as k2
from repro_torch.kernels import ssd as k5
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.roofline import (CARDS, HW, analyze_count, breakdown,
                                  card_for, count_step, roofline_terms)
from repro_torch.roofline.analysis import OpCounter, PeakTracker

SMS = CARDS["H100"].sms


def m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(*ts):
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for t in ts if t is not None)


def _case_k1():
    A, W = m(3, 4), m(4, 1000)
    out = k1.graph_mix(A, W)
    return "graph_mix", (out,), (k1.work(3, 4, 1000, 4),), 0


def _case_k2():
    N, B, P = 8, 3, 500
    out = k2.sparse_graph_mix(m(N), m(N, B), m(N, B, dtype=torch.int32),
                              m(N, P), m(N, P))
    return "sparse_graph_mix", (out,), (k2.work(N, B, P, 4, N * B, N),), 0


def _case_k3():
    M, N, K, P = 4, 6, 5, 600
    out = k3.compressed_graph_mix(m(M, N), m(N, K),
                                  m(N, K, dtype=torch.int32), P)
    T = -(-P // k3.TILE)
    # the bucketed payload and its offsets live for the call
    scratch = _nbytes(m(N, K), m(N, K, dtype=torch.int32), m(N, T + 1))
    return ("compressed_graph_mix", (out,), (k3.work(M, N, K, P, N * K),),
            scratch)


def _case_k4():
    q, k, v = m(2, 64, 4, 32), m(2, 64, 2, 32), m(2, 64, 2, 32)
    out = k4.flash_attention(q, k, v, causal=True, window=16)
    return ("flash_attention", (out,),
            (k4.work(2, 64, 64, 4, 2, 32, True, 16, 4),), 0)


def _case_k4_bwd():
    B, Sq, Sk, Hq, Hkv, hd = 2, 100, 100, 4, 2, 64
    q, k, v = m(B, Sq, Hq, hd), m(B, Sk, Hkv, hd), m(B, Sk, Hkv, hd)
    out, lse = k4.flash_attention_with_lse(q, k, v, causal=False)
    with kmeta.target(SMS):
        dq, dk, dv = k4.flash_attention_bwd(q, k, v, out, lse, m(*q.shape),
                                            causal=False)
    plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, SMS)
    scratch = _nbytes(m(B, Hq, Sq), *(m(*s) for s in plan.scratch.values()))
    return ("flash_attention_bwd", (dq, dk, dv),
            (k4.bwd_work(B, Sq, Sk, Hq, Hkv, hd, False, None, 4),), scratch)


def _case_k5():
    b, l, H, p, n = 2, 128, 3, 32, 16
    y, h = k5.ssd(m(b, l, H, p), m(b, l, H), m(b, l, n), m(b, l, n),
                  chunk=64)
    plan = k5.launch_plan(b, l, H, p, n, 64)
    sizes = [-(-torch.Size(s).numel() // 4) * 4
             for s in plan.workspace.values()]
    return ("ssd", (y, h), (k5.work(b, l, H, p, n, 64, False),),
            _nbytes(m(sum(sizes[:-1]) + torch.Size(
                plan.workspace["states"]).numel())))


def _case_k5_bwd():
    b, l, H, p, n = 2, 128, 3, 32, 16
    x, dl, B, C = m(b, l, H, p), m(b, l, H), m(b, l, n), m(b, l, n)
    _, _, cum, states = k5.ssd_with_work(x, dl, B, C, chunk=64)
    got = k5.ssd_bwd(x, dl, B, C, 64, None, m(b, l, H, p), None, cum,
                     states)
    plan = k5.backward_plan(b, l, H, p, n, 64)
    return ("ssd_bwd", got[:4],
            (k5.bwd_work(b, l, H, p, n, 64, False, False),),
            _nbytes(m(plan.scratch_bytes() // 4)))


def _case_k6():
    h, hl = k6.rglru_scan(m(2, 40, 24), m(2, 40, 24), m(2, 24))
    return "rglru_scan", (h, hl), (k6.work(2, 40, 24, True),), 0


def _case_k6_bwd():
    a = m(2, 40, 24)
    got = k6.rglru_scan_bwd(a, m(2, 40, 24), None, m(2, 40, 24), m(2, 24))
    return ("rglru_scan_bwd", got[:2], (k6.bwd_work(2, 40, 24, False, True),),
            0)


def _case_k7():
    G, B, H, W = 4, 3, 16, 16
    out = k7.cnn_features(m(G, B, H, W, 3), m(G, 5, 5, 3, 6), m(G, 6),
                          m(G, 5, 5, 6, 16), m(G, 16))
    return "cnn_features", (out,), (k7.work(G, B, H, W, 3, 6, 16),), 0


CASES = {f.__name__[6:]: f for f in (
    _case_k1, _case_k2, _case_k3, _case_k4, _case_k4_bwd, _case_k5,
    _case_k5_bwd, _case_k6, _case_k6_bwd, _case_k7)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_meta_path_allocates_the_plan_and_records_its_work(case):
    """On "meta" tensors a kernel returns outputs of its launch's shapes
    and dtypes, allocates them and its plan's workspaces and scratch (the
    peak over the call, in 512-byte blocks, is the outputs' plus the
    scratch), records one `KernelCall` of its module's ``work``, and
    launches nothing."""
    launches = {f: f.launches for f in (
        k1.graph_mix, k2.sparse_graph_mix, k3.compressed_graph_mix,
        k4.flash_attention, k4.flash_attention_bwd, k5.ssd, k5.ssd_bwd,
        k6.rglru_scan, k6.rglru_scan_bwd, k7.cnn_features)}
    with kmeta.recording() as calls, PeakTracker() as peak:
        name, outs, works, scratch = CASES[case]()
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in outs)
    assert [c.name for c in calls][-1] == name
    assert (calls[-1].nbytes, calls[-1].flops) == works[0]
    assert calls[-1].dtype == "float32"
    # the outputs alive at the end, the scratch freed by the call's end
    assert peak.now >= _nbytes(*outs)
    assert peak.peak >= peak.now + scratch
    assert {f: f.launches for f in launches} == launches


def test_kernel_meta_scratch_equals_the_plans_exactly():
    """The backwards' shape-only calls allocate their plans' scratch to
    the byte: K4's ds and part (`backward_plan.scratch`) and delta beside
    dq, dk and dv; K5's one workspace of `backward_plan` beside its five
    gradients."""
    B, S, Hq, Hkv, hd = 2, 100, 4, 2, 64
    q, k = m(B, S, Hq, hd), m(B, S, Hkv, hd)
    out, lse, dout = m(B, S, Hq, hd), m(B, Hq, S), m(B, S, Hq, hd)
    with kmeta.target(SMS), PeakTracker(1) as peak:
        k4.flash_attention_bwd(q, k, k, out, lse, dout, causal=False)
    plan = k4.backward_plan(B, S, S, Hq, Hkv, hd, SMS)
    grads = 4 * (B * S * Hq * hd + 2 * B * S * Hkv * hd)
    assert peak.peak == grads + 4 * B * Hq * S + plan.scratch_bytes()
    b, l, H, p, n = 2, 128, 3, 32, 16
    plan5 = k5.backward_plan(b, l, H, p, n, 64)
    args = (m(b, l, H, p), m(b, l, H), m(b, l, n), m(b, l, n), 64, None,
            m(b, l, H, p), None, m(b, H, l), m(b, l // 64, H, n, plan5.pw))
    with PeakTracker(1) as peak:
        k5.ssd_bwd(*args)
    sizes = [torch.Size(s).numel() for s in plan5.workspace.values()]
    work = sum(-(-s // 4) * 4 for s in sizes[:-1]) + sizes[-1]
    assert 4 * work == plan5.scratch_bytes()
    assert peak.peak == 4 * (b * l * H * p + b * l * H + 2 * b * l * n) + \
        plan5.scratch_bytes()


@pytest.mark.parametrize("what", ["k4 bf16 backward", "k4 bf16 grad",
                                  "k5 bf16", "k6 bf16", "mixed devices",
                                  "no target", "k4 shapes"])
def test_meta_path_refuses_what_the_card_refuses(what):
    """The shape-only calls run the kernels' own checks: K5 and K6 in
    bf16 (the models cast the scans' inputs to fp32, as `repro`'s), a
    call mixing "meta" with the CPU, K4's backward plan without the
    target card's SM count, shapes the kernel does not take. What the
    card cannot run is a `kmeta.Refusal`; a caller's fault (mixed
    devices, no target) is not. K4's bf16 backward, refused until the
    bf16 backward was written, runs: on "meta" it allocates its bf16
    plan's scratch and records its work at 2 bytes an element (lse 4),
    directly and under autograd."""
    bf = torch.bfloat16
    if what in ("k4 bf16 backward", "k4 bf16 grad"):
        q = m(1, 16, 2, 16, dtype=bf)
        with kmeta.target(SMS), kmeta.recording() as calls:
            if what == "k4 bf16 backward":
                got = k4.flash_attention_bwd(q, q, q, q, m(1, 2, 16), q)
            else:
                q.requires_grad_()
                got = torch.autograd.grad(ops.flash_attention(q, q, q), q,
                                          torch.ones_like(q))
        assert all(g.dtype == bf and g.device.type == "meta" for g in got)
        bwd = [c for c in calls if c.name == "flash_attention_bwd"]
        assert len(bwd) == 1 and bwd[0].dtype == "bfloat16"
        assert bwd[0].nbytes == 2 * 8 * 16 * 2 * 16 + 4 * 2 * 16
        return
    elif what == "k5 bf16":
        with pytest.raises(TypeError, match="float32") as err:
            k5.ssd(m(1, 64, 2, 16, dtype=bf), m(1, 64, 2, dtype=bf),
                   m(1, 64, 8, dtype=bf), m(1, 64, 8, dtype=bf), chunk=64)
    elif what == "k6 bf16":
        with pytest.raises(TypeError, match="float32") as err:
            k6.rglru_scan(m(1, 4, 8, dtype=bf), m(1, 4, 8, dtype=bf))
    elif what == "mixed devices":
        with pytest.raises(ValueError, match="on one CUDA device") as err:
            k1.graph_mix(m(2, 3), torch.zeros(3, 4))
    elif what == "no target":
        q = m(1, 16, 2, 16)
        with pytest.raises(ValueError, match="SM count") as err:
            k4.flash_attention_bwd(q, q, q, q, m(1, 2, 16), q)
    else:
        with pytest.raises(ValueError, match="head_dim") as err:
            k4.flash_attention(m(1, 8, 2, 24), m(1, 8, 2, 24),
                               m(1, 8, 2, 24))
    assert isinstance(err.value, kmeta.Refusal) == (
        what not in ("mixed devices", "no target"))


def test_cpu_and_cuda_tensors_keep_their_paths():
    """A CPU tensor still takes the plain version through `ops`; the
    wrapper itself still refuses it (no fallback): "meta" adds a path,
    it replaces none."""
    A, W = torch.rand(3, 4), torch.rand(4, 5)
    torch.testing.assert_close(ops.graph_mix(A, W), ref.graph_mix_ref(A, W))
    with pytest.raises(ValueError, match="CUDA"):
        k1.graph_mix(A, W)
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 2, 16))


def test_peak_tracker_counts_allocations_not_in_place_ops_or_the_host():
    x = torch.empty(1000, device="meta")
    with PeakTracker() as pt:
        for _ in range(3):
            y = x * 2          # 4,000 bytes -> 4,096
            y.add_(1)          # in place: no new storage
            z = y.view(10, 100)    # a view: none either
            del y, z
        keep = x + 1
        torch.arange(100)      # host arithmetic is not device memory
    assert pt.peak == 4096 and pt.now == 4096
    del keep
    assert pt.now == 0


def test_count_step_peak_sees_what_a_composite_op_allocates():
    """Under inference mode ``matmul`` reaches the counters whole; its
    ``reshape`` of a transposed input copies it on the card.
    `count_step`'s tracker sits beneath `OpCounter`, which decomposes an
    op that has no kernel of its own, so it counts both copies and the
    product, as the tracker alone does in grad mode (where autograd
    decomposes the op first); the tracker alone under inference mode
    sees the product only. ``silu_backward`` has a kernel of its own (a
    composite one too): it runs whole, one output and no temporaries."""
    q = m(2, 8, 4, 16).transpose(1, 2)          # (2, 4, 8, 16)
    k = m(2, 8, 4, 16).permute(0, 2, 3, 1)      # (2, 4, 16, 8)

    def step():
        with torch.inference_mode():
            return torch.matmul(q, k)
    with PeakTracker() as grad_mode:
        torch.matmul(q, k)
    with PeakTracker() as alone:
        step()
    want = 2 * 4 * 8 * 16 * 4 * 2 + 2 * 4 * 8 * 8 * 4
    assert count_step(step).peak_bytes == grad_mode.peak == want
    assert alone.peak == 2 * 4 * 8 * 8 * 4
    g, x = m(64, 128), m(64, 128)
    count = count_step(lambda: torch.ops.aten.silu_backward(g, x))
    assert count.peak_bytes == 64 * 128 * 4
    assert count.hbm_bytes == 3 * 64 * 128 * 4


def _reduced_step(arch, kind, mode=torch.inference_mode):
    cfg = get_config(arch).reduced().replace(dtype="float32")
    model = build_model(cfg, device="meta", loss_chunks=2)
    if kind == "train":
        opt = adamw(1e-3)
        state = opt.init(dict(model.named_parameters()))
        train = make_train_step(model, opt)
        batch = {"tokens": m(2, 65, dtype=torch.int64)}
        if cfg.family == "audio":
            batch["frames"] = m(2, 64, cfg.d_model)
        return lambda: train(state, batch)
    if kind == "prefill":
        prefill = make_prefill_step(model)
        batch = {"tokens": m(2, 64, dtype=torch.int64)}

        def step():
            with mode():
                return prefill(batch)
        return step
    decode = make_decode_step(model)
    caches = model.init_cache(2, 64)
    token = m(2, 1, dtype=torch.int64)

    def step():
        with mode():
            return decode(caches, token, 63)
    return step


@pytest.mark.parametrize("arch, kind", [
    ("qwen3-0.6b", "train"), ("qwen3-0.6b", "prefill"),
    ("qwen3-0.6b", "decode"), ("whisper-medium", "train")])
def test_count_step_peak_is_the_trackers_alone(arch, kind):
    """`count_step`'s counters hold no tensor alive: on reduced train,
    prefill and decode steps its peak is the tracker's alone
    (FlopCounterMode's module hooks would hold whisper's activations,
    which is why `OpCounter` counts the flops). The serving steps run
    under inference mode for `count_step` and under no_grad for the
    tracker alone, where autograd decomposes ``matmul`` before the
    tracker sees it, as `OpCounter` does under inference mode."""
    plain = _reduced_step(arch, kind, torch.no_grad)
    with kmeta.target(SMS), PeakTracker() as alone:
        plain()
    assert count_step(_reduced_step(arch, kind)).peak_bytes == alone.peak > 0


def test_op_counter_reads_inputs_and_writes_outputs_once():
    a, b = m(8, 16), m(16, 4)
    with OpCounter() as oc:
        a.view(16, 8)          # a view moves nothing
        torch.empty(5, device="meta")
        a @ b
    assert oc.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    (site, (nbytes, flops)), = oc.by_site.items()
    assert site.endswith("test_torch_roofline.py:"
                         "test_op_counter_reads_inputs_and_writes_outputs_"
                         "once") or site == "other"
    assert flops == 2 * 8 * 16 * 4


class _Plain(nn.Module):
    """A kernel's plain version run as a module, so FlopCounterMode keeps
    its flops (forward and backward) apart."""

    def forward(self, fn, *args, **kw):
        return fn(*args, **kw)


@contextlib.contextmanager
def _plain_as_module():
    region = _Plain()
    names = ("flash_attention_ref", "ssd_ref", "linear_scan_ref")
    saved = {n: getattr(ref, n) for n in names}
    try:
        for n, f in saved.items():
            setattr(ref, n, lambda *a, _f=f, **k: region(_f, *a, **k))
        yield
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_meta_flops_equal_the_cpu_step_outside_the_kernels(arch):
    """FlopCounterMode's per-op table of a reduced train step (loss and
    gradients, remat "full") on "meta" equals the CPU's, op by op, once
    the plain versions' flops (where the card runs K4, K5 or K6) are
    taken out; on "meta" those kernels' flops are their `work`, which
    `count_step` adds."""
    cfg = get_config(arch).reduced().replace(dtype="float32")
    model = build_model(cfg, device="meta", loss_chunks=2)
    model.init(prng.PRNGKey(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 65),
                           generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    with _plain_as_module(), FlopCounterMode(display=False) as fc:
        torch.autograd.grad(model.loss({"tokens": tokens})[0], params)
    table = fc.get_flop_counts()
    plain = table.get("_Plain", {})
    cpu = {str(op).split(".")[-1]: n - plain.get(op, 0)
           for op, n in table["Global"].items()}
    twin = build_model(cfg, device="meta", loss_chunks=2)
    meta_params = list(twin.parameters())
    mt = {"tokens": torch.empty((2, 65), dtype=torch.int64, device="meta")}
    count = count_step(lambda: torch.autograd.grad(twin.loss(mt)[0],
                                                   meta_params))
    assert {k: v for k, v in cpu.items() if v} == \
        {k: v for k, v in count.flops_by_op.items() if v}
    assert count.kernel_flops == sum(c.flops for c in count.kernels) > 0
    assert count.flops == sum(count.flops_by_op.values()) + \
        count.kernel_flops
    bytes_rows, flop_rows = breakdown(count, top=50)
    assert any(s.startswith("kernel:") for s, _ in flop_rows)
    assert sum(v for _, v in bytes_rows) == count.hbm_bytes


def test_cards_and_roofline_terms():
    """One hardware table: a device name picks its row (the PCIe card
    before the SXM one); the terms are the counts over its rates, the
    kernels' flops at their dtype's peak."""
    assert card_for("NVIDIA H100 80GB HBM3") == CARDS["H100"]
    assert card_for("NVIDIA H100 PCIe") == CARDS["H100 PCIe"]
    assert card_for("NVIDIA A100-SXM4-80GB") is None
    assert CARDS["H100"][:3] == (3.35e12, 67e12, 989e12)
    hw = HW()
    call = kmeta.KernelCall("flash_attention", 0, 989, "bfloat16")
    t = roofline_terms(67e12 + 989, 3.35e12 * 2, 450e9 * 3, hw,
                       kernels=[call])
    assert t["compute_s"] == pytest.approx(1.0 + 1e-12)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(3.0)
    assert t["dominant"] == "collective_s"


def test_count_step_counts_collectives_and_the_record_says_modelled():
    """The collectives of a step on a `ShapeMesh` are its `CallRecord`s,
    counted as the bytes the rank receives; the record marks its rates
    as the data sheet's and its HBM bytes as an unfused bound."""
    from repro_torch.sharding import collectives as coll

    mesh = coll.ShapeMesh((2, 4), ("data", "model"), 5)
    x = m(3, 8)
    count = count_step(lambda: (coll.psum(x, mesh, "model"),
                                coll.all_gather_rows(x, mesh, ("data",))))
    assert [r.op for r in count.records] == ["psum", "all_gather"]
    assert count.collective_bytes == 96 * 3 + 96 * 1
    rec = analyze_count(count, modelled_collective_bytes=10)
    assert rec["per_device"]["collective_bytes"] == 96 * 4 + 10
    assert "data-sheet" in rec["rates_note"]
    assert "upper bound" in rec["hbm_bytes_note"]
