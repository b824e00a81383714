#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero unless all pass):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the port from the sources in this checkout
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it and at its edge cases: K1 graph_mix,
   K2 sparse_graph_mix (sentinel slots, all-sentinel rows, duplicate
   indices, B > N, ragged P, bf16), K3 compressed_graph_mix (duplicate
   indices, -1 pads, K and P off the tile);
4. the port's main paths: Algorithm 1 through
   `repro_torch.core.dpfl.run_dpfl` on PaperCNN at its published width
   (32 clients, 3 rounds) in four configurations (dense graphs without
   a codec; ``graph_repr="sparse"``; dense with the top-k codec; sparse
   with top-k), each with the kernel launch counts zeroed just before
   and read just after, the run's invariants (Omega equal to the dense
   run's) and a learning check; then the same entry point on a small
   input on the card and on the CPU (dense, sparse, top-k, int8), which
   must select the same graphs;
5. each kernel timed beside its plain version, the one PyTorch call
   that computes the same function, and its bound (after phase 4, so
   the card runs at its working clocks, not idle ones);
6. one JSON line of per-kernel results, then the device line.

Needs one CUDA card; exits non-zero, printing no result, without one or
without the port's sources beside it. Imports no JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# ---- the main-path configuration (tools/jax_reference_smoke.py runs the
# same one through the JAX reference)
SMOKE_DATA = dict(seed=0, n_clients=32, n_clusters=4,
                  partition="pathological", classes_per_client=3,
                  image_shape=(32, 32, 3), n_train=128, n_val=32, n_test=64,
                  noise=2.0, assign_level="cluster")
SMOKE_RUN = dict(rounds=3, tau_init=2, tau_train=1, budget=4, seed=0)
SMOKE_LR, SMOKE_BATCH = 0.01, 16
PAPER_CNN_PARAMS = 62006
TOPK_FRAC = 0.1
# The main-path runs: graph representation and codec of each (the
# variants of tools/jax_reference_smoke.py).
VARIANTS = {"dense": ("dense", None), "sparse": ("sparse", None),
            "topk": ("dense", "topk"), "sparse-topk": ("sparse", "topk")}
# Learning check: the JAX reference on each configuration, on the CPU,
# reaches a mean best-validation test accuracy of LEARN_REF
# (`PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_reference_smoke.py`,
# jax 0.9.0 on x86-64; its mean validation accuracy per round was 0.628,
# 0.760, 0.870 dense, 0.628, 0.760, 0.871 sparse, and 0.475, 0.512, 0.536
# with top-k in either representation: three rounds of top-k at 10 %
# learn slower). Chance is 1/10. The port must reach the reference's
# figure less a margin of 0.1, for graph decisions that fp noise may flip.
LEARN_REF = {"dense": 0.8583984375, "sparse": 0.8583984375,
             "topk": 0.54345703125, "sparse-topk": 0.54345703125}
LEARN_MARGIN = 0.1

# K1 shapes: (M, N, P, dtype) — the Eq.-4 mix, one BGGC phase-1 batch,
# one client's set sum, a ragged P, and bf16 W
K1_SHAPES = [(32, 32, PAPER_CNN_PARAMS, "float32"),
             (32, 4, PAPER_CNN_PARAMS, "float32"),
             (1, 32, PAPER_CNN_PARAMS, "float32"),
             (7, 5, 1000, "float32"),
             (32, 32, PAPER_CNN_PARAMS, "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # tests/test_kernels.py
# K2 cases: (name, N, B, P, dtype, index table, separate W_peers). The
# main path's: Omega-shaped lists (B = budget distinct peers) over one
# table (no codec) and over a separate decoded table (a codec).
K2_CASES = [("main", 32, 4, PAPER_CNN_PARAMS, "float32", "lists", False),
            ("main, W_peers=dec", 32, 4, PAPER_CNN_PARAMS, "float32",
             "lists", True),
            ("main bf16", 32, 4, PAPER_CNN_PARAMS, "bfloat16", "lists", True),
            ("sentinel slots", 16, 4, 2100, "float32", "random", True),
            ("all-sentinel rows", 6, 3, 40, "float32", "sentinel", True),
            ("duplicate indices", 16, 4, 2100, "float32", "zeros", True),
            ("B > N", 5, 7, 33, "float32", "random", True),
            ("ragged P, bf16", 9, 5, 1001, "bfloat16", "random", True)]
# K3 cases: (name, M, N, K, P, index table). The main path's: the top-k
# payload of (32, 62006) rows at topk_frac 0.1.
K3_CASES = [("main", 32, 32, 6201, PAPER_CNN_PARAMS, "topk"),
            ("duplicate indices", 12, 12, 300, 900, "duplicates"),
            ("-1 pads", 12, 12, 300, 900, "pads"),
            ("K, P off the tile", 7, 5, 33, 1000, "topk"),
            ("M > 32 rows", 40, 9, 77, 515, "duplicates")]

# (HBM bytes/s, fp32 FLOP/s outside the tensor cores), NVIDIA data sheets
CARDS = {"H200": (4.8e12, 67e12), "H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return rates
    fail(f"no published rates for {name!r}: the port targets Hopper")


def _close(torch, label, got, want, tol):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: got {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{label}: max abs err {err} over atol=rtol={tol}")
    return err


def _bound(rates, nbytes, flops):
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, torch, reps: int = 50, warmup: int = 10) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events.
    Before each run a 64 MiB write evicts the 50 MB L2 (the round loop
    finds W after local training has streamed activations through it),
    and a spin kernel holds the card while the host enqueues the events
    and ``fn``'s launches, so the interval holds device time only, not
    the host's launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(torch):
    """Seeded (A, W) on the card for every K1 shape: A row-stochastic
    like the Eq.-4 matrix, W normal in the shape's dtype."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for M, N, P, dt in K1_SHAPES:
        A = torch.rand((M, N), generator=gen, device="cuda")
        A = A / A.sum(dim=1, keepdim=True)
        W = torch.randn((N, P), generator=gen, device="cuda")
        out.append((M, N, P, dt, A, W.to(getattr(torch, dt))))
    return out


def check_k1(torch, inputs):
    """K1 against its plain version at every shape; returns the max
    abs error per shape."""
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import ref

    return [_close(torch, f"K1 {M}x{N}@{N}x{P} {dt}", k1.graph_mix(A, W),
                   ref.graph_mix_ref(A, W), TOL[dt])
            for M, N, P, dt, A, W in inputs]


def time_k1(torch, inputs, errs, rates):
    """K1, its plain version and the yardstick matmul timed at every
    shape, beside the bound; returns the rows."""
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import ref

    rows = []
    for (M, N, P, dt, A, W), err in zip(inputs, errs):
        ms = time_ms(lambda: k1.graph_mix(A, W), torch)
        plain_ms = time_ms(lambda: ref.graph_mix_ref(A, W), torch)
        lib_ms = (time_ms(lambda: torch.matmul(A, W), torch)
                  if dt == "float32" else None)
        elt = W.element_size()
        nbytes = 4 * M * N + elt * (N * P + M * P)
        flops = 2 * M * N * P
        bound_ms, bound_by = _bound(rates, nbytes, flops)
        rows.append(dict(M=M, N=N, P=P, dtype=dt, max_abs_err=err,
                         tol=TOL[dt], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops))
        print(f"  K1 {M:>2}x{N:>2} @ {N:>2}x{P:<6} {dt:<8} err {err:.3g} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"matmul {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
              f"  bound {bound_ms:.4f} ms")
    return rows


def k2_inputs(torch):
    """Seeded K2 inputs on the card for every case: (name, dtype, self_w,
    nbr_w, idx, W_self, W_peers)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for name, N, B, P, dt, table, separate in K2_CASES:
        if table == "lists":
            # B distinct peers per client, ascending, none of them itself
            # (what the budget-constrained greedy emits)
            pick = torch.rand((N, N), generator=gen, device="cuda")
            pick.fill_diagonal_(2.0)
            idx = torch.sort(torch.argsort(pick, dim=1)[:, :B], dim=1).values
        elif table == "random":
            idx = torch.randint(-1, N, (N, B), generator=gen, device="cuda")
        elif table == "zeros":
            idx = torch.zeros((N, B), dtype=torch.int64, device="cuda")
        else:
            idx = torch.full((N, B), -1, dtype=torch.int64, device="cuda")
        idx = idx.to(torch.int32)
        sw = torch.rand((N,), generator=gen, device="cuda")
        nw = torch.rand((N, B), generator=gen, device="cuda")
        nw = torch.where(idx >= 0, nw, 0.0)
        denom = sw + nw.sum(dim=1)
        sw, nw = sw / denom, nw / denom[:, None]
        dtype = getattr(torch, dt)
        W = torch.randn((N, P), generator=gen, device="cuda").to(dtype)
        Wp = (torch.randn((N, P), generator=gen, device="cuda").to(dtype)
              if separate else W)
        out.append((name, dt, sw, nw.contiguous(), idx, W, Wp))
    return out


def k3_inputs(torch):
    """Seeded K3 inputs on the card for every case: (name, A, vals, idx,
    P), A row-stochastic with a zero diagonal as the caller passes it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for name, M, N, K, P, table in K3_CASES:
        A = torch.rand((M, N), generator=gen, device="cuda")
        A = A / A.sum(dim=1, keepdim=True)
        A = A * (1.0 - torch.eye(M, N, device="cuda"))
        x = torch.randn((N, P), generator=gen, device="cuda")
        if table == "topk":
            idx = torch.topk(x.abs(), K, dim=1).indices
            vals = x.gather(1, idx)
        else:
            # few distinct columns per row, so indices repeat
            idx = torch.randint(0, max(1, P // 8), (N, K), generator=gen,
                                device="cuda") * 8
            vals = torch.randn((N, K), generator=gen, device="cuda")
            if table == "pads":
                idx = torch.where(torch.rand((N, K), generator=gen,
                                             device="cuda") < 0.3, -1, idx)
        out.append((name, A.contiguous(), vals.contiguous(),
                    idx.to(torch.int32).contiguous(), P))
    return out


def check_k2(torch, inputs):
    """K2 against its plain version in every case; returns the max abs
    error per case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_graph_mix as k2

    return [_close(torch, f"K2 {name} {dt}",
                   k2.sparse_graph_mix(sw, nw, idx, W, Wp),
                   ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp), TOL[dt])
            for name, dt, sw, nw, idx, W, Wp in inputs]


def check_k3(torch, inputs):
    """K3 against its plain version in every case, plus the exact
    duplicate-index case of tests/test_kernels.py; returns the max abs
    error per case."""
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import ref

    errs = [_close(torch, f"K3 {name}",
                   k3.compressed_graph_mix(A, vals, idx, P),
                   ref.compressed_graph_mix_ref(A, vals, idx, P),
                   TOL["float32"])
            for name, A, vals, idx, P in inputs]
    got = k3.compressed_graph_mix(
        torch.eye(2, device="cuda"),
        torch.tensor([[1.0, 2.0, 4.0], [0.5, 0.25, 0.125]], device="cuda"),
        torch.tensor([[3, 3, 0], [1, 1, 1]], dtype=torch.int32,
                     device="cuda"), 5)
    want = torch.tensor([[4.0, 0, 0, 3.0, 0], [0, 0.875, 0, 0, 0]],
                        device="cuda")
    if not torch.equal(got, want):
        fail(f"K3 duplicate indices: {got.tolist()} != {want.tolist()}")
    return errs


def time_k2(torch, inputs, errs, rates):
    """K2, its plain version and the yardstick (`torch.matmul` by the
    equivalent dense (N, N) Eq.-4 matrix, the same function where
    W_peers is W_self) timed at the main path's shapes, beside the bound;
    returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_graph_mix as k2

    rows = []
    for (name, dt, sw, nw, idx, W, Wp), err in zip(inputs, errs):
        if not name.startswith("main"):
            continue
        N, B = idx.shape
        P = W.shape[1]
        ms = time_ms(lambda: k2.sparse_graph_mix(sw, nw, idx, W, Wp), torch)
        plain_ms = time_ms(
            lambda: ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp), torch)
        lib_ms = None
        if Wp is W and dt == "float32":
            A = torch.diag(sw).index_put_(
                (torch.arange(N, device="cuda")[:, None].expand(N, B),
                 idx.clamp_min(0).long()),
                torch.where(idx >= 0, nw, 0.0), accumulate=True)
            lib_ms = time_ms(lambda: torch.matmul(A, W), torch)
        elt = W.element_size()
        valid = idx >= 0
        peer_rows = 0 if Wp is W else int(torch.unique(idx[valid]).numel())
        nbytes = 4 * N + 8 * N * B + elt * (2 * N + peer_rows) * P
        flops = 2 * P * (N + int(valid.sum()))
        bound_ms, bound_by = _bound(rates, nbytes, flops)
        rows.append(dict(case=name, N=N, B=B, P=P, dtype=dt,
                         max_abs_err=err, tol=TOL[dt], ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, flops=flops))
        print(f"  K2 {name:<18} ({N}, {B}, {P}) {dt:<8} err {err:.3g} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  matmul "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
              f"bound {bound_ms:.4f} ms")
    return rows


def time_k3(torch, inputs, errs, rates):
    """K3 (the wrapper's stable sort included: the main path pays it), its
    plain version and the yardstick (`torch.sparse.mm` of the payload as
    a sparse COO (P, N) matrix by A^T, the sparse tensor built outside
    the timed window) at the main path's shape, beside the bound; returns
    the rows."""
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import ref

    rows = []
    for (name, A, vals, idx, P), err in zip(inputs, errs):
        if name != "main":
            continue
        M, N = A.shape
        K = vals.shape[1]
        ms = time_ms(lambda: k3.compressed_graph_mix(A, vals, idx, P),
                     torch)
        # the split: the wrapper's sort alone, the kernel alone
        sort_ms = time_ms(lambda: k3.sort_payload(vals, idx), torch)
        sv, si = k3.sort_payload(vals, idx)
        kernel_ms = time_ms(lambda: k3.launch_sorted(A, sv, si, P), torch)
        plain_ms = time_ms(
            lambda: ref.compressed_graph_mix_ref(A, vals, idx, P), torch)
        cols = torch.arange(N, device="cuda")[:, None].expand(N, K)
        S = torch.sparse_coo_tensor(
            torch.stack([idx.reshape(-1).long(), cols.reshape(-1)]),
            vals.reshape(-1), (P, N), check_invariants=False).coalesce()
        At = A.t().contiguous()
        lib_ms = time_ms(lambda: torch.sparse.mm(S, At), torch)
        entries = int((idx >= 0).sum())
        nbytes = 8 * N * K + 4 * M * N + 4 * M * P
        flops = 2 * M * entries
        bound_ms, bound_by = _bound(rates, nbytes, flops)
        rows.append(dict(case=name, M=M, N=N, K=K, P=P, dtype="float32",
                         max_abs_err=err, tol=TOL["float32"], ms=ms,
                         sort_ms=sort_ms, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, flops=flops))
        print(f"  K3 {name:<18} ({M}, {N}, {K}, {P}) err {err:.3g} "
              f"kernel+sort {ms:.4f} ms (sort {sort_ms:.4f}, kernel "
              f"{kernel_ms:.4f})  plain {plain_ms:.4f} ms  "
              f"sparse.mm {lib_ms:.4f} ms  bound {bound_ms:.4f} ms")
    return rows


def _zero_launches():
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import sparse_graph_mix as k2

    k1.graph_mix.launches = 0
    k2.sparse_graph_mix.launches = 0
    k3.compressed_graph_mix.launches = 0


def _read_launches():
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import sparse_graph_mix as k2

    return {"graph_mix": k1.graph_mix.launches,
            "sparse_graph_mix": k2.sparse_graph_mix.launches,
            "compressed_graph_mix": k3.compressed_graph_mix.launches}


def smoke_config(variant, **run):
    from repro_torch.core.dpfl import DPFLConfig
    from repro_torch.fl.compress import CompressionConfig

    repr_, codec = VARIANTS[variant]
    comp = (CompressionConfig(codec, topk_frac=TOPK_FRAC) if codec
            else None)
    return DPFLConfig(**run, graph_repr=repr_, compression=comp)


def make_engine():
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import PaperCNN

    data = make_federated_classification(**SMOKE_DATA)
    engine = FLEngine(PaperCNN(CNNConfig()), data, lr=SMOKE_LR,
                      batch_size=SMOKE_BATCH)
    if engine.n_params != PAPER_CNN_PARAMS:
        fail(f"PaperCNN has {engine.n_params} params, "
             f"expected {PAPER_CNN_PARAMS}")
    return engine


def run_main_path(torch, engine, variant):
    """Algorithm 1 at full PaperCNN width on the card in one variant;
    returns the result, the config, the launch counts of every kernel
    (zeroed just before the run, read just after) and the wall time."""
    from repro_torch.core.dpfl import run_dpfl

    cfg = smoke_config(variant, **SMOKE_RUN)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    res = run_dpfl(engine, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, cfg, _read_launches(), seconds


def expected_launches(variant, N, B, rounds):
    """Launches of each kernel in one refresh-every-round run: BGGC phase 1
    is ceil(N/B) K1 launches and each round's greedy init one more; the
    preprocessing mix and each round's mix are K1 (dense), K2 (sparse,
    with or without a codec) or, for the rounds of dense top-k, K3."""
    repr_, codec = VARIANTS[variant]
    sparse, topk = repr_ == "sparse", codec == "topk"
    k1 = math.ceil(N / B) + rounds
    if not sparse:
        k1 += 1 + (0 if topk else rounds)
    return {"graph_mix": k1,
            "sparse_graph_mix": 1 + rounds if sparse else 0,
            "compressed_graph_mix": rounds if topk and not sparse else 0}


def check_main_path(res, engine, cfg, variant, launches, omega_dense):
    """The invariants of a refresh_period=1 run; returns the mean test
    accuracy."""
    import numpy as np

    from repro_torch.fl.compress import bytes_per_model

    N = SMOKE_DATA["n_clients"]
    P = engine.n_params
    B = cfg.budget
    want = expected_launches(variant, N, B, cfg.rounds)
    if launches != want:
        fail(f"{variant}: kernel launches on the main path {launches}, "
             f"expected {want}")
    if res.comm_preprocess != 2 * N * (N - 1):
        fail(f"{variant}: comm_preprocess {res.comm_preprocess} != 2N(N-1)")
    if res.comm_bytes_preprocess != res.comm_preprocess * 4 * P:
        fail(f"{variant}: preprocessing not charged 4P per download")
    bpm = bytes_per_model(cfg.compression, P)
    if res.comm_bytes != [d * bpm for d in res.comm_downloads]:
        fail(f"{variant}: comm_bytes != downloads * {bpm}")
    omega = res.omega.astype(bool)
    if omega_dense is not None and not np.array_equal(omega, omega_dense):
        fail(f"{variant}: Omega differs from the dense run's")
    for t, d in enumerate(res.comm_downloads):
        if d != int(omega.sum()) - N:   # every round refreshes
            fail(f"{variant} round {t}: {d} downloads, Omega has "
                 f"{omega.sum() - N}")
    if len(res.graph_history) != cfg.rounds:
        fail(f"{variant}: {len(res.graph_history)} graphs for "
             f"{cfg.rounds} rounds")
    for t, g in enumerate(res.graph_history):
        g = np.asarray(g, bool)
        off = g & ~np.eye(N, dtype=bool)
        if not np.all(np.diag(g)):
            fail(f"{variant} round {t}: graph diagonal not set")
        if off.sum(axis=1).max() > B:
            fail(f"{variant} round {t}: a client selected more than {B} "
                 f"peers")
        if np.any(g & ~omega):
            fail(f"{variant} round {t}: graph leaves Omega")
    if res.best_flat.shape != (N, P) or not np.isfinite(res.best_flat).all():
        fail(f"{variant}: best_flat is not a finite (N, P) table")
    accs = np.concatenate([res.test_acc] + list(res.val_acc_history))
    if not np.isfinite(accs).all():
        fail(f"{variant}: non-finite accuracies")
    mean_acc = float(np.mean(res.test_acc))
    if mean_acc < LEARN_REF[variant] - LEARN_MARGIN:
        fail(f"{variant}: mean test accuracy {mean_acc:.4f} < "
             f"{LEARN_REF[variant] - LEARN_MARGIN:.4f} (JAX reference "
             f"{LEARN_REF[variant]} less {LEARN_MARGIN})")
    return mean_acc


def check_small_input(torch):
    """The same entry point on a small input (MLP, 6 clients), on the card
    and on the CPU, without a codec (dense and sparse) and with top-k and
    int8: graphs and counters equal, models within fp noise. Returns the
    best_flat max abs difference per run."""
    import numpy as np

    from repro_torch.core.dpfl import DPFLConfig, run_dpfl
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.compress import CompressionConfig
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    data = make_federated_classification(
        seed=5, n_clients=6, n_clusters=2, partition="pathological",
        classes_per_client=3, feature_dim=8, n_train=16, n_val=16,
        n_test=16, noise=2.0, assign_level="cluster")
    run = dict(rounds=4, tau_init=2, tau_train=1, budget=3, seed=0)
    configs = {
        "dense": DPFLConfig(**run),
        "sparse": DPFLConfig(**run, graph_repr="sparse"),
        "topk": DPFLConfig(**run, compression=CompressionConfig("topk")),
        "int8": DPFLConfig(**run, compression=CompressionConfig("int8"))}
    engines = {dev: FLEngine(MLP(8, 16, 10), data, lr=0.05, batch_size=8,
                             device=dev) for dev in ("cuda", "cpu")}
    errs = {}
    for name, cfg in configs.items():
        gpu, cpu = (run_dpfl(engines[d], cfg) for d in ("cuda", "cpu"))
        if gpu.comm_downloads != cpu.comm_downloads or \
                gpu.comm_bytes != cpu.comm_bytes or \
                not np.array_equal(gpu.omega, cpu.omega) or \
                not all(np.array_equal(a, b) for a, b in
                        zip(gpu.graph_history, cpu.graph_history)):
            fail(f"small input, {name}: card and CPU runs select "
                 f"different graphs or count differently")
        errs[name] = float(np.abs(gpu.best_flat - cpu.best_flat).max())
        if not np.allclose(gpu.best_flat, cpu.best_flat, rtol=1e-4,
                           atol=1e-5):
            fail(f"small input, {name}: best_flat differs by "
                 f"{errs[name]}")
    return errs


def _kernel_row(name, source, replaces, launches, rows):
    main = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "float32"),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    # the plain versions and the yardstick matmul run in IEEE fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {name}  count {torch.cuda.device_count()}")
    rates = card_rates(name)

    # ---- 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for kname, b in sorted(built.items()):
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname}: {line.strip()}")

    # ---- 3. each kernel against its plain version
    k1_in = k1_inputs(torch)
    k1_errs = check_k1(torch, k1_in)
    print(f"K1 agrees with its plain version at {len(k1_in)} shapes "
          f"(max abs err {max(k1_errs):.3g})")
    k2_in = k2_inputs(torch)
    k2_errs = check_k2(torch, k2_in)
    print(f"K2 agrees with its plain version in {len(k2_in)} cases "
          f"(max abs err {max(k2_errs):.3g})")
    k3_in = k3_inputs(torch)
    k3_errs = check_k3(torch, k3_in)
    print(f"K3 agrees with its plain version in {len(k3_in) + 1} cases "
          f"(max abs err {max(k3_errs):.3g})")

    # ---- 4. the main paths
    engine = make_engine()
    launches = {}
    omega_dense = None
    for variant in VARIANTS:
        res, cfg, counts, seconds = run_main_path(torch, engine, variant)
        mean_acc = check_main_path(res, engine, cfg, variant, counts,
                                   omega_dense)
        if omega_dense is None:
            omega_dense = res.omega.astype(bool)
        launches[variant] = counts
        print(f"run_dpfl {variant}: PaperCNN P={engine.n_params} N="
              f"{SMOKE_DATA['n_clients']} rounds={cfg.rounds}: "
              f"{seconds:.3f} s wall incl. preprocessing "
              f"({cfg.rounds / seconds:.4f} rounds/s), launches {counts}, "
              f"comm_downloads {res.comm_downloads}, comm_bytes "
              f"{res.comm_bytes}, mean test acc {mean_acc:.4f} (JAX "
              f"reference {LEARN_REF[variant]}), mean val acc per round "
              f"{[round(float(v.mean()), 4) for v in res.val_acc_history]}")
    small = check_small_input(torch)
    print(f"small input: card and CPU select the same graphs (best_flat "
          f"max abs diff {small})")

    # ---- 5. the kernels timed, after the main path has brought the
    # card's clocks up from idle
    k1_rows = time_k1(torch, k1_in, k1_errs, rates)
    k2_rows = time_k2(torch, k2_in, k2_errs, rates)
    k3_rows = time_k3(torch, k3_in, k3_errs, rates)
    print("clocks.sm, power.draw after timing: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())

    # ---- 6. results: launches summed over the four main-path runs, with
    # each run's counts beside them
    def total(kname):
        return sum(c[kname] for c in launches.values())

    rows = [
        _kernel_row("graph_mix", "src/repro_torch/kernels/csrc/graph_mix.cu",
                    "src/repro/kernels/graph_mix.py:35",
                    total("graph_mix"), k1_rows),
        _kernel_row("sparse_graph_mix",
                    "src/repro_torch/kernels/csrc/sparse_graph_mix.cu",
                    "src/repro/kernels/sparse_graph_mix.py:71",
                    total("sparse_graph_mix"), k2_rows),
        _kernel_row("compressed_graph_mix",
                    "src/repro_torch/kernels/csrc/compressed_graph_mix.cu",
                    "src/repro/kernels/compressed_graph_mix.py:66",
                    total("compressed_graph_mix"), k3_rows)]
    for row in rows:
        row["launches_by_run"] = {v: c[row["name"]]
                                  for v, c in launches.items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
