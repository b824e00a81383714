#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero unless all pass):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the port from the sources in this checkout
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it;
4. the port's main path: Algorithm 1 through
   `repro_torch.core.dpfl.run_dpfl` on PaperCNN at its published width
   (32 clients, 3 rounds), with the kernel launch counts zeroed just
   before and read just after, the run's invariants and a learning
   check; then the same entry point on a small input on the card and
   on the CPU, which must agree;
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
# Learning check: the JAX reference on this configuration, on the CPU,
# reaches a mean best-validation test accuracy of LEARN_REF
# (`PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_reference_smoke.py`,
# jax 0.9.0 on x86-64; its mean validation accuracy per round was 0.628,
# 0.760, 0.870); chance is 1/10. The port must reach LEARN_MIN: the
# reference's figure less a margin of 0.1 for graph decisions that fp
# noise may flip.
LEARN_REF = 0.8583984375
LEARN_MIN = 0.75

# K1 shapes: (M, N, P, dtype) — the Eq.-4 mix, one BGGC phase-1 batch,
# one client's set sum, a ragged P, and bf16 W
K1_SHAPES = [(32, 32, PAPER_CNN_PARAMS, "float32"),
             (32, 4, PAPER_CNN_PARAMS, "float32"),
             (1, 32, PAPER_CNN_PARAMS, "float32"),
             (7, 5, 1000, "float32"),
             (32, 32, PAPER_CNN_PARAMS, "bfloat16")]
K1_TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # tests/test_kernels.py

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

    errs = []
    for M, N, P, dt, A, W in inputs:
        got = k1.graph_mix(A, W)
        want = ref.graph_mix_ref(A, W)
        torch.cuda.synchronize()
        if got.shape != (M, P) or got.dtype != W.dtype:
            fail(f"K1 {M}x{N}@{N}x{P} {dt}: got {tuple(got.shape)} "
                 f"{got.dtype}")
        tol = K1_TOL[dt]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"K1 {M}x{N}@{N}x{P} {dt}: max abs err {err} over "
                 f"atol=rtol={tol}")
        errs.append(err)
    return errs


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
        t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
        rows.append(dict(M=M, N=N, P=P, dtype=dt, max_abs_err=err,
                         tol=K1_TOL[dt], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, flops=flops))
        print(f"  K1 {M:>2}x{N:>2} @ {N:>2}x{P:<6} {dt:<8} err {err:.3g} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"matmul {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
              f"  bound {max(t_bytes, t_ops):.4f} ms")
    return rows


def run_main_path(torch):
    """Algorithm 1 at full PaperCNN width on the card; returns the
    result, the engine, the K1 launch count and the wall time."""
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core.dpfl import DPFLConfig, run_dpfl
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.models.classifier import PaperCNN

    data = make_federated_classification(**SMOKE_DATA)
    engine = FLEngine(PaperCNN(CNNConfig()), data, lr=SMOKE_LR,
                      batch_size=SMOKE_BATCH)
    if engine.n_params != PAPER_CNN_PARAMS:
        fail(f"PaperCNN has {engine.n_params} params, "
             f"expected {PAPER_CNN_PARAMS}")
    cfg = DPFLConfig(**SMOKE_RUN)
    torch.cuda.synchronize()
    k1.graph_mix.launches = 0
    t0 = time.perf_counter()
    res = run_dpfl(engine, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k1.graph_mix.launches
    return res, engine, cfg, launches, seconds


def check_main_path(res, engine, cfg, launches):
    """The invariants of a dense refresh_period=1 run."""
    import numpy as np

    N = SMOKE_DATA["n_clients"]
    P = engine.n_params
    B = cfg.budget
    want = math.ceil(N / B) + 1 + 2 * cfg.rounds
    if launches != want:
        fail(f"K1 launched {launches} times on the main path, expected "
             f"ceil(N/B) + 1 + 2*rounds = {want}")
    if res.comm_preprocess != 2 * N * (N - 1):
        fail(f"comm_preprocess {res.comm_preprocess} != 2N(N-1)")
    if res.comm_bytes != [d * 4 * P for d in res.comm_downloads]:
        fail("comm_bytes != downloads * 4P")
    omega = res.omega.astype(bool)
    for t, d in enumerate(res.comm_downloads):
        if d != int(omega.sum()) - N:   # every round refreshes
            fail(f"round {t}: {d} downloads, Omega has {omega.sum() - N}")
    if len(res.graph_history) != cfg.rounds:
        fail(f"{len(res.graph_history)} graphs for {cfg.rounds} rounds")
    for t, g in enumerate(res.graph_history):
        g = np.asarray(g, bool)
        off = g & ~np.eye(N, dtype=bool)
        if not np.all(np.diag(g)):
            fail(f"round {t}: graph diagonal not set")
        if off.sum(axis=1).max() > B:
            fail(f"round {t}: a client selected more than {B} peers")
        if np.any(g & ~omega):
            fail(f"round {t}: graph leaves Omega")
    if res.best_flat.shape != (N, P) or not np.isfinite(res.best_flat).all():
        fail("best_flat is not a finite (N, P) table")
    accs = np.concatenate([res.test_acc] + list(res.val_acc_history))
    if not np.isfinite(accs).all():
        fail("non-finite accuracies")
    mean_acc = float(np.mean(res.test_acc))
    if mean_acc < LEARN_MIN:
        fail(f"mean test accuracy {mean_acc:.4f} < {LEARN_MIN} (JAX "
             f"reference {LEARN_REF})")
    return mean_acc


def check_small_input(torch):
    """The same entry point on a small input (MLP, 6 clients), on the card
    and on the CPU: graphs and counters equal, models within fp noise."""
    import numpy as np

    from repro_torch.core.dpfl import DPFLConfig, run_dpfl
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    data = make_federated_classification(
        seed=5, n_clients=6, n_clusters=2, partition="pathological",
        classes_per_client=3, feature_dim=8, n_train=16, n_val=16,
        n_test=16, noise=2.0, assign_level="cluster")
    cfg = DPFLConfig(rounds=4, tau_init=2, tau_train=1, budget=3, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = FLEngine(MLP(8, 16, 10), data, lr=0.05, batch_size=8,
                       device=dev)
        out[dev] = run_dpfl(eng, cfg)
    gpu, cpu = out["cuda"], out["cpu"]
    if gpu.comm_downloads != cpu.comm_downloads or \
            not np.array_equal(gpu.omega, cpu.omega) or \
            not all(np.array_equal(a, b) for a, b in
                    zip(gpu.graph_history, cpu.graph_history)):
        fail("small input: card and CPU runs select different graphs")
    err = float(np.abs(gpu.best_flat - cpu.best_flat).max())
    if not np.allclose(gpu.best_flat, cpu.best_flat, rtol=1e-4, atol=1e-5):
        fail(f"small input: best_flat differs by {err}")
    return err


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
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    # ---- 3. K1 against its plain version
    k1_in = k1_inputs(torch)
    k1_errs = check_k1(torch, k1_in)
    print(f"K1 agrees with its plain version at {len(k1_in)} shapes "
          f"(max abs err {max(k1_errs):.3g})")

    # ---- 4. the main path
    res, engine, cfg, launches, seconds = run_main_path(torch)
    mean_acc = check_main_path(res, engine, cfg, launches)
    print(f"run_dpfl: PaperCNN P={engine.n_params} N="
          f"{SMOKE_DATA['n_clients']} rounds={cfg.rounds}: "
          f"{seconds:.3f} s wall incl. preprocessing "
          f"({cfg.rounds / seconds:.4f} rounds/s), K1 launches {launches}, "
          f"comm_downloads {res.comm_downloads}, mean test acc "
          f"{mean_acc:.4f}, mean val acc per round "
          f"{[round(float(v.mean()), 4) for v in res.val_acc_history]}")
    small_err = check_small_input(torch)
    print(f"small input: card and CPU agree (best_flat max abs diff "
          f"{small_err:.3g})")

    # ---- 5. K1 timed, after the main path has brought the card's clocks
    # up from idle
    k1_rows = time_k1(torch, k1_in, k1_errs, rates)
    print("clocks.sm, power.draw after timing: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())

    # ---- 6. results
    main_row = k1_rows[0]
    print(json.dumps({"kernels": [{
        "name": "graph_mix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/graph_mix.cu",
        "replaces": "src/repro/kernels/graph_mix.py:35",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows
                           if r["dtype"] == "float32"),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": k1_rows}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
