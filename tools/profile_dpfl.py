"""Where the time of the port's main path goes on the card.

Runs `repro_torch.core.dpfl.run_dpfl` on the configuration of
``chip_smoke.py`` (PaperCNN at its published width, 32 clients) in one
of its main-path variants (``chip_smoke.VARIANTS``: dense; sparse; dense
top-k; sparse top-k; dense-markov; sparse-freerider-clipped;
topk-signflip-clipped; dense-labelflip-trimmed) once to warm up, then once under ``torch.profiler`` and prints one JSON
line: the wall time, the summed device-kernel time and the device's idle
share, the time of each phase (preprocessing vs the round loop, by
CUDA-synced host clock), and the kernels that take the most device time,
the port's own kernels among them. With ``--lm`` it runs the LM example
instead (``examples/lm_dpfl_torch.py`` at ``chip_smoke.LM_DPFL_FULL``:
qwen3-0.6b's widths on 2 layers, 4 clients, the example's
`DPFLConfig`), its init included in the preprocessing.

    python3 tools/profile_dpfl.py [--rounds 3] [--variant dense]
    python3 tools/profile_dpfl.py --lm
    python3 tools/profile_dpfl.py --variant sparse --cudnn-ab

``--cudnn-ab`` prices `FLEngine`'s switch to cuDNN's deterministic
algorithms: it measures four times in turns, with
``torch.backends.cudnn.deterministic`` False, True, True, False (each a
warm-up run and a profiled one), one JSON line each.

``--spans`` gives the operator's view of the round by the program's own
spans (`repro_torch.obs`), at the settings of a benchmark cell
(``--cell``, by default the dense cell ``papercnn-n100.dense``: 100
clients of 450/50/100 images, 5 local epochs of batch 50 a round, budget
10; the engine, inputs and `DPFLConfig` as `bench/` builds them). After the
preprocessing and a warm round it first prices tracing: windows of
``--window-rounds`` untraced rounds with `obs` off and with
``obs.enable()``, in turns, ``--pairs`` of each (the host time a round,
each side's median and quartile spread). Then it profiles ``--rounds``
rounds and charges each device operation to the innermost span open on
the host when it was launched (its CUDA runtime call, by correlation
id, on the clock the spans and the profiler share): each span's device
milliseconds a round (the union of its operations' intervals), its
kernel launches a round, and the device's idle milliseconds a round
charged to the innermost span open on the host when the device went
idle; beside them the host milliseconds a round inside each span, the
greedy's counters against the hand count from Omega, every counter a
round (K5's calls and tokens among them), and how far the records'
starts lie from their profiler ranges'. One JSON line, written also to
``profile_spans.json`` in the git-ignored output directory.

    python3 tools/profile_dpfl.py --spans [--rounds 3] [--pairs 4] \
        [--cell granite-4.0-h-micro-l10-n4.dense-blocked]

Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import bisect
import json
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--variant", default="dense",
                    choices=list(chip_smoke.VARIANTS))
    ap.add_argument("--cudnn-ab", action="store_true",
                    help="measure with cuDNN's deterministic algorithms "
                         "off, on, on, off")
    ap.add_argument("--lm", action="store_true",
                    help="the LM example at chip_smoke.LM_DPFL_FULL (its "
                         "own rounds; --rounds and --variant unused)")
    ap.add_argument("--spans", action="store_true",
                    help="a cell's round by the program's spans, and the "
                         "price of tracing (--variant unused)")
    ap.add_argument("--cell", default="papercnn-n100.dense",
                    help="--spans: the benchmark cell whose settings run")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--window-rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_dpfl: needs a CUDA card")
    if args.spans:
        spans(torch, args)
        return

    from repro_torch.core import dpfl

    if args.lm:
        import lm_dpfl_torch as ex

        from repro_torch.configs import get_config

        c = chip_smoke.LM_DPFL_FULL
        engine, _ = ex.lm_engine(
            get_config(c["arch"]).replace(n_layers=c["n_layers"],
                                          dtype="float32"),
            c["clients"], "cuda")
        cfg = dpfl.DPFLConfig(**ex.RUN)
        args.variant, args.rounds = f"lm {c}", cfg.rounds
    else:
        engine = chip_smoke.make_engine()
        cfg = chip_smoke.smoke_config(args.variant,
                                      **dict(chip_smoke.SMOKE_RUN,
                                             rounds=args.rounds))

    if not args.cudnn_ab:
        measure(torch, dpfl, engine, cfg, args)
        return
    for deterministic in (False, True, True, False):
        torch.backends.cudnn.deterministic = deterministic
        measure(torch, dpfl, engine, cfg, args,
                cudnn_deterministic=deterministic)


def measure(torch, dpfl, engine, cfg, args, **extra):
    """One warm-up run of ``cfg``, then one profiled; prints the line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # phase split by the host clock, each phase ending in a synchronize
    phases = {}
    pre = dpfl._preprocess

    def timed_preprocess(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pre(*a, **kw)
        torch.cuda.synchronize()
        phases["preprocess_s"] = time.perf_counter() - t0
        return out

    dpfl._preprocess = timed_preprocess
    dpfl.run_dpfl(engine, cfg)                 # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dpfl.run_dpfl(engine, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dpfl._preprocess = pre
    phases["rounds_s"] = wall - phases["preprocess_s"]

    # device-side events only (kernels, memsets, copies): the CPU-side
    # aten ops that launched them carry the same time again
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), **extra,
        "variant": args.variant, "rounds": args.rounds, "wall_s": wall,
        **phases,
        "rounds_per_s_loop": args.rounds / phases["rounds_s"],
        "device_kernel_s": device_s,
        "device_idle_share": 1.0 - device_s / wall,
        "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                         "calls": n, "share_of_device": us / 1e6 / device_s}
                        for us, k, n in rows[:args.top]],
        # the port's kernels: graph_mix, sparse_graph_mix and
        # compressed_graph_mix (its bucketing pass and its mix, two
        # kernels whose names both hold "graph_mix"), K7's
        # cnn_features_kernel (PaperCNN's inference forwards), and K4's
        # forward and backward kernels in the LM run
        "port_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                          "calls": n} for us, k, n in rows
                         if any(name in k for name in (
                             "graph_mix", "cnn_features",
                             "flash_attention"))],
    }))


# ------------------------------------------------------------------ spans
#: the label of what no span covers
OUTSIDE = "outside the spans"
#: host-side CUDA runtime and driver calls (a launch, a copy, a fill)
_API = re.compile(r"^cu(da)?[A-Z]")
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _spread(xs):
    """The median and the quartiles' distance over it."""
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return {"runs": xs, "median": med, "spread": (q3 - q1) / med}


def spans(torch, args):
    from torch.profiler import ProfilerActivity, profile

    from bench import harness
    from bench.entries import dpfl as entry
    from repro_torch import obs
    from repro_torch.core import dpfl
    from repro_torch.fl.round_engine import run_rounds

    cell = harness.load_cell(args.cell)
    fam = harness.family(cell)
    data = fam.make_data(cell.config, args.seed)
    engine = fam.make_engine(cell.config, data, "cuda")
    cfg = entry.dpfl_config(cell, args.seed)
    state, _ = dpfl.dpfl_initial_state(engine, cfg)
    N = data.n_clients
    eye = torch.eye(N, dtype=torch.bool, device=engine.device)
    candidates = int((state.aux["omega"] & ~eye).sum())
    step = dpfl.dpfl_round_step(engine, cfg)
    state = run_rounds(step, state, 1)
    torch.cuda.synchronize()

    # what tracing costs with no profiler: windows in turns
    cost = {"off": [], "on": []}
    for i in range(args.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                obs.enable()
            t0 = time.perf_counter()
            state = run_rounds(step, state, args.window_rounds)
            torch.cuda.synchronize()
            cost["on" if on else "off"].append(
                (time.perf_counter() - t0) / args.window_rounds)
            obs.disable()
            obs.reset()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = run_rounds(step, state, args.rounds)
        torch.cuda.synchronize()
    snap = obs.snapshot()
    out = by_span(prof.profiler.kineto_results.events(), snap)
    rounds = snap["counts"]["rounds"]
    probes = snap["counts"]["ggc.probe_models"]
    out.update(
        device=torch.cuda.get_device_name(0), power=_power(),
        cell=args.cell, seed=args.seed, rounds=rounds,
        counts_per_round={k: v / rounds
                          for k, v in sorted(snap["counts"].items())},
        round_ts=sorted({r.t for r in snap["records"]}),
        local_train_steps=snap["counts"]["local_train.steps"] / rounds,
        ggc_probes_per_round=probes / rounds,
        ggc_useful_share=100.0 * snap["tallies"][
            "ggc.candidate_probe_models"] / probes,
        ggc_useful_share_from_omega=100.0 * 4 * candidates * rounds / probes,
        step_s={k: _spread(v) for k, v in cost.items()},
        tracing_cost=statistics.median(cost["on"])
        / statistics.median(cost["off"]))
    line = json.dumps(out)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/profile_spans.json").write_text(line + "\n")
    print(line)


def _power():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    return kind() if callable(kind) else ""


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(records):
    """(times, labels): from ``times[i]`` on, ``labels[i]`` is the
    innermost span open on the host."""
    edges = sorted([(r.start_ns, 1, r) for r in records]
                   + [(r.end_ns, 0, r) for r in records],
                   key=lambda e: (e[0], e[1]))
    times, labels, open_ = [], [], []
    for t, starts, r in edges:
        if starts:
            open_.append(r)
        else:
            open_.remove(r)
        times.append(t)
        labels.append(open_[-1].name if open_ else OUTSIDE)
    return times, labels


def by_span(events, snap):
    """The device operations of a profile charged to the spans of
    ``snap`` (`repro_torch.obs.snapshot`): device ms, kernel launches
    and idle ms a round by innermost span, host ms a round by span."""
    from torch.autograd import DeviceType

    from repro_torch import obs

    records = snap["records"]
    rounds = snap["counts"]["rounds"]
    times, labels = _innermost(records)

    def label_at(t):
        i = bisect.bisect_right(times, t) - 1
        return labels[i] if i >= 0 else OUTSIDE

    device, launch_at, ranges = [], {}, defaultdict(list)
    mirrors = 0
    for ev in events:
        name, kind = ev.name(), _kind(ev)
        if ev.device_type() == DeviceType.CUDA:
            flag = getattr(ev, "is_user_annotation", None)
            if name.startswith(obs.PREFIX) or kind == "gpu_user_annotation" \
                    or (callable(flag) and flag()):
                mirrors += name.startswith(obs.PREFIX)
                continue
            if kind and kind not in _DEVICE_KINDS:
                continue
            start = ev.start_ns()
            device.append((start, start + ev.duration_ns(),
                           ev.correlation_id(),
                           kind == "kernel" or (not kind and not name
                                                .startswith(("Memcpy",
                                                             "Memset")))))
        elif name.startswith(obs.PREFIX):
            ranges[name[len(obs.PREFIX):]].append(ev.start_ns())
        elif _API.match(name) or kind in ("cuda_runtime", "cuda_driver"):
            launch_at[ev.correlation_id()] = ev.start_ns()

    ops, launches = defaultdict(list), defaultdict(int)
    for start, end, corr, kernel in device:
        t = launch_at.get(corr)
        label = label_at(t) if t is not None else "launch not found"
        ops[label].append((start, end))
        launches[label] += kernel
    merged = _union([(s, e) for s, e, *_ in device])
    idle = defaultdict(int)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        idle[label_at(end)] += nxt - end
    host = defaultdict(int)
    for r in records:
        host[r.name] += r.end_ns - r.start_ns
    # the records against their ranges on the profiler's clock
    starts = defaultdict(list)
    for r in records:
        starts[r.name].append(r.start_ns)
    clock = max((abs(a - b) for name, xs in starts.items()
                 for a, b in zip(sorted(xs), sorted(ranges[name]))),
                default=None)
    in_rounds = [r for r in records if r.name == "round"]
    window = max(r.end_ns for r in in_rounds) - min(r.start_ns
                                                   for r in in_rounds)
    busy = sum(e - s for s, e in merged)
    per = 1e6 * rounds
    names = sorted(set(ops) | set(idle), key=lambda k: -len(ops[k]))
    return {
        "by_innermost_span": {
            k: {"device_ms": sum(e - s for s, e in _union(ops[k])) / per,
                "launches": launches[k] / rounds,
                "idle_ms": idle[k] / per} for k in names},
        "host_ms": {k: v / per for k, v in sorted(host.items())},
        "launches_per_round": sum(launches.values()) / rounds,
        "busy_ms_per_round": busy / per,
        "window_ms_per_round": window / per,
        "idle_share": 1.0 - busy / window,
        "range_mirrors_skipped": mirrors,
        "records_per_round": len(records) / rounds,
        "clock_gap_us": None if clock is None else clock / 1e3}


if __name__ == "__main__":
    main()
