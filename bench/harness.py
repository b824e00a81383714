"""One run of one cell: set-up, the timed window, the trace, the check.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration (``configs/<config>.json``, whose
``family`` names the module under ``families/`` that builds the engine,
counts the model FLOPs and holds the plain reference model), its traffic
mix (``mixes/<traffic>.json``: its ``entry``, the module under
``entries/`` that sets the program up, runs its rounds and checks one,
and the settings that entry reads, such as the mix rule and the codec,
whose references are ``rules/<name>.py`` and ``codecs/<name>.py``), its
metrics (``metrics/<name>.py``, each a ``read(run)`` that returns a
number or None) and the limits of its check (``limits/<cell>.json``).

The window drives the entry's rounds in chunks with a synchronize only
between chunks, until ``--seconds`` have passed. Python's cyclic garbage
collector runs between chunks, on what the window made (set-up's objects
are frozen first), so that what a round leaves in reference cycles is
freed a chunk later, not whenever a full collection happens to come. A
traced run times the first half of its window untraced and traces the
second.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: warm rounds after the preprocessing, before the window
WARMUP_ROUNDS = 1
#: the least host time between two synchronizes of the window
CHUNK_SECONDS = 1.0


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    mix_name: str
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    #: the folder its families, entries, rules, codecs and metric readers
    #: are found in
    bench_dir: Path = BENCH


@dataclass
class RunRecord:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float = 0.0
    rounds: int = 0
    #: a traced run's untraced first half: its rounds and seconds
    untraced_rounds: int = 0
    untraced_s: float = 0.0
    peak_bytes: int = 0
    flops_per_round: float = 0.0
    trace: object = None
    calls: Dict[str, list] = field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered under its name first, as an import does (dataclasses
    # look their module up there)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(bench_dir: Path, kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder ``bench_dir``
    (a family, an entry, a mix rule's or a codec's reference, a metric's
    reader), loaded from its file as ``bench.<kind>.<name>``."""
    return load_module(bench_dir / kind / f"{name}.py",
                       f"bench.{kind}.{name.replace('.', '_')}")


def family(cell: Cell):
    return find(cell.bench_dir, "families", cell.config["family"])


def entry(cell: Cell):
    return find(cell.bench_dir, "entries", cell.mix["entry"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s `BENCHMARK.json`, with its files
    under ``root``'s ``bench/``."""
    bench = root / "bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    ends = [m for m in spec["end_to_end"]
            if name in m.get("workloads", [name])]
    reported = {m["name"] for m in ends}
    layers = [m for m in spec["per_layer"]
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in reported)]
    return Cell(
        name=name, config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        mix_name=w["traffic"],
        mix=json.loads((bench / "mixes" / f"{w['traffic']}.json")
                       .read_text()),
        chips=int(w["chips"]), end_to_end=ends, per_layer=layers,
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        bench_dir=bench)


def read_metrics(run: RunRecord, entries: List[dict]) -> Dict[str, dict]:
    """Each entry's reader; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for m in entries:
        reader = find(run.cell.bench_dir, "metrics", m["name"])
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", after_engine=None):
    """Run ``cell`` once; returns (result dict, stderr lines). ``t0`` is
    the process's start on the host clock. ``device`` "cpu" and
    ``after_engine(engine)`` are for the tests and the control
    (`control.py`); the benchmark itself runs on "cuda" with neither."""
    import torch

    from .spans import Spans
    from .trace import reduce, top

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- set-up: inputs, engine, the entry's preprocessing, a warm round
    fam, ent = family(cell), entry(cell)
    data = fam.make_data(cell.config, seed)
    engine = fam.make_engine(cell.config, data, device)
    if after_engine is not None:
        after_engine(engine)
    spans = Spans().install(engine)
    prog = ent.setup(fam, cell, data, engine, spans, seed)
    state, prog.state = prog.state, None
    sync()
    w0 = time.perf_counter()
    state = prog.run(state, WARMUP_ROUNDS)
    sync()
    chunk = max(1, int(CHUNK_SECONDS * WARMUP_ROUNDS
                       / max(time.perf_counter() - w0, 1e-6)))
    gc.collect()
    gc.freeze()
    record = RunRecord(cell=cell, setup_s=time.perf_counter() - t0,
                       flops_per_round=prog.flops_per_round)

    # -- the window; a traced run times its first half untraced
    if trace:
        state, record.untraced_rounds, record.untraced_s = timed_window(
            prog.run, state, seconds / 2, chunk, sync)
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
        spans.tracing = True
    state, record.rounds, record.window_s = timed_window(
        prog.run, state, seconds / 2 if trace else seconds, chunk, sync)
    t_close = time.perf_counter()
    t_stop = t_close
    if trace:
        spans.tracing = False
        prof.__exit__(None, None, None)
        t_stop = time.perf_counter()
        record.trace = reduce(prof.profiler.kineto_results.events(),
                              record.window_s, record.rounds)
        record.calls = spans.calls
        del prof
    t_trace = time.perf_counter()
    if cuda:
        record.peak_bytes = torch.cuda.max_memory_allocated()
    gc.unfreeze()

    # -- the check: one more round of the same step, its outputs kept,
    # the program freed, then the reference
    check_round = ent.capture(prog, state, spans)
    spans.uninstall()
    del state, engine
    prog.run = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    detail = {}
    if check_round is None:
        # the round never reached a stage the check reads
        readings = {k: math.inf for k in cell.limits}
    else:
        readings, detail = ent.check(fam, cell, data, prog.pre, check_round,
                                     seed, device)
        readings = {k: readings.get(k, math.inf) for k in cell.limits}
    t_check = time.perf_counter()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in the run: {', '.join(bad)}")

    # -- the result line and the lines before it on standard error
    correct = all(math.isfinite(readings[k]) and readings[k] <= cell.limits[k]
                  for k in cell.limits)
    result = {"correct": bool(correct), "attempted": record.rounds,
              "failed": 0,
              "metrics": read_metrics(record, cell.per_layer if trace
                                      else cell.end_to_end)}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": record.peak_bytes}
    if cuda:
        dev["power_limit"] = power_limit()
    lines = [f"phases: set-up {record.setup_s:.1f} s, window "
             f"{record.window_s:.1f} s ({record.rounds} rounds"
             + (f"; untraced first half {record.untraced_s:.1f} s, "
                f"{record.untraced_rounds} rounds" if trace else "")
             + "), trace "
             f"{t_trace - t_close:.1f} s ({t_stop - t_close:.1f} to stop the "
             f"profiler), check {t_check - t_trace:.1f} s"]
    if trace:
        tr = record.trace
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": top(tr.by_name),
                               "idle_gaps": top(tr.idle_by_layer)}
        lines.append(
            f"trace: {tr.device_ops} device operations ({tr.kernels} "
            f"kernels, {tr.unattributed} with no launch found), device "
            f"seconds by layer "
            f"{ {k: round(v, 6) for k, v in tr.layer_s.items()} }")
    else:
        result["device"] = dev
    result["checks"] = {k: {"value": readings[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    if detail:
        lines.append("worst leaves (client, leaf): " + ", ".join(
            f"{k} {v}" for k, v in detail.items()))
    lines += [f"check {k}: {readings[k]!r} (limit {cell.limits[k]!r})"
              for k in cell.limits]
    return result, lines


def timed_window(run, state, seconds: float, chunk: int, sync):
    """Rounds in chunks of ``chunk``, a collection of Python's cyclic
    garbage and a synchronize after each, until
    ``seconds`` of host time have passed; returns (state, rounds, the
    window's seconds)."""
    rounds = 0
    t0 = time.perf_counter()
    while True:
        state = run(state, chunk)
        rounds += chunk
        # what the chunk left in reference cycles, freed while the device
        # works
        gc.collect()
        sync()
        if time.perf_counter() - t0 >= seconds:
            break
    return state, rounds, time.perf_counter() - t0
