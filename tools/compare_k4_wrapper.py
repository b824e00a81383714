"""K4's forward wrapper (`kernels/flash_attention.py`'s Python side) of this
tree against other copies of that file, in turns on one card: at
chip_smoke.py's fp32 serve shape (qwen3-0.6b: B 4, S 512, 16/8 heads of
128, no grad, outside any ``torch.func`` transform, as the serve prefill
calls it) the K4 row's time (`chip_smoke.time_ms`, the same measurement
as the kernels JSON's ``ms``) and the wrapper's host time per call (the
host clock over CALLS calls enqueued back to back, no sync between them;
the median of REPS such runs).

Each other copy is NAME=FILE, a ``flash_attention.py`` loaded as a module
of this tree's `repro_torch.kernels` package, so its relative imports and
its kernel library are this tree's (the kernel sources must not differ),
e.g. the parent commit's:

    mkdir -p build/k4cmp
    git show HEAD~1:src/repro_torch/kernels/flash_attention.py \\
        > build/k4cmp/parent.py
    python3 tools/compare_k4_wrapper.py parent=build/k4cmp/parent.py

Order: the copies as given, this tree twice, the copies in reverse.
Prints one JSON line (also written to chiprun_out/compare_k4_wrapper.json)
with the card's name and power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CALLS = 200
REPS = 5


def load(name, path):
    """The file at ``path`` as module ``repro_torch.kernels._cmp_<name>``."""
    mod_name = f"repro_torch.kernels._cmp_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, torch):
    """Median over REPS of the host's microseconds per call of ``fn``,
    CALLS calls enqueued back to back."""
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as tree

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("copies", nargs="+", help="NAME=FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_k4_wrapper: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    mods = {}
    for spec in args.copies:
        name, path = spec.split("=", 1)
        mods[name] = load(name, path)
    order = list(mods) + ["tree", "tree"] + list(mods)[::-1]
    mods["tree"] = tree
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, S, Hq, Hkv, hd = 4, 512, 16, 8, 128
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda") * 0.5
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda") * 0.5
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
    with torch.no_grad():
        want = tree.flash_attention(q, k, v)
        for name, mod in mods.items():
            if not torch.equal(mod.flash_attention(q, k, v), want):
                sys.exit(f"compare_k4_wrapper: {name} gives other bits")
        turns = []
        for name in order:
            f = mods[name].flash_attention
            turns.append(dict(copy=name,
                              ms=cs.time_ms(lambda: f(q, k, v), torch),
                              host_us=host_us(lambda: f(q, k, v), torch)))
            print(json.dumps(turns[-1]), flush=True)
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "shape": [B, S, Hq, Hkv, hd], "calls": CALLS, "reps": REPS,
              "turns": turns}
    line = json.dumps(result)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "compare_k4_wrapper.json").write_text(line)
    print(line)


if __name__ == "__main__":
    main()
