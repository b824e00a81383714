"""Every kernel wrapper of this tree against another tree's copies of the
wrapper files, in turns on one card: at each kernel's first timed shape
of chip_smoke.py (`chip_smoke.kernel_alloc_cases`: the shapes the dry-run
phase checks), the kernel's time (`chip_smoke.time_ms`, the kernels
JSON's ``ms``) and the wrapper's host time per call (the host clock over
CALLS calls enqueued back to back; the median of REPS such runs), as
tools/compare_k4_wrapper.py measures K4's.

DIR holds the other tree's ``graph_mix.py``, ``sparse_graph_mix.py``,
``compressed_graph_mix.py``, ``flash_attention.py``, ``ssd.py`` and
``rglru_scan.py``, each loaded as a module of this tree's
`repro_torch.kernels` package (so its kernel libraries are this tree's:
the kernel sources must not differ), e.g. the parent commit's:

    mkdir -p build/wrappers
    for f in graph_mix sparse_graph_mix compressed_graph_mix \\
        flash_attention ssd rglru_scan; do
      git show HEAD~1:src/repro_torch/kernels/$f.py > build/wrappers/$f.py
    done
    python3 tools/compare_kernel_wrappers.py build/wrappers

Order: the other tree, this tree twice, the other tree. Prints one JSON
line (also written to chiprun_out/compare_kernel_wrappers.json) with the
card's name and power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from compare_k4_wrapper import host_us, load  # noqa: E402

#: kernel -> the wrapper file that holds it
FILES = {"graph_mix": "graph_mix", "sparse_graph_mix": "sparse_graph_mix",
         "compressed_graph_mix": "compressed_graph_mix",
         "flash_attention": "flash_attention",
         "flash_attention_bwd": "flash_attention",
         "ssd": "ssd", "ssd_bwd": "ssd",
         "rglru_scan": "rglru_scan", "rglru_scan_bwd": "rglru_scan"}


def main(argv=None):
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree's wrapper files")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_kernel_wrappers: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build()
    other = {f: load(f"other_{f}", Path(args.other) / f"{f}.py")
             for f in set(FILES.values())}
    inputs = [f(torch) for f in (
        cs.k1_inputs, cs.k2_inputs, cs.k3_inputs, cs.k4_inputs,
        cs.k4_bwd_inputs, cs.k5_inputs, cs.k6_inputs, cs.k5_bwd_inputs,
        cs.k6_bwd_inputs)]
    rows = {}
    for name, call, _ in cs.kernel_alloc_cases(torch, *inputs):
        fn = getattr(other[FILES[name]], call.func.__name__)
        calls = {"other": functools.partial(fn, *call.args,
                                            **call.keywords),
                 "tree": call}
        row = rows[name] = {"order": [], "ms": [], "host_us": []}
        for side in ("other", "tree", "tree", "other"):
            row["order"].append(side)
            row["ms"].append(cs.time_ms(calls[side], torch))
            row["host_us"].append(host_us(calls[side], torch))
        print(f"{name}: " + ", ".join(
            f"{s} {m:.6f} ms, {h:.2f} us host" for s, m, h in
            zip(row["order"], row["ms"], row["host_us"])))
    out = {"card": smi, "kernels": rows}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "compare_kernel_wrappers.json").write_text(
        json.dumps(out))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
