"""K5's backward of this tree against other builds of its source, in turns
on one card: the call's time at chip_smoke.py's timed backward shapes
(`K5_BWD_TIMED`: mamba2-370m's train shape and eight chunks with h0 and
dh_last), each kernel's device time by torch.profiler, each gradient's
largest error as a share of its largest element, and with ``--train``
the mamba2-370m warm train step (chip_smoke.py's ``TRAIN_SSM_ARGV``),
its peak allocated memory and its losses with each backward.

Each other build is NAME=DIR, DIR holding an ``ssd_bwd.cu``, the
``ssd.cuh`` it includes and the ``ssd.py`` whose `backward_plan` and
wrapper drive it, e.g. the parent commit's:

    mkdir -p build/parent_k5
    for f in csrc/ssd_bwd.cu csrc/ssd.cuh ssd.py; do
      git show HEAD~1:src/repro_torch/kernels/$f > build/parent_k5/${f#csrc/}
    done
    python3 tools/compare_k5_bwd.py parent=build/parent_k5 --train

Each build's library is compiled by nvcc with the port's flags, all at
once; its ``ssd.py`` is loaded as a module of ``repro_torch.kernels``
whose `_build` hands its `ssd_bwd` that library, so the build runs with
its own plan, workspaces and checks (the forward, whose `cum` and
`states` every build reads, is this tree's). Order: the builds as given,
this tree twice, the builds in reverse. Prints one JSON line (also
written to chiprun_out/compare_k5_bwd.json). Needs a CUDA card; imports
no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def bind(builds, _build):
    """{name: the ``ssd_bwd`` function of each build's ``ssd.py``, bound
    to the library nvcc built from its ``ssd_bwd.cu``}."""
    procs = {}
    for name, src_dir in builds.items():
        d = Path(src_dir)
        lib = d / f"lib{name}_ssd_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "ssd_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spec = importlib.util.spec_from_file_location(
            f"repro_torch.kernels._ssd_{name}", Path(builds[name]) / "ssd.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod   # dataclasses look their module up
        spec.loader.exec_module(mod)
        entry = ctypes.CDLL(str(lib)).ssd_bwd_f32
        entry.argtypes = list(mod._BWD_ARGTYPES)
        entry.restype = ctypes.c_int

        def check(kname, err, name=name):
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        mod._build = types.SimpleNamespace(
            entry=lambda *args, entry=entry: entry, check=check)
        fns[name] = mod.ssd_bwd
    return fns


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd as k5

    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+", help="NAME=DIR")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_k5_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tree = k5.ssd_bwd
    fns = bind(dict(spec.split("=", 1) for spec in args.builds), _build)
    order = list(fns) + ["tree", "tree"] + list(fns)[::-1]
    fns["tree"] = tree
    result = {"card": smi, "order": order, "shapes": {}}
    inputs = cs.k5_bwd_inputs(torch)
    for case, (name, chunk, x, dlogA, B, C, h0, dy, dhl) in zip(
            cs.K5_BWD_CASES, inputs):
        if name not in cs.K5_BWD_TIMED:
            continue
        _, _, cum, states = k5.ssd_with_work(x, dlogA, B, C, chunk=chunk,
                                             h0=h0)
        want = ref.ssd_bwd_ref(x, dlogA, B, C, chunk, h0, dy, dhl)
        shares, repeat = {}, {}
        for label, f in fns.items():
            got = f(x, dlogA, B, C, chunk, h0, dy, dhl, cum, states)
            shares[label] = max(
                ((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want) if w is not None)
            again = f(x, dlogA, B, C, chunk, h0, dy, dhl, cum, states)
            repeat[label] = all(a is None or torch.equal(a, b)
                                for a, b in zip(got, again))
        del want, got, again

        def call(label):
            return lambda: fns[label](x, dlogA, B, C, chunk, h0, dy, dhl,
                                      cum, states)
        times = [(label, cs.time_ms(call(label), torch)) for label in order]
        split = {label: cs.kernel_split_ms(
            call(label), torch,
            r"\bssd_bwd_(chunk|pass|main|state|dx|w|final)_kernel\b")
            for label in fns}
        nbytes, flops = cs.k5_bwd_work(x, B, chunk, h0, dhl, states)
        result["shapes"][name] = dict(
            shape=case[1:8], max_share=shares, same_bits=repeat, ms=times,
            kernel_ms=split, flops=flops, bytes=nbytes)
        print(name, json.dumps(result["shapes"][name]), flush=True)
    del inputs
    torch.cuda.empty_cache()
    if args.train:
        from repro_torch.launch import train

        steps = []
        try:
            for label in order:
                k5.ssd_bwd = fns[label]
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                run = train.main(cs.TRAIN_SSM_ARGV)
                torch.cuda.synchronize()
                steps.append(dict(build=label, warm_step_s=statistics.median(
                    run.step_seconds[2:]),
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    losses=run.losses))
                print(json.dumps(steps[-1]), flush=True)
                del run
        finally:
            k5.ssd_bwd = tree
        result["train"] = steps
    line = json.dumps(result)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "compare_k5_bwd.json").write_text(line)
    print(line)


if __name__ == "__main__":
    main()
