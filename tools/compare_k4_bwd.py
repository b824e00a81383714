"""K4's backward of this tree against other builds of its source, in turns
on one card: the kernel time at chip_smoke.py's timed backward shapes
(`K4_BWD_TIMED`: qwen3-0.6b's and recurrentgemma-9b's training shapes),
each kernel's device time by torch.profiler, and with ``--train`` the
qwen3-0.6b warm train step (chip_smoke.py's ``TRAIN_ARGV``) and its peak
allocated memory with each backward.

Each other build is NAME=DIR, DIR holding a ``flash_attention_bwd.cu`` and
the ``flash_attention.cuh`` it includes, e.g. the parent commit's:

    mkdir -p build/parent_bwd
    for f in flash_attention_bwd.cu flash_attention.cuh; do
      git show HEAD~1:src/repro_torch/kernels/csrc/$f > build/parent_bwd/$f
    done
    python3 tools/compare_k4_bwd.py parent=build/parent_bwd --train

A source whose C entry takes no launch plan (the first design's, PR 22)
is called with its own arguments; one that takes the plan gets this
tree's `flash_attention.backward_plan`, with (b)'s shared bytes from
``hd=bytes`` pairs after a colon where its tiles differ from this tree's
(NAME=DIR:128=187392,256=218112). Order: the builds as given, this tree
twice, the builds in reverse. Prints one JSON line (also written to
chiprun_out/compare_k4_bwd.json). Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def bind(name, src_dir, smem, torch, k4, _build):
    """A backward function of the flash_attention_bwd signature that runs
    the library built from ``src_dir``."""
    src = Path(src_dir) / "flash_attention_bwd.cu"
    lib_path = Path(src_dir) / f"lib{name}_bwd.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib_path)).flash_attention_bwd_f32
    fn.restype = ctypes.c_int
    text = src.read_text()
    with_plan = "const int* plan" in text
    # the entry takes the bf16 path's dq32 scratch since PR 33 (null in
    # fp32); an earlier source has no such argument
    with_dq32 = "void* dq32" in text
    argtypes = list(k4._BWD_ARGTYPES)
    if not with_dq32:
        del argtypes[12]
    fn.argtypes = argtypes if with_plan else (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p])

    def bwd(q, k, v, out, lse, dout, *, causal=True, window=None):
        B, Sq, Hq, hd = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        dout = dout.contiguous()
        dq = torch.empty_like(dout)
        dk = torch.empty((B, Sk, Hkv, hd), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32,
                            device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
        keep = []
        if with_plan:
            plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd,
                                    k4._sm_count(q.device.index))
            keep = [torch.empty(shape, dtype=torch.float32, device=q.device)
                    for shape in plan.scratch.values()]
            args += [keep[0].data_ptr(),
                     keep[1].data_ptr() if len(keep) > 1 else None]
            if with_dq32:
                args.append(None)
            launch = list(plan.launch)
            launch[4] = smem.get(hd, launch[4])
            launch = (ctypes.c_int * len(launch))(*launch)
        strides = k4._strides(q, k, v)
        args += [B, Sq, Sk, Hq, Hkv, hd, ctypes.addressof(strides),
                 int(causal), 0 if window is None else int(window),
                 1.0 / math.sqrt(hd)]
        if with_plan:
            args.append(ctypes.addressof(launch))
        err = fn(*args, q.device.index,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return dq, dk, dv
    return bwd


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as k4

    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+", help="NAME=DIR[:hd=bytes,...]")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_k4_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tree = k4.flash_attention_bwd
    fns = {}
    for spec in args.builds:
        name, rest = spec.split("=", 1)
        src_dir, _, pairs = rest.partition(":")
        smem = {int(h): int(b) for h, b in
                (p.split("=") for p in pairs.split(",") if p)}
        fns[name] = bind(name, src_dir, smem, torch, k4, _build)
    order = list(fns) + ["tree", "tree"] + list(fns)[::-1]
    fns["tree"] = tree
    result = {"card": smi, "order": order, "shapes": {}}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for case in cs.K4_BWD_CASES:
        name, B, Sq, Sk, Hq, Hkv, hd, causal, window = case
        if name not in cs.K4_BWD_TIMED:
            continue
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda") * 0.5
        k = torch.randn((B, Sk, Hkv, hd), generator=gen,
                        device="cuda") * 0.5
        v = torch.randn((B, Sk, Hkv, hd), generator=gen, device="cuda")
        dout = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda")
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        shares = {}
        for label, f in fns.items():
            got = f(q, k, v, out, lse, dout, **kw)
            shares[label] = max(((g - w).abs().max() / w.abs().max()).item()
                                for g, w in zip(got, want))
        del want, got
        times = [(label, cs.time_ms(lambda: fns[label](
            q, k, v, out, lse, dout, **kw), torch)) for label in order]
        split = {label: cs.kernel_split_ms(lambda: f(
            q, k, v, out, lse, dout, **kw), torch,
            r"\bflash_attention_bwd_(delta|dkdv|dq|reduce)_kernel\b")
            for label, f in fns.items()}
        result["shapes"][name] = dict(shape=case[1:], max_share=shares,
                                      ms=times, kernel_ms=split)
        print(name, json.dumps(result["shapes"][name]), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    if args.train:
        from repro_torch.launch import train

        steps = []
        try:
            for label in order:
                k4.flash_attention_bwd = fns[label]
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                run = train.main(cs.TRAIN_ARGV)
                torch.cuda.synchronize()
                steps.append(dict(build=label, warm_step_s=statistics.median(
                    run.step_seconds[2:]),
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    losses=run.losses))
                del run
        finally:
            k4.flash_attention_bwd = tree
        result["train"] = steps
    line = json.dumps(result)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "compare_k4_bwd.json").write_text(line)
    print(line)


if __name__ == "__main__":
    main()
