"""K4's backward of this tree against other builds of its source, in turns
on one card: the kernel time at chip_smoke.py's timed backward shapes
(`K4_BWD_TIMED`: the training shapes of qwen3-0.6b, recurrentgemma-9b,
internvl2-2b, qwen3-moe-30b-a3b and whisper-medium's encoder), each
kernel's device time by torch.profiler, whether each build gives this
tree's bits, and with ``--train`` the qwen3-0.6b warm train step
(chip_smoke.py's ``TRAIN_ARGV``) and its peak allocated memory with each
backward.

With ``--bf16`` the bf16 backward instead, at chip_smoke.py's
`K4_BWD_BF16_CASES` (qwen3-0.6b's, whisper-medium's encoder's and
recurrentgemma-9b's training shapes), against builds of the first bf16
design's source: ``flash_attention_bwd.cu`` built with ``-DFA_BWD_BF16``
(its C entry ``flash_attention_bwd_bf16`` takes the fp32 plan's tiles,
slabs and splits, with the fp32 partials always and an fp32 dQ scratch),
e.g. the commit before its redesign:

    mkdir -p build/parent_bf16
    for f in flash_attention_bwd.cu flash_attention.cuh; do
      git show 3c9a8ab:src/repro_torch/kernels/csrc/$f > build/parent_bf16/$f
    done
    python3 tools/compare_k4_bwd.py --bf16 parent=build/parent_bf16 --train

``--train --bf16`` times chip_smoke.py's ``TRAIN_BF16`` step (qwen3-0.6b
whole at bf16 through `launch.train.train`) and its peak with each
backward. ``--bf16`` also times K4's bf16 forward with its LSE (the
launch the train step makes twice a layer under remat "full") at the
first case's shape, beside its plain version, SDPA's forward and its
bound.

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


def bind(name, src_dir, smem, torch, k4, _build, bf16=False):
    """A backward function of the flash_attention_bwd signature that runs
    the library built from ``src_dir`` (with ``bf16``, built with
    -DFA_BWD_BF16: its bf16 entry)."""
    src = Path(src_dir) / "flash_attention_bwd.cu"
    lib_path = Path(src_dir) / f"lib{name}_bwd{'_bf16' if bf16 else ''}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                    *(["-DFA_BWD_BF16"] if bf16 else []), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True,
                   timeout=600)
    symbol = "flash_attention_bwd_bf16" if bf16 else "flash_attention_bwd_f32"
    text = src.read_text()
    if f'extern "C" int {symbol}(' not in text:
        sys.exit(f"compare_k4_bwd: {src} has no entry {symbol}")
    fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
    fn.restype = ctypes.c_int
    with_plan = "const int* plan" in text
    # the first bf16 design's source takes that path's dq32 scratch (null
    # in fp32); earlier and later ones have no such argument
    with_dq32 = "void* dq32" in text
    argtypes = [ctypes.c_void_p] * (12 + with_dq32) + list(k4._BWD_TAIL)
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
        keep = {}
        if with_plan:
            sms = k4._sm_count(q.device.index)
            # the fp32 plan: the first bf16 design shares its tiles, shared
            # memory, slabs and splits, with the partials always and an
            # fp32 dQ
            plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, sms)
            scratch, launch = dict(plan.scratch), list(plan.launch)
            if bf16:
                scratch["part"] = (2, plan.splits, B, Sk, Hkv, hd)
                scratch["dq"] = (B, Sq, Hq, hd)
                n4 = max(B * Sk * Hkv, B * Sq * Hq) * hd // 4
                launch[6] = max(1, min(-(-n4 // k4.BWD_THREADS), 8 * sms))
            keep = {n: torch.empty(shape, dtype=torch.float32,
                                   device=q.device)
                    for n, shape in scratch.items()}
            args += [keep[n].data_ptr() if n in keep else None
                     for n in ("ds", "part", "dq")[:2 + with_dq32]]
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


def time_forward(torch, cs, k4, ref):
    """K4's bf16 forward with its LSE at K4_BWD_BF16_CASES[0]'s shape: the
    kernel, its plain version, SDPA's forward (``is_causal``,
    ``enable_gqa`` on (B, H, S, hd) views) and the bound at the bf16 rate
    (q, k, v read, out and the fp32 LSE written; `flash_attention.work`'s
    flops)."""
    import torch.nn.functional as F

    name, B, Sq, Sk, Hq, Hkv, hd, causal, window = cs.K4_BWD_BF16_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = ((torch.randn(s, generator=gen, device="cuda") * c).bfloat16()
               for s, c in (((B, Sq, Hq, hd), 0.5), ((B, Sk, Hkv, hd), 0.5),
                            ((B, Sk, Hkv, hd), 1.0)))
    kw = dict(causal=causal, window=window)
    ms = cs.time_ms(lambda: k4.flash_attention_with_lse(q, k, v, **kw),
                    torch)
    plain_ms = cs.time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                          torch)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), torch)
    nbytes, flops = k4.work(B, Sq, Sk, Hq, Hkv, hd, causal, window, 2)
    nbytes += 4 * B * Hq * Sq
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    bound_ms, bound_by = cs._bound(rates, nbytes, flops, "bfloat16")
    return dict(case=name, shape=(B, Sq, Sk, Hq, Hkv, hd, causal, window),
                ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as k4

    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+", help="NAME=DIR[:hd=bytes,...]")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 backward (K4_BWD_BF16_CASES, TRAIN_BF16)")
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
        fns[name] = bind(name, src_dir, smem, torch, k4, _build, args.bf16)
    order = list(fns) + ["tree", "tree"] + list(fns)[::-1]
    fns["tree"] = tree
    result = {"card": smi, "order": order, "bf16": args.bf16, "shapes": {}}
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cases = cs.K4_BWD_BF16_CASES if args.bf16 else [
        c for c in cs.K4_BWD_CASES if c[0] in cs.K4_BWD_TIMED]
    for case in cases:
        name, B, Sq, Sk, Hq, Hkv, hd, causal, window = case
        q = (torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda") *
             0.5).to(dtype)
        k = (torch.randn((B, Sk, Hkv, hd), generator=gen,
                         device="cuda") * 0.5).to(dtype)
        v = torch.randn((B, Sk, Hkv, hd), generator=gen,
                        device="cuda").to(dtype)
        dout = torch.randn((B, Sq, Hq, hd), generator=gen,
                           device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        got = {label: f(q, k, v, out, lse, dout, **kw)
               for label, f in fns.items()}
        shares = {label: max(((g.float() - w.float()).abs().max() /
                              w.float().abs().max()).item()
                             for g, w in zip(grads, want))
                  for label, grads in got.items()}
        same = {label: all(torch.equal(a, b) for a, b in
                           zip(grads, got["tree"]))
                for label, grads in got.items()}
        del want, got
        times = [(label, cs.time_ms(lambda: fns[label](
            q, k, v, out, lse, dout, **kw), torch)) for label in order]
        split = {label: cs.kernel_split_ms(lambda: f(
            q, k, v, out, lse, dout, **kw), torch,
            r"\bflash_attention_bwd_(delta|dkdv|dq|reduce|finish)_kernel\b")
            for label, f in fns.items()}
        result["shapes"][name] = dict(shape=case[1:], max_share=shares,
                                      same_bits_as_tree=same, ms=times,
                                      kernel_ms=split)
        print(name, json.dumps(result["shapes"][name]), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    if args.bf16:
        result["forward"] = time_forward(torch, cs, k4, ref)
        print("forward", json.dumps(result["forward"]), flush=True)
    if args.train:
        from repro_torch import prng
        from repro_torch.configs import get_config
        from repro_torch.launch import train
        from repro_torch.models import build_model

        def bf16_run():
            cut = cs.TRAIN_BF16
            cfg = get_config(cut["arch"]).replace(
                dtype=cut["dtype"], n_layers=cut["n_layers"])
            model = build_model(cfg, device="meta", loss_chunks=4)
            model.init(prng.PRNGKey(0, device="cuda"))
            return train.train(model, train.lm_corpus(cfg, cut["batch"],
                                                      cut["seq"]),
                               steps=cut["steps"], batch=cut["batch"],
                               lr=cut["lr"])

        steps = []
        try:
            for label in order:
                k4.flash_attention_bwd = fns[label]
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                run = bf16_run() if args.bf16 else train.main(cs.TRAIN_ARGV)
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
