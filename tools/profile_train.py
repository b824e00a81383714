"""Where the time of the port's training step goes on the card.

Builds an arch at chip_smoke.py's train run's config in float32, or in
bf16 with ``--dtype bfloat16`` (qwen3-0.6b's then is chip_smoke.py's
``TRAIN_BF16``: the whole config at bf16, `repro`'s default dtype, with
AdamW's moments in fp32, as `launch.train.train` runs it)
(``--arch qwen3-0.6b``, the default: ``TRAIN_ARGV``, batch 8, sequence
512; ``--arch mamba2-370m``: ``TRAIN_SSM_ARGV``, the same batch and
sequence; ``--arch internvl2-2b``: ``TRAIN_VLM``, whole, the same batch
and sequence behind chip_smoke's 256 seeded vision embeddings
(``make_vision``); ``--arch recurrentgemma-9b``: ``TRAIN_HYBRID``, full
width cut to its first ``--layers`` layers, 6 by default, batch 4,
sequence 512;
``--arch qwen3-moe-30b-a3b``: ``TRAIN_MOE``, full width cut to its first
2 layers (``--layers`` sets it), batch 4, sequence 512; ``--arch
whisper-medium``: ``TRAIN_AUDIO``, whole (``--layers`` cuts its encoder
and decoder alike), batch 8, sequence 448 after chip_smoke's 1,500
seeded frames (``make_frames``)),
runs two warm-up steps of `repro_torch.launch.train`'s step
(`make_train_step` under AdamW and ``warmup_cosine``), then profiles one
step phase by phase (the loss's forward, the backward pass with its
recompute, AdamW and the update of the weights), each phase under a
``torch.profiler`` of its own and ending in a synchronize, and prints
one JSON line: the step's wall time (the phases' host walls summed, the
card synchronised after each), each phase's host wall and device-kernel
time (the sum of its kernels', copies' and memsets' device times: a
host-bound phase's range on the device would count its idle gaps too),
the summed device-kernel time and the device's idle share, the kernel
launches, the TOP kernels that take the most device time, and the
port's kernels (K4's forward ``flash_attention_f32_kernel`` or
``flash_attention_bf16_kernel`` and its backward's
``flash_attention_bwd_*_kernel``; K5's ``ssd_*_kernel`` and its
backward's ``ssd_bwd_*_kernel``; K6's ``rglru_scan_kernel`` and
``rglru_scan_bwd_kernel``), each by name, and the device time split into
the GEMMs (cuBLAS kernels: "gemm" in the name, or "nvjet", its Hopper
kernels of bf16 products), the port's kernels and the rest.

    python3 tools/profile_train.py [--arch ARCH] [--layers N]
                                   [--dtype bfloat16]

Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TOP = 10
PHASES = ("forward", "backward", "optimizer")
PORT_KERNELS = (r"\bflash_attention_(f32|bf16)_kernel\b",
                r"\bflash_attention_bwd_[a-z]+_kernel\b",
                r"\bssd_(bwd_)?[a-z]+_kernel\b",
                r"\brglru_scan_(bwd_)?kernel\b")


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine

    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    cuts = {"recurrentgemma-9b": chip_smoke.TRAIN_HYBRID,
            "internvl2-2b": chip_smoke.TRAIN_VLM,
            "qwen3-moe-30b-a3b": chip_smoke.TRAIN_MOE,
            "whisper-medium": chip_smoke.TRAIN_AUDIO}
    argvs = {"qwen3-0.6b": chip_smoke.TRAIN_ARGV,
             "mamba2-370m": chip_smoke.TRAIN_SSM_ARGV}
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=tuple(argvs) + tuple(cuts))
    ap.add_argument("--layers", type=int, default=None,
                    help="the cut of recurrentgemma-9b, internvl2-2b, "
                         "qwen3-moe-30b-a3b or whisper-medium (its first N "
                         "layers, whisper's N encoder and N decoder "
                         "layers; default chip_smoke's)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the weights' and activations' dtype (bfloat16: "
                         "qwen3-0.6b at chip_smoke's TRAIN_BF16)")
    args = ap.parse_args()
    if args.dtype == "bfloat16":
        cuts["qwen3-0.6b"] = chip_smoke.TRAIN_BF16
    if args.arch in cuts:
        cut = cuts[args.arch]
        cfg = get_config(args.arch).replace(
            n_layers=args.layers or cut["n_layers"], dtype=args.dtype)
        if cfg.family == "audio" and args.layers:
            cfg = cfg.replace(n_enc_layers=args.layers)
        B, S, steps = cut["batch"], cut["seq"], cut["steps"]
    else:
        argv = argvs[args.arch]

        def flag(name):
            return argv[argv.index(name) + 1]
        cfg = get_config(flag("--arch")).replace(dtype=args.dtype)
        B, S, steps = int(flag("--batch")), int(flag("--seq")), int(
            flag("--steps"))
    model = build_model(cfg, device="meta", loss_chunks=4)
    model.init(prng.PRNGKey(0, device="cuda"))
    corpus = torch.from_numpy(train.lm_corpus(cfg, B, S)).cuda()
    rows = train.batch_rows(corpus.shape[0], B, 3)
    params = dict(model.named_parameters())
    optimizer = adamw(warmup_cosine(3e-4, 10, steps))
    state = optimizer.init(params)
    walls, kernels_by_phase = {}, {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def step(idx, profiled=False):
        batch = {"tokens": corpus[torch.from_numpy(idx).cuda()]}
        if vision is not None:
            batch["vision"] = vision
        if frames is not None:
            batch["frames"] = frames

        def phase(name, fn):
            if not profiled:
                return fn()
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
            # device events: kernels, memsets and copies, by name
            kernels_by_phase[name] = {
                ev.key: (ev.self_device_time_total, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0}
            return out
        loss, _ = phase("forward", lambda: model.loss(batch))
        grads = phase("backward", lambda: torch.autograd.grad(
            loss, list(params.values())))

        def update():
            nonlocal state
            updates, state = optimizer.update(dict(zip(params, grads)),
                                              state, params)
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(updates[k].to(p.dtype))
        phase("optimizer", update)
        return loss

    vision = chip_smoke.make_vision(torch, cfg, B)
    frames = chip_smoke.make_frames(torch, cfg, B)
    batch_vision = 0 if vision is None else vision.shape[1]
    for idx in rows[:2]:
        step(idx)
    torch.cuda.synchronize()
    step(rows[2], profiled=True)
    wall = sum(walls.values())

    merged = {}
    for by_name in kernels_by_phase.values():
        for key, (us, n) in by_name.items():
            t, c = merged.get(key, (0, 0))
            merged[key] = (t + us, c + n)
    kernels = sorted(((us, key, n) for key, (us, n) in merged.items()),
                     reverse=True)
    device_s = sum(r[0] for r in kernels) / 1e6
    ranges = {p: sum(us for us, _ in kernels_by_phase[p].values()) / 1e6
              for p in PHASES}
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    port_s = sum(r[0] for r in kernels if any(
        re.search(p, r[1]) for p in PORT_KERNELS)) / 1e6
    gemm_s = sum(r[0] for r in kernels
                 if re.search(r"gemm|nvjet", r[1])) / 1e6

    def rec(us, k, n):
        return {"name": k[:90], "device_ms": us / 1e3, "calls": n,
                "share_of_device": us / 1e6 / device_s}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "batch": B, "seq": S,
        "vision_positions": batch_vision,
        "frames": 0 if frames is None else frames.shape[1],
        "remat": model.remat,
        "step_wall_s": wall,
        "phases": {p: {"wall_s": walls[p], "device_kernel_s": ranges.get(p)}
                   for p in PHASES},
        "port_kernel_s": port_s,
        "device_kernel_s": device_s,
        "device_split_s": {"gemm": gemm_s, "port_kernels": port_s,
                           "other": device_s - gemm_s - port_s},
        "device_idle_share": 1.0 - device_s / wall,
        "kernel_launches": sum(r[2] for r in kernels),
        "top_kernels": [rec(*r) for r in kernels[:TOP]],
        "port_kernel": [rec(*r) for r in kernels
                        if any(re.search(p, r[1]) for p in PORT_KERNELS)],
        "peak_allocated_bytes": torch.cuda.max_memory_allocated()}))


if __name__ == "__main__":
    main()
