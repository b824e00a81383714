"""Where the time of the port's serving path goes on the card.

Builds one of ``chip_smoke.py``'s serve models (``SERVE_ARCHS``:
qwen3-0.6b, the default, mamba2-370m, recurrentgemma-9b, internvl2-2b,
qwen3-moe-30b-a3b, on its first ``SERVE_LAYERS`` layers, or
whisper-medium) at its published config in float32 and serves it as
``chip_smoke.py`` does (its ``SERVE_RUN``: batch 4, prompt 512, 32 new
tokens, greedy; the vlm's 256 vision embeddings from
``chip_smoke.make_vision`` before the prompt; whisper's 1,500 frames
from ``chip_smoke.make_frames`` and its prompt of ``SERVE_PROMPT``'s 224
tokens), runs `repro_torch.launch.serve.generate` once to
warm up, then profiles its two phases, `serve.prefill` and
`serve.decode`, apart under ``torch.profiler`` and prints one JSON line
per phase: the wall time (host clock, the card synchronised), the summed
device-kernel time and the device's idle share, the kernel launches (per
step in decode), the TOP kernels that take the most device time, and the
port's kernels of the family (K4 ``flash_attention``, K5 ``ssd``'s three
launches, K6 ``rglru_scan``), each by name, with their shares of the
phase's device time, and the device time split into the fp32 GEMMs
(cuBLAS kernels, "gemm" in the name), the port's kernels and the rest.
For whisper the decode line also holds the cross-attention's K/V
recompute (``enc_out @ wk`` and ``@ wv`` of every decoder layer, what
each step recomputes as `repro` does), timed alone by CUDA events.

With ``--personalized`` it profiles the personalized serve instead
(``examples/serve_personalized_torch.py`` at
``chip_smoke.PERSONALIZED_RUN``: the whole qwen3-0.6b, 3 clients'
weights, 4 requests of 512 tokens, 32 new), its prefill and decode
apart, after timing in turns, TURNS times each, the shared-weight
prefill of ``serve.prefill`` and the personalized one (the requests'
weights gathered beforehand) at the same batch and prompt: one more
JSON line of their walls and medians.

    python3 tools/profile_serve.py [--arch mamba2-370m|recurrentgemma-9b|
                                    internvl2-2b|qwen3-moe-30b-a3b|
                                    whisper-medium]
    python3 tools/profile_serve.py --personalized

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
sys.path.insert(0, str(ROOT / "examples"))

TOP = 8
TURNS = 5
GEMM = r"gemm"


def _phase(prof, wall, port_kernels):
    """One phase's record from its profile: device events only (kernels,
    memsets, copies); the CPU-side ops that launched them carry the same
    time again."""
    from torch.autograd import DeviceType

    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    port_s = sum(r[0] for r in rows if any(re.search(p, r[1])
                                           for p in port_kernels)) / 1e6
    gemm_s = sum(r[0] for r in rows if re.search(GEMM, r[1])) / 1e6
    return {"wall_s": wall, "device_kernel_s": device_s,
            "device_split_s": {"gemm": gemm_s, "port_kernels": port_s,
                               "other": device_s - gemm_s - port_s},
            "device_idle_share": 1.0 - device_s / wall,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                             "calls": n, "share_of_device": us / 1e6 / device_s}
                            for us, k, n in rows[:TOP]],
            "port_kernel": [{"name": k[:90], "device_ms": us / 1e3,
                             "calls": n, "share_of_device": us / 1e6 / device_s}
                            for us, k, n in rows
                            if any(re.search(p, k) for p in port_kernels)]}


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.launch import serve

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=chip_smoke.SERVE_ARCHS[0],
                    choices=chip_smoke.SERVE_ARCHS)
    ap.add_argument("--personalized", action="store_true")
    args = ap.parse_args(argv)
    arch = args.arch
    if not torch.cuda.is_available():
        sys.exit("profile_serve: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.personalized:
        return personalized(torch)

    cfg, model, params = chip_smoke.serve_model(torch, arch)
    # the device names of the family's kernels in csrc/: "<name>_kernel",
    # "<name>_f32_kernel" / "<name>_bf16_kernel" where a kernel has one
    # body per type (K4), or "<name>_<pass>_kernel" where an op is several
    # launches (K5: ssd_chunk_kernel, ssd_pass_kernel, ssd_output_kernel)
    port_kernels = [rf"\b{name}(_[a-z0-9]+)?_kernel\b" for name, n
                    in chip_smoke.serve_kernels(cfg).items() if n]
    B, new = chip_smoke.SERVE_RUN["batch"], chip_smoke.SERVE_RUN["new_tokens"]
    S = chip_smoke.SERVE_PROMPT.get(arch, chip_smoke.SERVE_RUN["prompt_len"])
    prompts = serve.make_prompts(cfg.vocab_size, B, S, 0, "cuda")
    vision = chip_smoke.make_vision(torch, cfg, B)
    frames = chip_smoke.make_frames(torch, cfg, B)
    Nv = serve.vision_positions(model, vision)
    serve.generate(model, params, prompts, new, vision=vision,
                   frames=frames)   # warm-up
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, tok, caches = serve.prefill(model, prompts, new, vision, frames)
        torch.cuda.synchronize()
        prefill_wall = time.perf_counter() - t0
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        serve.decode(model, caches, tok, Nv + S, new - 1)
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    common = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "arch": arch, "n_layers": cfg.n_layers, "batch": B,
              "prompt_len": S, "vision_positions": Nv}
    print(json.dumps({**common, "phase": "prefill",
                      "prompt_tok_per_s": B * S / prefill_wall,
                      **_phase(prof, prefill_wall, port_kernels)}))
    decode = _phase(prof_d, decode_wall, port_kernels)
    if cfg.family == "audio":
        decode["cross_kv_recompute_ms_per_step"] = cross_kv_ms(
            torch, model, caches[0])
    print(json.dumps({**common, "phase": "decode", "steps": new - 1,
                      "ms_per_step": decode_wall / (new - 1) * 1e3,
                      "tok_per_s": (new - 1) * B / decode_wall,
                      "launches_per_step": decode["kernel_launches"]
                      / (new - 1), **decode}))


def cross_kv_ms(torch, model, enc_out, reps: int = 10):
    """Device time (CUDA events, mean of ``reps``) of what a whisper
    decode step recomputes beside its token's work: the cross-attention's
    K and V, ``enc_out @ wk`` and ``enc_out @ wv`` of every decoder
    layer."""
    def once():
        for layer in model.dec_layers:
            enc_out @ layer.cross_attn.wk
            enc_out @ layer.cross_attn.wv
    with torch.inference_mode():
        once()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            once()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def personalized(torch):
    """The personalized serve's prefill walls against the shared-weight
    prefill, in turns, then its two phases under the profiler."""
    import statistics

    import serve_personalized_torch as ex
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    c = chip_smoke.PERSONALIZED_RUN
    cfg = get_config(c["arch"]).replace(dtype="float32")
    model = build_model(cfg, device="meta", remat="none")
    stacked = ex.stacked_init(model, ex.CLIENTS, "cuda")
    ids = torch.tensor([r for r, _ in ex.REQUESTS], device="cuda")
    B, S, new = len(ex.REQUESTS), c["prompt_len"], c["new_tokens"]
    prompts = serve.make_prompts(cfg.vocab_size, B, S, c["seed"], "cuda")
    params = {k: v[ids] for k, v in stacked.items()}
    shared = build_model(cfg, device="meta")
    shared.load_state_dict({k: v[0] for k, v in stacked.items()},
                           assign=True)
    ex.serve_personalized(model, stacked, ids, prompts, new)   # warm-up
    serve.prefill(shared, prompts, new)
    walls = {"shared_prefill_ms": [], "personalized_prefill_ms": []}
    for _ in range(TURNS):
        for name, fn in (
                ("shared_prefill_ms",
                 lambda: serve.prefill(shared, prompts, new)),
                ("personalized_prefill_ms",
                 lambda: ex.personalized_prefill(model, params, prompts,
                                                 new))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    port_kernels = [r"\bflash_attention(_[a-z0-9]+)?_kernel\b"]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, tok, caches = ex.personalized_prefill(model, params, prompts,
                                                 new)
        torch.cuda.synchronize()
        prefill_wall = time.perf_counter() - t0
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        ex.personalized_decode(model, params, caches, tok, S, new - 1)
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    common = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "arch": f"{c['arch']} personalized, {ex.CLIENTS} clients",
              "batch": B, "prompt_len": S}
    print(json.dumps({**common, "phase": "prefill walls in turns",
                      **walls, **{f"median_{k}": statistics.median(v)
                                  for k, v in walls.items()}}))
    print(json.dumps({**common, "phase": "prefill",
                      **_phase(prof, prefill_wall, port_kernels)}))
    decode = _phase(prof_d, decode_wall, port_kernels)
    print(json.dumps({**common, "phase": "decode", "steps": new - 1,
                      "ms_per_step": decode_wall / (new - 1) * 1e3,
                      "launches_per_step": decode["kernel_launches"]
                      / (new - 1), **decode}))


if __name__ == "__main__":
    main()
