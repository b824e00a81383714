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

Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
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
    ap.add_argument("--lm", action="store_true",
                    help="the LM example at chip_smoke.LM_DPFL_FULL (its "
                         "own rounds; --rounds and --variant unused)")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_dpfl: needs a CUDA card")

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
        "device": torch.cuda.get_device_name(0),
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
        # kernels whose names both hold "graph_mix"), and K4's forward
        # and backward kernels in the LM run
        "port_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                          "calls": n} for us, k, n in rows
                         if "graph_mix" in k or "flash_attention" in k],
    }))


if __name__ == "__main__":
    main()
