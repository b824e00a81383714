"""Run one (arch x shape) of the dry run on both production meshes and
print its roofline terms and per-rank peak: a thin, readable wrapper over
repro_torch.launch.dryrun (which the full 80-combo sweep also uses), the
port's counterpart of examples/multipod_dryrun.py. Nothing is launched:
one rank's step runs on "meta" tensors, its times modelled from the
card's data-sheet rates.

  python examples/multipod_dryrun_torch.py --arch qwen3-0.6b --shape train_4k
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.dryrun import run_one  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    records = []
    for multi in (False, True):
        rec = run_one(args.arch, args.shape, multi, out_dir=None)
        rl = rec.get("roofline", {})
        mem = rec.get("memory", {})
        print(f"\n== {args.arch} x {args.shape} x "
              f"{'2x16x16 (pod,data,model)' if multi else '16x16 (data,model)'}")
        print(f"   status={rec['status']}  dominant={rl.get('dominant')}  "
              f"compute={rl.get('compute_s', 0):.4f}s "
              f"memory={rl.get('memory_s', 0):.4f}s "
              f"collective={rl.get('collective_s', 0):.4f}s  "
              f"peak={mem.get('peak_bytes', 0) / 1e9:.2f} GB a rank "
              f"(fits {mem.get('fits')})")
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
