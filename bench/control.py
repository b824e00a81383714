"""Readings of the check under the control and under planted faults, at a
cell's own size, one seed after another in one process.

    python3 bench/control.py --workload <name> --seeds 1,2,3 \
        --mode tf32|half_batch [--seconds 2]

``tf32``: the control. The program runs as it stands, with TF32 switched
on for its float32 products after the engine is built (the engine turns
it off; TF32 is the nearest precision below the float32 the
configurations state, and the step a later change would be tempted to
take). ``half_batch``: the fault of a local train that leaves out half
of each minibatch and takes the mean over the rest. The benchmark's own
runs run neither. Prints one JSON line a seed: the readings of every
number the check compares, and ``correct``.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

# seeds run one after another in this process: the allocator's pool of
# one run must not fragment the next
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def tf32(engine):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def half_batch(engine):
    """Every local step's loss and gradients over the first half of the
    minibatch's rows."""
    inner = engine._loss_and_grads

    def halved(params, batch, loss_fn):
        half = {k: v[:, :max(1, v.shape[1] // 2)] for k, v in batch.items()}
        return inner(params, half, loss_fn)

    engine._loss_and_grads = halved


MODES = {"tf32": tf32, "half_batch": half_batch}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(cell, seed, args.seconds, False,
                                     time.perf_counter(),
                                     after_engine=MODES[args.mode])
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": result["correct"],
                          "readings": {k: v["value"] for k, v in
                                       result["checks"].items()}}),
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
