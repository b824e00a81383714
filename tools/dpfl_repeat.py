"""Does a DPFL run on the card give the same bits when it runs again?

Runs chip_smoke.py's random-graph dense run (`run_dpfl` on PaperCNN at
its published width, 32 clients, 3 rounds; ``chip_smoke.shard_config(
"dense-random")``: no greedy decision, so two runs can differ only by
floating point) on one card: twice with cuDNN's deterministic
algorithms off and twice with them on (`FLEngine` turns them on; this
tool turns them off again for the first pair), each time with all 32
clients in one forward and backward and with 16 at a time
(``FLEngine._client_chunk = 16``, the hook of the bitwise twins), then
on a (1, 2) client mesh whose ranks hold 16 clients each (`repro_torch.launch.mesh`). Prints, for
each pair it compares, the largest absolute difference of best_flat,
of the test accuracies and of the validation-accuracy history, and the
card's name and power limit.

    python3 tools/dpfl_repeat.py

Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(engine, chunk=None):
    from repro_torch.core.dpfl import run_dpfl

    engine._client_chunk = chunk
    return run_dpfl(engine, chip_smoke.shard_config("dense-random"))


def _sharded(mesh, device, deterministic):
    import torch

    engine = chip_smoke.make_engine().shard_clients(mesh)
    torch.backends.cudnn.deterministic = deterministic
    return [_run(engine) for _ in range(2)]


def _diff(a, b):
    import numpy as np

    return {k: float(np.abs(np.asarray(getattr(a, k))
                            - np.asarray(getattr(b, k))).max())
            for k in ("best_flat", "test_acc", "val_acc_history")}


def main():
    import torch

    from repro_torch.launch.mesh import run_on_client_mesh

    if not torch.cuda.is_available():
        sys.exit("dpfl_repeat.py needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for deterministic in (False, True):
        engine = chip_smoke.make_engine()
        torch.backends.cudnn.deterministic = deterministic
        plain = [_run(engine) for _ in range(2)]
        chunked = [_run(engine, 16) for _ in range(2)]
        sharded = run_on_client_mesh(_sharded, 2, device="cuda:0",
                                     args=(deterministic,))
        pairs = {"plain, repeated": (plain[0], plain[1]),
                 "client_chunk 16, repeated": (chunked[0], chunked[1]),
                 "(1, 2) mesh, repeated": (sharded[0], sharded[1]),
                 "client_chunk 16 against plain": (chunked[0], plain[0]),
                 "(1, 2) mesh against client_chunk 16": (sharded[0],
                                                         chunked[0]),
                 "(1, 2) mesh against plain": (sharded[0], plain[0])}
        for name, (a, b) in pairs.items():
            print(f"cudnn.deterministic={deterministic}: {name}: max abs "
                  f"diff {_diff(a, b)}; {smi}")


if __name__ == "__main__":
    main()
