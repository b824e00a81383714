"""The seqshard decode of chip_smoke.py's qwen3-0.6b model-mesh runs
("qwen3 1x2" and "qwen3 2x2" of `MODEL_MESH_RUNS`) for one checkout:
its kernels built, then each run one `run_on_mesh` launch of that
checkout's `chip_smoke.model_mesh_rank`, printed as one JSON line a run
(each rank's prefill ms, decode ms a step, and the decode steps'
collective ms a step). Compare two commits in one call, in turns:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change   # likewise
    for side in parent change change parent; do
      python3 tools/compare_mesh_decode.py build/$side $side
    done

Needs a CUDA card; imports no JAX.
"""
import json
import sys
import time


def main(tree, label):
    sys.path[:0] = [tree + "/src", tree]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_on_mesh

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    for run in ("qwen3 1x2", "qwen3 2x2"):
        D, M = cs.MODEL_MESH_RUNS[run][2]
        t0 = time.perf_counter()
        out = run_on_mesh(cs.model_mesh_rank, (D, M), ("data", "model"),
                          device="cuda:0", args=(run,))
        st = out["stats"]
        nk, nops = len(out["names"]), len(out["ops"])
        at = 7 + nk + 3 * nops
        print(json.dumps({
            "tree": label, "run": run, "build_s": build_s,
            "launch_s": time.perf_counter() - t0,
            "prefill_ms": (st[:, 1] * 1e3).tolist(),
            "decode_ms_step": (st[:, 2] / st[:, 5] * 1e3).tolist(),
            "decode_coll_ms_step": (st[:, at + 1] / st[:, 5]
                                    * 1e3).tolist()}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
