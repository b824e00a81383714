"""Models a round that K7, the port's kernel for PaperCNN's convolution
stack, ran its inference forwards for: the program's count at the
kernel's launch (``k7.models``, `repro_torch.obs`) over its count of
rounds, both kept while the traced half ran under the profiler. At the
dense cell's size, the greedy's 40,000 probe models and the evaluation's
models; fewer than the probes means reward forwards that bypassed the
kernel. None where the program keeps no such counter."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans and counters
        return None
    counts = obs.snapshot()["counts"]
    if not counts.get("rounds") or "k7.models" not in counts:
        return None
    return counts["k7.models"] / counts["rounds"]
