"""Probe models the GGC refresh's reward forwards evaluate a round: the
program's count at its reward call (``ggc.probe_models``,
`repro_torch.obs`) over its count of rounds, both kept while the traced
half ran under the profiler. None where the program keeps neither."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans and counters
        return None
    counts = obs.snapshot()["counts"]
    if not counts.get("rounds") or "ggc.probe_models" not in counts:
        return None
    return counts["ggc.probe_models"] / counts["rounds"]
