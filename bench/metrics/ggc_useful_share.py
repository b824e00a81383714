"""The share of the GGC refresh's probe models that can change a
selection, in %: the probes of the decisions at a candidate of Omega
(the program's device tally ``ggc.candidate_probe_models``,
`repro_torch.obs`) over every probe model its reward forwards evaluate
(``ggc.probe_models``), both kept while the traced half ran under the
profiler. The rest are exact no-ops of the scan. None where the program
keeps neither."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans and counters
        return None
    snap = obs.snapshot()
    probes = snap["counts"].get("ggc.probe_models")
    useful = snap["tallies"].get("ggc.candidate_probe_models")
    if not probes or useful is None:
        return None
    return 100.0 * useful / probes
