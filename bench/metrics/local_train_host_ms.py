"""Host milliseconds a round inside the program's ``local_train`` span
(`repro_torch.obs`: the round step's call of its local-train hook),
over its count of rounds, both kept while the traced half ran under the
profiler. Beside `local_train_ms`, the device's time for the same work,
it reads how far the host's dispatch paces the local train. None where
the program keeps no such span."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans and counters
        return None
    snap = obs.snapshot()
    rounds = snap["counts"].get("rounds")
    spans = [r for r in snap["records"] if r.name == "local_train"]
    if not rounds or not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / rounds
