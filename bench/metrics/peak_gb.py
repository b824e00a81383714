"""The device's peak allocated memory over the whole run (set-up
included), read when the window closes, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
