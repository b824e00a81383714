"""Device milliseconds a round of the operations launched inside
the codec's encode, decode and error feedback (fl.compress.compress_exchange), from the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not run.rounds or "codec" not in tr.layer_s:
        return None
    return 1e3 * tr.layer_s["codec"] / run.rounds
