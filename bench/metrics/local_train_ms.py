"""Device milliseconds a round of the operations launched inside
the local train (engine.local_train), from the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not run.rounds or "local_train" not in tr.layer_s:
        return None
    return 1e3 * tr.layer_s["local_train"] / run.rounds
