"""Kernel launches in the traced window's device trace over its rounds."""


def read(run):
    tr = run.trace
    if tr is None or not run.rounds or not tr.kernels:
        return None
    return tr.kernels / run.rounds
