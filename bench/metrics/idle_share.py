"""The share of the traced window in which no operation ran on the device:
one minus the union of the device operations' intervals over the
window's host time, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
