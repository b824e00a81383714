"""Seconds a step of the timed window: the window's host time, ending in a
synchronize, over all the rounds it completed."""


def read(run):
    return run.window_s / run.rounds if run.rounds else None
