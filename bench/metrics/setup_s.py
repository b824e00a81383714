"""Seconds from the process's start to the window's: the kernels' build or
load, the inputs, the engine, the preprocessing (tau_init epochs and
BGGC) and the warm rounds."""


def read(run):
    return run.setup_s
