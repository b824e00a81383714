"""A round's host time under the profiler over its time without it, in
one traced run (the window's second half against its first). The
profiler's cost is a cost a host operation, so the ratio reads how far
the host's dispatch paces the round: near 1 where the device does, and
the per-layer readings of the traced half are slowed by as much."""


def read(run):
    if not (run.rounds and run.window_s and run.untraced_rounds
            and run.untraced_s):
        return None
    return (run.window_s / run.rounds) / (run.untraced_s
                                          / run.untraced_rounds)
