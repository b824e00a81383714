"""K1's share of its roofline (kernels.graph_mix): the least time of each
call of the traced window (the larger of its FLOPs over the peak and its
bytes over HBM's rate, at the call's shape: `bench.work.k1_work`), summed,
over the device time of the operations launched inside K1's entry, in %."""
from bench.work import k1_work, least_seconds

DTYPES = {4: "float32", 2: "bfloat16"}


def read(run):
    tr, calls = run.trace, run.calls.get("k1")
    if tr is None or not calls or not tr.layer_s.get("k1"):
        return None
    least = sum(least_seconds(*k1_work(c["M"], c["N"], c["P"],
                                       c["element_size"]),
                              DTYPES[c["element_size"]]) for c in calls)
    return 100.0 * least / tr.layer_s["k1"]
