"""K2's share of its roofline (kernels.sparse_graph_mix): the least time of
each call of the traced window at its shape and lists (valid slots, and
the distinct peer rows a separate peer table gives: `bench.work.k2_work`),
summed, over the device time of the operations launched inside K2's
entry, in %."""
from bench.work import k2_work, least_seconds

DTYPES = {4: "float32", 2: "bfloat16"}


def read(run):
    tr, calls = run.trace, run.calls.get("k2")
    if tr is None or not calls or not tr.layer_s.get("k2"):
        return None
    least = 0.0
    for c in calls:
        idx = c["idx"].cpu()
        valid = idx[idx >= 0]
        rows = int(valid.unique().numel()) if c["separate"] else 0
        least += least_seconds(*k2_work(c["N"], c["B"], c["P"],
                                        c["element_size"], int(valid.numel()),
                                        rows), DTYPES[c["element_size"]])
    return 100.0 * least / tr.layer_s["k2"]
