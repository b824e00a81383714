"""K4's share of its roofline (kernels.flash_attention, forward and
backward): the least time of each forward and backward call of the traced
window at its shape (`bench.work.k4_work`, `k4_bwd_work`), summed, over
the device time of the operations launched inside K4's two entries, in %."""
from bench.work import k4_bwd_work, k4_work, least_seconds

DTYPES = {4: "float32", 2: "bfloat16"}


def read(run):
    tr = run.trace
    fwd, bwd = run.calls.get("k4") or [], run.calls.get("k4_bwd") or []
    if tr is None or not (fwd or bwd) or not tr.layer_s.get("k4"):
        return None
    least = 0.0
    for calls, work in ((fwd, k4_work), (bwd, k4_bwd_work)):
        for c in calls:
            least += least_seconds(*work(
                c["B"], c["Sq"], c["Sk"], c["Hq"], c["Hkv"], c["hd"],
                c["causal"], c["window"], c["element_size"]),
                DTYPES[c["element_size"]])
    return 100.0 * least / tr.layer_s["k4"]
