"""K5's share of its roofline (kernels.ssd, forward and backward): the
least time of the traced half's K5 calls at their shapes, summed, over
the device seconds of K5's kernels by name (``ssd_*_kernel`` in the
trace's operations), in %. The calls' (b, l) come from the program's
counters (``k5.seqs.l<l>``, ``k5_bwd.seqs.l<l>``: the sequences of the
calls at each length, `repro_torch.obs`; a call's work at one length is
linear in b, so one sum a length gives the calls' summed least time),
their heads, head size, state and chunk from the configuration; the
work is `bench.work_k5`'s. None where the program keeps no such
counters or the trace holds no K5 kernel."""
import re

from bench.work import least_seconds
from bench.work_k5 import k5_bwd_work, k5_work

KERNEL = re.compile(
    r"\bssd_(bwd_)?(chunk|pass|output|state|dx|w|final)_kernel\b")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans and counters
        return None
    counts = obs.snapshot()["counts"]
    m = run.cell.config
    H = m["mamba_expand"] * m["hidden_size"] // m["mamba_d_head"]
    shape = (H, m["mamba_d_head"], m["mamba_d_state"],
             m["mamba_chunk_size"])
    least = 0.0
    for name, work in (("k5", k5_work), ("k5_bwd", k5_bwd_work)):
        per_l = re.compile(rf"^{name}\.seqs\.l(\d+)$")
        for key, seqs in counts.items():
            hit = per_l.match(key)
            if hit:
                least += least_seconds(*work(seqs, int(hit.group(1)),
                                             *shape), "float32")
    device = sum(s for k, s in tr.by_name.items() if KERNEL.search(k))
    if not least or not device:
        return None
    return 100.0 * least / device
