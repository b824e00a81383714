"""Where a step's flops and bytes go (the port's counterpart of
`repro.roofline.breakdown`, which walks XLA's HLO call tree by op_name
metadata): the call sites of `repro_torch.roofline.analysis.OpCounter`
and the kernels' shape-only calls, from one `StepCount`."""
from __future__ import annotations

from typing import List, Tuple


def breakdown(count, top: int = 10
              ) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
    """(bytes rows, flops rows): the ``top`` call sites carrying the most
    HBM bytes and the most flops of ``count`` (a `StepCount`), each a list
    of (site, value): an aten op's site (`analysis.call_site`: the
    function of the port that called it, or the backward node running
    it), or "kernel:<name>" for a kernel's work."""
    rows = {site: list(v) for site, v in count.by_site.items()}
    for c in count.kernels:
        row = rows.setdefault(f"kernel:{c.name}", [0, 0])
        row[0] += c.nbytes
        row[1] += c.flops

    def top_of(i):
        ranked = sorted(((s, v[i]) for s, v in rows.items() if v[i]),
                        key=lambda r: (-r[1], r[0]))
        return ranked[:top]
    return top_of(0), top_of(1)
