"""The reference of the "weighted" mix rule (Eq. 4), in float64: each
client's own trained row with weight p_k and its selected peers'
received rows with weights p_i, the weights normalized."""
import torch

from ..reference import peers


def mix(trained, recv, graph, p, sparse: bool, rows: slice, **_):
    """The mixed rows ``rows`` of the panel: ``trained`` (N, P) the local
    train's output, ``recv`` (N, P) the table peers receive, ``graph``
    the round's selection ((N, N) bool or (N, B) lists), ``p`` (N,)."""
    out = []
    for k in range(rows.start, rows.stop):
        js = sorted(peers(graph, sparse, k))
        w = torch.cat([p[k:k + 1], p[js]])
        w = w / w.sum()
        out.append(w[0] * trained[k] + (w[1:, None] * recv[js]).sum(0))
    return torch.stack(out)
