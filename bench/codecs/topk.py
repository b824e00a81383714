"""The reference of the "topk" codec with error feedback: each client
sends the ceil(frac P) largest magnitudes of its error-compensated row,
its peers rebuild the row from them, and the client keeps the rest as
its next residual."""
import math

import torch


def topk_exchange(flat, ef, frac: float, out_ef):
    """The top-k codec with error feedback, in the program's float32: the
    encoded row ``x = flat + ef``, its ceil(frac P) largest magnitudes
    kept, the residual ``x - dec``. Where magnitudes tie at the k-th
    largest, any of them make a top-k: the reference takes the program's
    choice among them, read from its residuals (a kept coordinate's
    residual is exactly 0). Returns (x, dec, residuals, the rows whose
    kept set is no top-k of x)."""
    x = flat + ef
    P = x.shape[1]
    k = max(1, min(P, int(math.ceil(frac * P))))
    mag = x.abs()
    top = torch.topk(mag, k, dim=1)
    kth = top.values[:, -1:]
    must, tied = mag > kth, mag == kth
    kept = (out_ef == 0) & (x != 0)
    bad = (must & ~kept).any(1) | (kept & ~(must | tied)).any(1) \
        | (kept.sum(1) > k)
    own = torch.zeros_like(kept).scatter_(1, top.indices, True)
    keep = torch.where(bad[:, None], own, must | (tied & kept))
    dec = torch.where(keep, x, torch.zeros_like(x))
    return x, dec, x - dec, bad


def exchange(trained, ef, comp: dict, out_ef):
    """(the (N, P) table the peers receive, the residuals' gap): the new
    residuals' gap to the reference's over the encoded row's norm, the
    worst client's, and 1 where a kept set is no top-k."""
    x, dec, new_ef, bad = topk_exchange(trained, ef, comp["topk_frac"],
                                        out_ef)
    gap = float(((out_ef - new_ef).norm(dim=1)
                 / x.norm(dim=1).clamp_min(1e-30)).max())
    if bad.any():
        gap = max(gap, 1.0)
    return dec, gap
