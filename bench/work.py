"""The yardstick's arithmetic, frozen: the H100's data-sheet peaks, the
least work of the port's kernels K1, K2 and K4 at a call's shape, and the
model FLOPs of the cells' models.

Origins in `src/repro_torch`: the peaks are the "H100" row of
`roofline/analysis.py` ``CARDS`` (NVIDIA's data sheet, SXM part, dense:
fp32 67 TFLOP/s outside the tensor cores, HBM 3.35 TB/s; the port keeps
TF32 off); ``k1_work`` is `kernels/graph_mix.py` ``work``, ``k2_work``
`kernels/sparse_graph_mix.py` ``work``, ``k4_work`` and ``k4_bwd_work``
`kernels/flash_attention.py` ``work`` and ``bwd_work`` with
``visible_pairs``. Each returns (bytes, flops): every input byte read
once, every output byte written once.
"""
from __future__ import annotations

from typing import Optional

#: NVIDIA H100 SXM data sheet (dense): FLOP/s by dtype, HBM bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time a call can take on the card: the larger of its FLOPs
    over the peak at ``dtype`` and its bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def k1_work(M: int, N: int, P: int, element_size: int):
    """K1 ``A @ W``: A (fp32) and W read once, out written once; a multiply
    and an add per (m, n, p)."""
    return 4 * M * N + element_size * (N * P + M * P), 2 * M * N * P


def k2_work(N: int, B: int, P: int, element_size: int, slots: int,
            peer_rows: int):
    """K2 neighbor-list mix: self_w, nbr_w and nbr_idx read once, W_self
    read and out written once, the ``peer_rows`` distinct rows of a
    separate W_peers that the lists name (0 where W_peers is W_self); a
    multiply and an add per column of the self term and of each of the
    ``slots`` valid slots."""
    return (4 * N + 8 * N * B + element_size * (2 * N + peer_rows) * P,
            2 * P * (N + slots))


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the mask lets through: row i sees keys j <= i
    when causal, j > i - window under a window."""
    total = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)
        hi = min(i, Sk - 1) if causal else Sk - 1
        total += max(0, hi - lo + 1)
    return total


def k4_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
            causal: bool, window: Optional[int], element_size: int):
    """K4 forward: q, k, v read once and out written once; 4 hd flops per
    visible (query, key) pair of every head."""
    nbytes = element_size * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd)
    return nbytes, 4 * B * Hq * hd * visible_pairs(Sq, Sk, causal, window)


def k4_bwd_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                causal: bool, window: Optional[int], element_size: int):
    """K4 backward: q, k, v, out, dout and lse read once, dq, dk and dv
    written once; 10 hd flops per visible (query, key) pair of every
    head."""
    nbytes, flops = k4_work(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                            element_size)
    nbytes += element_size * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd) \
        + 4 * B * Hq * Sq
    return nbytes, flops // 4 * 10
