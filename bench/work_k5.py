"""The least work of the port's K5 (the Mamba2 SSD scan, forward and
backward) at a call's shape, frozen: `src/repro_torch/kernels/ssd.py`
``work``, ``bwd_work`` and ``backward_flops``, with the forward's
``states`` workspace (b, chunks, H, n, p padded to 64 or 128) that the
backward reads. Each returns (bytes, flops): every input byte read once,
every output byte written once, float32. No h0 and no gradient of the
last state: the cells' scans start from zero, and the training loss does
not read the last state.
"""
from __future__ import annotations


def k5_work(b: int, l: int, H: int, p: int, n: int, chunk: int):
    """K5 forward: x, dlogA, B and C read once, y and h_last written once;
    the causal pairs' scores C_i . B_j once per (b, chunk) (2n each),
    then per head the scores times x (2p a pair), the chunk's state
    (2 L n p) and the carried-in C hᵀ in every chunk but the first
    (2 L n p)."""
    L = min(chunk, l)
    c = l // L
    pairs = L * (L + 1) // 2
    flops = (b * c * pairs * 2 * n
             + b * H * (c * pairs * 2 * p + c * 2 * L * n * p
                        + (c - 1) * 2 * L * n * p))
    nbytes = 4 * (2 * b * l * H * p + b * l * H + 2 * b * l * n
                  + b * H * p * n)
    return nbytes, flops


def k5_bwd_work(b: int, l: int, H: int, p: int, n: int, chunk: int):
    """K5 backward: x, B, C, dy, the forward's cum and states read once;
    dx, d dlogA, dB and dC written once; per head dx's scores times dy
    and W's dy . x over the causal pairs (2p each), the (L, p, n)
    products of dx's state term and w in every chunk but the last, of v
    and the dh_in term in every chunk but the first; once per (b, chunk)
    the scores and dB's and dC's products (2n a pair each)."""
    L = min(chunk, l)
    nc = l // L
    pw = 64 if p <= 64 else 128
    pairs = L * (L + 1) // 2
    state = b * H * L * 2 * n * p
    flops = (b * nc * pairs * 2 * n + 2 * b * H * nc * pairs * 2 * p
             + 4 * state * (nc - 1) + 2 * b * nc * pairs * 2 * n)
    nbytes = 4 * (3 * b * l * H * p + 4 * b * l * n + 2 * b * l * H
                  + b * nc * H * n * pw)
    return nbytes, flops
