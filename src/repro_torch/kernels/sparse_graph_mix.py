"""CUDA kernel wrapper for the neighbor-list Eq.-4 mix.

Computes ``out[n] = self_w[n] W_self[n] + sum_b nbr_w[n, b]
W_peers[idx[n, b]]`` over the (N, B) neighbor lists of the
budget-constrained greedy (idx -1 is an empty slot with weight 0,
duplicate indices add). Port of the Pallas TPU kernel
``repro/kernels/sparse_graph_mix.py::sparse_graph_mix`` on one device
(the client-mesh rotation of `repro.kernels.ops.sparse_graph_mix` is not
ported); the kernel, its bound and its design are described in
``csrc/sparse_graph_mix.cu``. Its plain version is
`repro_torch.kernels.ref.sparse_graph_mix_ref`.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops` picks the
plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SYMBOLS = {torch.float32: "sparse_graph_mix_f32",
            torch.bfloat16: "sparse_graph_mix_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p)
_MAX_ROWS = 65535   # the grid's y extent: one row of blocks per client


def sparse_graph_mix(self_w: torch.Tensor, nbr_w: torch.Tensor,
                     nbr_idx: torch.Tensor, W_self: torch.Tensor,
                     W_peers: torch.Tensor) -> torch.Tensor:
    """self_w: (N,) fp32; nbr_w: (N, B) fp32; nbr_idx: (N, B) int32 in
    [0, N) or -1; W_self, W_peers: (N, P), both fp32 or both bf16. All
    contiguous on one CUDA device. Returns the (N, P) mix in W_self's
    dtype, fp32 accumulation. Adds one to ``sparse_graph_mix.launches``
    per kernel launch."""
    dev = W_self.device
    tensors = (self_w, nbr_w, nbr_idx, W_self, W_peers)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"sparse_graph_mix kernel needs every tensor on "
                         f"one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if self_w.dtype != torch.float32 or nbr_w.dtype != torch.float32:
        raise TypeError(f"sparse_graph_mix: self_w and nbr_w must be "
                        f"float32, got {self_w.dtype}, {nbr_w.dtype}")
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"sparse_graph_mix: nbr_idx must be int32, got "
                        f"{nbr_idx.dtype}")
    if W_self.dtype not in _SYMBOLS or W_peers.dtype != W_self.dtype:
        raise TypeError(f"sparse_graph_mix: W_self and W_peers must both "
                        f"be float32 or both bfloat16, got {W_self.dtype}, "
                        f"{W_peers.dtype}")
    if W_self.dim() != 2 or W_peers.shape != W_self.shape or \
            nbr_idx.dim() != 2 or nbr_w.shape != nbr_idx.shape or \
            self_w.shape != (W_self.shape[0],) or \
            nbr_idx.shape[0] != W_self.shape[0]:
        raise ValueError(
            f"sparse_graph_mix: shapes self_w {tuple(self_w.shape)}, "
            f"nbr_w {tuple(nbr_w.shape)}, nbr_idx {tuple(nbr_idx.shape)}, "
            f"W_self {tuple(W_self.shape)}, W_peers "
            f"{tuple(W_peers.shape)} do not fit (N,), (N, B), (N, B), "
            f"(N, P), (N, P)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_graph_mix: every tensor must be contiguous")
    N, B = nbr_idx.shape
    P = W_self.shape[1]
    if N > _MAX_ROWS:
        raise ValueError(f"sparse_graph_mix: N = {N} clients is more than "
                         f"the kernel's grid takes ({_MAX_ROWS})")
    out = torch.empty_like(W_self)
    if N == 0 or P == 0:
        return out
    fn = _build.entry("sparse_graph_mix", _SYMBOLS[W_self.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("sparse_graph_mix", fn(
        self_w.data_ptr(), nbr_w.data_ptr(), nbr_idx.data_ptr(),
        W_self.data_ptr(), W_peers.data_ptr(), out.data_ptr(), N, B, P,
        dev.index, stream))
    sparse_graph_mix.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
sparse_graph_mix.launches = 0
