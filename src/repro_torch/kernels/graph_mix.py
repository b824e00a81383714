"""CUDA kernel wrapper for the DPFL collaboration-graph mix (Eq. 4).

Computes ``out = A @ W``: A is the (M, N) mixing operator (the
row-stochastic Eq.-4 matrix, or the mask-weight rows of the greedy set
sums), W the (N, P) client-stacked flattened parameters. Port of the
Pallas TPU kernel ``repro/kernels/graph_mix.py::graph_mix``; the kernel
itself, its bound and its design are described in ``csrc/graph_mix.cu``.
Its plain version is `repro_torch.kernels.ref.graph_mix_ref`.

The wrapper launches the kernel on a CUDA tensor, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.graph_mix`
picks the plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SYMBOLS = {torch.float32: "graph_mix_f32", torch.bfloat16: "graph_mix_bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def graph_mix(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A: (M, N) fp32; W: (N, P) fp32 or bf16, both contiguous on one CUDA
    device. Returns (M, P) = A @ W in W's dtype, fp32 accumulation.
    Adds one to ``graph_mix.launches`` per kernel launch."""
    if A.device.type != "cuda" or W.device != A.device:
        raise ValueError(f"graph_mix kernel needs A and W on one CUDA "
                         f"device, got {A.device} and {W.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"graph_mix: A must be float32, got {A.dtype}")
    if W.dtype not in _SYMBOLS:
        raise TypeError(f"graph_mix: W must be float32 or bfloat16, "
                        f"got {W.dtype}")
    if A.dim() != 2 or W.dim() != 2 or A.shape[1] != W.shape[0]:
        raise ValueError(f"graph_mix: shapes {tuple(A.shape)} @ "
                         f"{tuple(W.shape)} do not chain")
    if not (A.is_contiguous() and W.is_contiguous()):
        raise ValueError("graph_mix: A and W must be contiguous")
    M, N = A.shape
    P = W.shape[1]
    out = torch.empty((M, P), dtype=W.dtype, device=W.device)
    if M == 0 or P == 0:
        return out
    if N == 0:
        return out.zero_()
    lib_fn = _build.entry("graph_mix", _SYMBOLS[W.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _build.check("graph_mix", lib_fn(A.data_ptr(), W.data_ptr(),
                                     out.data_ptr(), M, N, P,
                                     W.device.index, stream))
    graph_mix.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
graph_mix.launches = 0
