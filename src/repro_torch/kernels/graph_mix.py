"""CUDA kernel wrapper for the DPFL collaboration-graph mix (Eq. 4).

Computes ``out = A @ W``: A is the (M, N) mixing operator (the
row-stochastic Eq.-4 matrix, or the mask-weight rows of the greedy set
sums), W the (N, P) client-stacked flattened parameters. Port of the
Pallas TPU kernel ``repro/kernels/graph_mix.py::graph_mix``; the kernel
itself, its bound and its design are described in ``csrc/graph_mix.cu``.
Its plain version is `repro_torch.kernels.ref.graph_mix_ref`.

The wrapper launches the kernel on a CUDA tensor, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.graph_mix`
picks the plain version for CPU tensors only). On "meta" tensors it runs
the checks and allocates the output, and launches nothing
(`repro_torch.kernels.meta`). `work` is the bytes and operations of one
call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import meta as _meta

_SYMBOLS = {torch.float32: "graph_mix_f32", torch.bfloat16: "graph_mix_bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
#: columns per thread the kernel takes, widest first (no 4: csrc note)
WIDTHS = (2, 1)


def vector_width(P: int, element_size: int, *addresses: int) -> int:
    """Columns of W each kernel thread loads as one vector: the widest of
    WIDTHS that divides P (so row n, which starts at ``n * P`` elements,
    keeps the alignment of row 0) and to whose byte size every base
    address (W's and out's ``data_ptr()``; K2's W_self, W_peers and out)
    is aligned. PaperCNN's P of 62,006 is even: its rows are 8-byte
    aligned in fp32, so 2."""
    for cols in WIDTHS:
        if P % cols == 0 and all(a % (cols * element_size) == 0
                                 for a in addresses):
            return cols
    raise _meta.RefusedValue(
        f"an address in {addresses} is not aligned to its "
        f"{element_size}-byte elements")


def work(M: int, N: int, P: int, element_size: int):
    """(bytes, flops) one call must at least move and do: A (fp32) and W
    read once, out written once; a multiply and an add per (m, n, p)."""
    return 4 * M * N + element_size * (N * P + M * P), 2 * M * N * P


def graph_mix(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A: (M, N) fp32; W: (N, P) fp32 or bf16, both contiguous on one CUDA
    device. Returns (M, P) = A @ W in W's dtype, fp32 accumulation.
    W may start at any element boundary (a row-offset view): the vector
    width follows P and the addresses (`vector_width`). Adds one to
    ``graph_mix.launches`` per kernel launch. On "meta" tensors: the
    checks and the output, no launch."""
    if A.device.type not in ("cuda", "meta") or W.device != A.device:
        raise ValueError(f"graph_mix kernel needs A and W on one CUDA "
                         f"device, got {A.device} and {W.device}")
    if A.dtype != torch.float32:
        raise _meta.RefusedType(f"graph_mix: A must be float32, got {A.dtype}")
    if W.dtype not in _SYMBOLS:
        raise _meta.RefusedType(f"graph_mix: W must be float32 or bfloat16, "
                                f"got {W.dtype}")
    if A.dim() != 2 or W.dim() != 2 or A.shape[1] != W.shape[0]:
        raise ValueError(f"graph_mix: shapes {tuple(A.shape)} @ "
                         f"{tuple(W.shape)} do not chain")
    if not (A.is_contiguous() and W.is_contiguous()):
        raise ValueError("graph_mix: A and W must be contiguous")
    M, N = A.shape
    P = W.shape[1]
    out = torch.empty((M, P), dtype=W.dtype, device=W.device)
    if A.device.type == "meta":
        _meta.record("graph_mix", work(M, N, P, W.element_size()), W.dtype)
        return out
    if M == 0 or P == 0:
        return out
    if N == 0:
        return out.zero_()
    cols = vector_width(P, W.element_size(), W.data_ptr(), out.data_ptr())
    lib_fn = _build.entry("graph_mix", _SYMBOLS[W.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _build.check("graph_mix", lib_fn(A.data_ptr(), W.data_ptr(),
                                     out.data_ptr(), M, N, P, cols,
                                     W.device.index, stream))
    graph_mix.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
graph_mix.launches = 0
