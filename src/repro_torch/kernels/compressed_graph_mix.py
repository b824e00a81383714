"""CUDA kernel wrapper for the top-k codec's Eq.-4 off-diagonal mix.

Computes ``out = A @ densify(vals, idx)``: A is the (M, N) mixing
operator with its diagonal zeroed by the caller, (vals, idx) the (N, K)
top-k payloads (duplicate indices add, -1 pads land nowhere). Port of
the Pallas TPU kernel
``repro/kernels/compressed_graph_mix.py::compressed_graph_mix`` on one
device (the client-mesh all-gather is not ported); the kernel, its bound
and its design are described in ``csrc/compressed_graph_mix.cu``. Its
plain version is `repro_torch.kernels.ref.compressed_graph_mix_ref`.

The kernel reads each payload row sorted by index: the wrapper sorts it
first (a stable `torch.sort`, so duplicates keep their payload order and
add in it), on the same stream, and that sort belongs to the op's time.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops` picks the
plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p)


def compressed_graph_mix(A: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, p_dim: int) -> torch.Tensor:
    """A: (M, N) fp32; vals: (N, K) fp32; idx: (N, K) int32 in
    [0, p_dim) or -1. All contiguous on one CUDA device. Returns
    (M, p_dim) = A @ densify(vals, idx) in fp32. Adds one to
    ``compressed_graph_mix.launches`` per kernel launch."""
    dev = A.device
    if dev.type != "cuda" or vals.device != dev or idx.device != dev:
        raise ValueError(f"compressed_graph_mix kernel needs A, vals and "
                         f"idx on one CUDA device, got {A.device}, "
                         f"{vals.device}, {idx.device}")
    if A.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"compressed_graph_mix: A and vals must be "
                        f"float32, got {A.dtype}, {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"compressed_graph_mix: idx must be int32, got "
                        f"{idx.dtype}")
    if A.dim() != 2 or vals.dim() != 2 or idx.shape != vals.shape or \
            A.shape[1] != vals.shape[0]:
        raise ValueError(f"compressed_graph_mix: shapes A "
                         f"{tuple(A.shape)}, vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)} do not fit (M, N), (N, K), "
                         f"(N, K)")
    if not (A.is_contiguous() and vals.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("compressed_graph_mix: A, vals and idx must be "
                         "contiguous")
    M, N = A.shape
    K = vals.shape[1]
    P = int(p_dim)
    if P < 0:
        raise ValueError(f"compressed_graph_mix: p_dim {p_dim} < 0")
    if M == 0 or P == 0 or N == 0 or K == 0:
        return torch.zeros((M, P), dtype=torch.float32, device=dev)
    return launch_sorted(A, *sort_payload(vals, idx), P)


def sort_payload(vals: torch.Tensor, idx: torch.Tensor):
    """Each row's (vals, idx) sorted by index, stably: duplicates keep
    their payload order, -1 pads come first. Returns (vals, idx)."""
    sorted_idx, perm = torch.sort(idx, dim=1, stable=True)
    return vals.gather(1, perm), sorted_idx


def launch_sorted(A: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  p_dim: int) -> torch.Tensor:
    """The kernel alone, on payload rows already sorted by index
    (`sort_payload`), checked by `compressed_graph_mix`. Adds one to
    ``compressed_graph_mix.launches``."""
    M, N = A.shape
    out = torch.empty((M, p_dim), dtype=torch.float32, device=A.device)
    fn = _build.entry("compressed_graph_mix", "compressed_graph_mix_f32",
                      _ARGTYPES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    _build.check("compressed_graph_mix", fn(
        A.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(), M, N,
        vals.shape[1], p_dim, A.device.index, stream))
    compressed_graph_mix.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
compressed_graph_mix.launches = 0
