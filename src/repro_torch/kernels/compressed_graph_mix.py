"""CUDA kernel wrapper for the top-k codec's Eq.-4 off-diagonal mix.

Computes ``out = A @ densify(vals, idx)``: A is the (M, N) mixing
operator with its diagonal zeroed by the caller, (vals, idx) the (N, K)
top-k payloads (duplicate indices add, -1 pads land nowhere). Port of
the Pallas TPU kernel
``repro/kernels/compressed_graph_mix.py::compressed_graph_mix`` on one
device (under a client mesh `repro_torch.kernels.ops` all-gathers the
payloads and launches it on the rank's row block of A); the kernel, its
bound and its design are described in ``csrc/compressed_graph_mix.cu``. Its
plain version is `repro_torch.kernels.ref.compressed_graph_mix_ref`.

One op is two launches on the same stream, both hand-written CUDA: a
bucketing pass (`bucket_payload`) groups each payload row by 256-column
tile, stably (duplicates keep their payload order and add in it), and
writes each tile's bucket bounds to an offset table; the mix
(`launch_bucketed`) reads each tile's buckets from it. No library sort
runs. The pass's plain version is
`repro_torch.kernels.ref.bucket_payload_ref`.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops` picks the
plain version for CPU tensors only). On "meta" tensors it runs the
checks and allocates what the pair allocates (the bucketed payload, its
offset table and the output), and launches nothing
(`repro_torch.kernels.meta`). `work` is the bytes and operations of one
op.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import meta as _meta

_BUCKET_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int,
                                             ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p)
_MIX_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_void_p)
#: output columns of one tile (csrc: kTile)
TILE = 256


def work(M: int, N: int, K: int, P: int, entries: int):
    """(bytes, flops) one op must at least move and do: the (N, K) fp32
    values and int32 indices and A read once, out written once; a
    multiply and an add per output row and each of the ``entries``
    payload entries in [0, P). The count depends on the payload: a
    shape-only call counts every entry in range."""
    return 8 * N * K + 4 * M * N + 4 * M * P, 2 * M * entries


def compressed_graph_mix(A: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, p_dim: int) -> torch.Tensor:
    """A: (M, N) fp32; vals: (N, K) fp32; idx: (N, K) int32, an entry
    outside [0, p_dim) (the -1 pad) landing nowhere. All contiguous on
    one CUDA device. Returns
    (M, p_dim) = A @ densify(vals, idx) in fp32. Launches the bucketing
    pass and the mix; the pair is one op, so it adds one to
    ``compressed_graph_mix.launches`` (in `launch_bucketed`). On "meta"
    tensors: the checks and the pair's allocations, no launch."""
    dev = A.device
    if dev.type not in ("cuda", "meta") or vals.device != dev or \
            idx.device != dev:
        raise ValueError(f"compressed_graph_mix kernel needs A, vals and "
                         f"idx on one CUDA device, got {A.device}, "
                         f"{vals.device}, {idx.device}")
    if A.dtype != torch.float32 or vals.dtype != torch.float32:
        raise _meta.RefusedType(f"compressed_graph_mix: A and vals must be "
                                f"float32, got {A.dtype}, {vals.dtype}")
    if idx.dtype != torch.int32:
        raise _meta.RefusedType(
            f"compressed_graph_mix: idx must be int32, got "
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
    return launch_bucketed(A, *bucket_payload(vals, idx, P), P)


def bucket_payload(vals: torch.Tensor, idx: torch.Tensor, p_dim: int):
    """The bucketing pass alone, on a payload checked by
    `compressed_graph_mix`: returns (vals, idx, offsets), the first two
    (N, K) with each row's entries in [0, p_dim) grouped by TILE-column
    tile in payload order and the row's tail (0.0, -1), and offsets
    (N, T + 1) int32, T = ceil(p_dim / TILE): tile t of row n is
    ``[offsets[n, t], offsets[n, t + 1])``. Counts no launch."""
    N, K = idx.shape
    T = -(-p_dim // TILE)
    bvals = torch.empty_like(vals)
    bidx = torch.empty_like(idx)
    offsets = torch.empty((N, T + 1), dtype=torch.int32, device=idx.device)
    if idx.device.type == "meta":
        return bvals, bidx, offsets
    fn = _build.entry("compressed_graph_mix", "compressed_graph_mix_bucket",
                      _BUCKET_ARGTYPES)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    _build.check("compressed_graph_mix", fn(
        vals.data_ptr(), idx.data_ptr(), bvals.data_ptr(), bidx.data_ptr(),
        offsets.data_ptr(), N, K, p_dim, idx.device.index, stream))
    return bvals, bidx, offsets


def launch_bucketed(A: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    offsets: torch.Tensor, p_dim: int) -> torch.Tensor:
    """The mix alone, on a payload `bucket_payload` grouped, checked by
    `compressed_graph_mix`. Adds one to ``compressed_graph_mix.launches``
    (the op's count)."""
    M, N = A.shape
    out = torch.empty((M, p_dim), dtype=torch.float32, device=A.device)
    if A.device.type == "meta":
        _meta.record("compressed_graph_mix",
                     work(M, N, vals.shape[1], p_dim, vals.numel()),
                     torch.float32)
        return out
    fn = _build.entry("compressed_graph_mix", "compressed_graph_mix_f32",
                      _MIX_ARGTYPES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    _build.check("compressed_graph_mix", fn(
        A.data_ptr(), vals.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), M, N, vals.shape[1], p_dim, A.device.index, stream))
    compressed_graph_mix.launches += 1
    return out


#: ops launched since the last reset, one per bucketing pass and mix pair
#: (a plain int; chip_smoke.py zeroes it before driving the main path and
#: reads it after)
compressed_graph_mix.launches = 0
