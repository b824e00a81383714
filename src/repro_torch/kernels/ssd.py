"""CUDA kernel wrapper for the Mamba2 chunked SSD scan (K5).

Computes what `repro_torch.kernels.ref.ssd_ref` computes: x (b, l, h, p)
already scaled by dt, dlogA (b, l, h), B and C (b, l, n) shared by every
head, an optional h0 (b, h, p, n); returns y (b, l, h, p) and h_last
(b, h, p, n). Port of the Pallas TPU kernel ``repro/kernels/ssd.py::
ssd``; the kernel itself, its bound and its design are described in
``csrc/ssd.cu``.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.ssd` picks the
plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
MAX_HEAD_DIM = 128   # p
MAX_STATE = 128      # n, a multiple of 4
#: shared memory a block may opt in to on Hopper (227 KB)
MAX_SMEM = 232448
_TILE = 64


def smem_bytes(p: int, n: int, L: int) -> int:
    """Dynamic shared memory of one block (``csrc/ssd.cu::smem_floats``):
    the (p, n) state and the C and B tiles padded to n + 4 floats, the X
    tile, the score tile and the chunk's prefix sums."""
    pc = next(c for c in (1, 2, 4, 8) if 16 * c >= p)
    pw, ns = 16 * pc, n + 4
    return 4 * (pw * ns + 2 * _TILE * ns + _TILE * pw + _TILE * (_TILE + 4)
                + L)


def check_no_grad(*tensors: Optional[torch.Tensor]):
    """K5 has no backward (nor has the Pallas kernel): refuse inputs that
    require grad rather than return a result autograd cannot follow."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd has no backward: LM training is ROADMAP Queue 1 item 14d; "
            "call it under torch.no_grad() or torch.inference_mode()")


def ssd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dlogA: (b, l, h); B, C: (b, l, n); h0: (b, h, p, n)
    or None. All float32 on one CUDA device; the last axis of x, B and C
    contiguous (other strides are read as they are). p <= 128; n a
    multiple of 4 up to 128; l a multiple of L = min(chunk, l). Returns
    (y (b, l, h, p), h_last (b, h, p, n)), float32. bf16 is refused: the
    model casts the scan's inputs to float32 (``csrc/ssd.cu``). Adds one
    to ``ssd.launches`` per kernel launch."""
    check_no_grad(x, dlogA, B, C, h0)
    tensors = (x, dlogA, B, C) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd: x, dlogA, B, C and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 4 or dlogA.dim() != 3 or B.dim() != 3 or \
            C.shape != B.shape:
        raise ValueError(f"ssd: shapes {tuple(x.shape)}, "
                         f"{tuple(dlogA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)} are not (b, l, h, p), "
                         f"(b, l, h), (b, l, n) twice")
    b, l, H, p = x.shape
    n = B.shape[-1]
    if tuple(dlogA.shape) != (b, l, H) or tuple(B.shape[:2]) != (b, l):
        raise ValueError(f"ssd: dlogA {tuple(dlogA.shape)} or B/C "
                         f"{tuple(B.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, H, p, n):
        raise ValueError(f"ssd: h0 {tuple(h0.shape)} is not {(b, H, p, n)}")
    if chunk < 1 or l < 1:
        raise ValueError(f"ssd: chunk {chunk} and seq {l} must be >= 1")
    L = min(chunk, l)
    if l % L != 0:
        raise ValueError(f"seq {l} not divisible by chunk {L}")
    if not 0 < p <= MAX_HEAD_DIM:
        raise ValueError(f"ssd: head_dim {p} is not in 1..{MAX_HEAD_DIM}")
    if n % 4 or not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd: state {n} is not a multiple of 4 up to "
                         f"{MAX_STATE}")
    if smem_bytes(p, n, L) > MAX_SMEM:
        raise ValueError(f"ssd: chunk {L} needs {smem_bytes(p, n, L)} bytes "
                         f"of shared memory, over {MAX_SMEM}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd: the last axis of x, B and C must be "
                         "contiguous")
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise ValueError(f"ssd kernel needs every input on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    y = torch.empty((b, l, H, p), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, H, p, n), dtype=x.dtype, device=x.device)
    if b == 0 or H == 0:
        return y, h_last
    h0c = None if h0 is None else h0.contiguous()
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dlogA.stride(0), dlogA.stride(1), dlogA.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    lib_fn = _build.entry("ssd", "ssd_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("ssd", lib_fn(
        x.data_ptr(), dlogA.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0c is None else h0c.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), b, l, H, p, n, L, ctypes.addressof(strides),
        x.device.index, stream))
    ssd.launches += 1
    return y, h_last


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
ssd.launches = 0
