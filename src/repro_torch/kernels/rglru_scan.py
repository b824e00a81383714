"""CUDA kernel wrapper for the RG-LRU linear recurrence (K6).

Computes what `repro_torch.kernels.ref.linear_scan_ref` computes,
``h_t = a_t * h_{t-1} + b_t`` over the time axis of (B, S, W) float32
inputs with an optional h0 (B, W), bit for bit; returns h (B, S, W) and
h_last (B, W). Port of the Pallas TPU kernel ``repro/kernels/
rglru_scan.py::rglru_scan``; the kernel itself, its bound and its design
are described in ``csrc/rglru_scan.cu``.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.rglru_scan`
picks the plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def check_no_grad(*tensors: Optional[torch.Tensor]):
    """K6 has no backward (nor has the Pallas kernel): refuse inputs that
    require grad rather than return a result autograd cannot follow."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "rglru_scan has no backward yet: SSM and hybrid LM training is "
            "ROADMAP Queue 1 item 14d-2; call it under torch.no_grad() or "
            "torch.inference_mode()")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, W); h0: (B, W) or None (zeros). All float32 on one CUDA
    device; any S >= 1 and W >= 1. Non-contiguous inputs are copied
    contiguous first (the model passes fresh ones). Returns (h (B, S, W),
    h_last (B, W)), float32. bf16 is refused: the model casts the scan's
    inputs to float32 (``csrc/rglru_scan.cu``). Adds one to
    ``rglru_scan.launches`` per kernel launch."""
    check_no_grad(a, b, h0)
    tensors = (a, b) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rglru_scan: a, b and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]} (a bf16 path is not "
                        f"ported)")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} are not one (B, S, W) shape")
    B, S, W = a.shape
    if S < 1 or W < 1:
        raise ValueError(f"rglru_scan: S {S} and W {W} must be >= 1")
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} is not {(B, W)}")
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(f"rglru_scan kernel needs every input on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    h_last = torch.empty((B, W), dtype=a.dtype, device=a.device)
    if B == 0:
        return h, h_last
    a, b = a.contiguous(), b.contiguous()
    h0c = None if h0 is None else h0.contiguous()
    lib_fn = _build.entry("rglru_scan", "rglru_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check("rglru_scan", lib_fn(
        a.data_ptr(), b.data_ptr(), None if h0c is None else h0c.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), B, S, W, a.device.index, stream))
    rglru_scan.launches += 1
    return h, h_last


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
rglru_scan.launches = 0
