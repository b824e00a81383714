"""CUDA kernel wrappers for the RG-LRU linear recurrence (K6) and its
backward.

Computes what `repro_torch.kernels.ref.linear_scan_ref` computes,
``h_t = a_t * h_{t-1} + b_t`` over the time axis of (B, S, W) float32
inputs with an optional h0 (B, W), bit for bit; returns h (B, S, W) and
h_last (B, W). Port of the Pallas TPU kernel ``repro/kernels/
rglru_scan.py::rglru_scan``; the kernel itself, its bound and its design
are described in ``csrc/rglru_scan.cu``. On inputs that require grad
(grad mode on), `rglru_scan` is a ``torch.autograd.Function`` whose
backward is `rglru_scan_bwd` (``csrc/rglru_scan_bwd.cu``, which has no
Pallas counterpart: `repro` differentiates its oracle), bit for bit its
plain version, `repro_torch.kernels.ref.linear_scan_bwd_ref`.

The wrappers launch their kernels on CUDA tensors, or raise: they never
fall back to the plain version (`repro_torch.kernels.ops.rglru_scan`
picks the plain version, which autograd differentiates, for CPU tensors
only). On "meta" tensors they run the checks and allocate what a launch
allocates, and launch nothing (`repro_torch.kernels.meta`). `work` and
`bwd_work` are the bytes and operations of one call.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from . import meta as _meta

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# a, h, h0, dy, dh_last, da, db, dh0; B, S, W, blocks, device; stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
#: channels a block of either kernel takes, one a thread
THREADS = 128


def work(B: int, S: int, W: int, with_h0: bool):
    """(bytes, flops) the forward must at least move and do: a and b (and
    h0) read once, h and h_last written once; a product and a sum per
    element."""
    n = B * S * W
    return 4 * (3 * n + (2 if with_h0 else 1) * B * W), 2 * n


def bwd_work(B: int, S: int, W: int, with_h0: bool, with_dh_last: bool):
    """(bytes, flops) the backward must at least move and do: a, h and dy
    read once, da and db written once (20 bytes an element), h0 and
    dh_last read and dh0 written where given; three flops an element."""
    n = B * S * W
    return (4 * (5 * n + B * W * (with_h0 * 2 + with_dh_last)), 3 * n)


def _check(a, b, h0):
    """(B, S, W) of inputs the kernels take, or raise."""
    tensors = (a, b) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise _meta.RefusedType(
            f"rglru_scan: a, b and h0 must be float32, got "
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
    if a.device.type not in ("cuda", "meta") or any(t.device != a.device
                                                    for t in tensors):
        raise ValueError(f"rglru_scan kernel needs every input on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return B, S, W


def _forward(a, b, h0):
    B, S, W = _check(a, b, h0)
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    h_last = torch.empty((B, W), dtype=a.dtype, device=a.device)
    if B == 0:
        return h, h_last
    a, b = a.contiguous(), b.contiguous()
    h0c = None if h0 is None else h0.contiguous()
    if a.device.type == "meta":
        _meta.record("rglru_scan", work(B, S, W, h0 is not None), a.dtype)
        return h, h_last
    lib_fn = _build.entry("rglru_scan", "rglru_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check("rglru_scan", lib_fn(
        a.data_ptr(), b.data_ptr(), None if h0c is None else h0c.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), B, S, W, a.device.index, stream))
    rglru_scan.launches += 1
    return h, h_last


class _Scan(torch.autograd.Function):
    """K6 under autograd: the forward saves a, its output h and h0; the
    backward is `rglru_scan_bwd`. An unused h_last arrives as None (no
    zeros are made for it)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _forward(a, b, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        return rglru_scan_bwd(a, h, h0, dh, dh_last)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, W); h0: (B, W) or None (zeros). All float32 on one CUDA
    device; any S >= 1 and W >= 1. Non-contiguous inputs are copied
    contiguous first (the model passes fresh ones). Returns (h (B, S, W),
    h_last (B, W)), float32. bf16 is refused: the model casts the scan's
    inputs to float32 (``csrc/rglru_scan.cu``). Inputs that require grad
    (grad mode on) go through the autograd Function, whose backward
    launches `rglru_scan_bwd`. Adds one to ``rglru_scan.launches`` per
    kernel launch (under activation recompute, the forward launches
    again in the backward pass)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return _Scan.apply(a, b, h0)
    return _forward(a, b, h0)


def backward_blocks(B: int, W: int) -> int:
    """Blocks of the backward's one launch: one thread a channel (b, w),
    `THREADS` a block. The C entry refuses any other count."""
    return -(-B * W // THREADS)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """(da, db, dh0) of `rglru_scan` at (a, b, h0) for the gradients ``dh``
    (B, S, W) of h and ``dh_last`` (B, W) of h_last (None: zeros, with no
    launch to make them): ``a`` and ``h0`` as the forward took them, ``h``
    its output (b is not needed: h holds it). float32 on one CUDA device;
    non-contiguous tensors are copied. dh0 is None when h0 is. One launch
    of `backward_blocks` blocks, bit for bit `ref.linear_scan_bwd_ref`;
    adds one to ``rglru_scan_bwd.launches``."""
    B, S, W = _check(a, h, h0)
    for name, t, shape in (("dh", dh, (B, S, W)),
                           ("dh_last", dh_last, (B, W))):
        if t is not None and (tuple(t.shape) != shape or
                              t.dtype != torch.float32 or
                              t.device != a.device):
            raise ValueError(f"rglru_scan_bwd: {name} must be float32 "
                             f"{shape} on {a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    da = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    db = torch.empty_like(da)
    dh0 = torch.empty((B, W), dtype=a.dtype, device=a.device) \
        if h0 is not None else None
    if B == 0:
        return da, db, dh0
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    h0c = None if h0 is None else h0.contiguous()
    dlc = None if dh_last is None else dh_last.contiguous()
    if a.device.type == "meta":
        _meta.record("rglru_scan_bwd", bwd_work(
            B, S, W, h0 is not None, dh_last is not None), a.dtype)
        return da, db, dh0
    lib_fn = _build.entry("rglru_scan_bwd", "rglru_scan_bwd_f32",
                          _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check("rglru_scan_bwd", lib_fn(
        a.data_ptr(), h.data_ptr(), None if h0c is None else h0c.data_ptr(),
        dh.data_ptr(), None if dlc is None else dlc.data_ptr(),
        da.data_ptr(), db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
        B, S, W, backward_blocks(B, W), a.device.index, stream))
    rglru_scan_bwd.launches += 1
    return da, db, dh0


#: kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the main path and reads them after): forward
#: launches (the autograd Function's included), and backward launches
rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
