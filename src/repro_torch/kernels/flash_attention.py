"""CUDA kernel wrapper for causal grouped-query flash attention (K4).

Computes attention over aligned positions (query row i and key j sit at
positions i and j): row i sees keys j <= i (causal) and j > i - window.
q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), in `repro`'s layout.
Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``; the kernel itself, its bound and its design are
described in ``csrc/flash_attention.cu``. Its plain version is
`repro_torch.kernels.ref.flash_attention_ref`.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.flash_attention`
picks the plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p)
MAX_HEAD_DIM = 256
#: bytes of each cp.async copy (and ldmatrix row) of the kernel
ALIGN = 16


def alignment_error(name: str, address: int, shape, strides,
                    element_size: int) -> Optional[str]:
    """Why the kernel cannot read ``name`` (a (B, S, H, hd) tensor at
    ``address`` with element ``strides``), or None. Every row of hd
    elements is copied in 16-byte pieces, so the base address and the
    byte stride of each of the first three axes that is longer than 1
    must be multiples of ALIGN (an axis of length 1 is never stepped).
    Pure arithmetic on integers, so the CPU tests reach it."""
    if address % ALIGN:
        return (f"flash_attention: {name}.data_ptr() {address:#x} is not "
                f"{ALIGN}-byte aligned")
    for axis, label in enumerate("bsh"):
        step = strides[axis] * element_size
        if shape[axis] > 1 and step % ALIGN:
            return (f"flash_attention: {name}'s {label} stride "
                    f"{strides[axis]} is {step} bytes, not a multiple of "
                    f"{ALIGN}")
    return None


def check_no_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K4 has no backward (nor has the Pallas kernel): refuse inputs that
    require grad rather than return a result autograd cannot follow."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward: LM training is ROADMAP "
            "Queue 1 item 14d; call it under torch.no_grad() or "
            "torch.inference_mode()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), one dtype (fp32 or bf16)
    on one CUDA device, the last axis contiguous (other strides are read
    as they are, and must be 16-byte aligned: `alignment_error`). hd is
    a multiple of 16 up to 256 and Hq a multiple of Hkv. Returns (B, Sq,
    Hq, hd) in q's dtype. Refuses inputs where a query row sees no key
    (Sk = 0, or Sq > Sk + window - 1): there the plain version averages
    every key, which a kernel that skips masked tiles does not compute.
    Adds one to ``flash_attention.launches`` per kernel launch."""
    check_no_grad(q, k, v)
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype} "
                        f"and {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         f"(B, Sq, Hq, hd), (B, Sk, Hkv, hd) twice")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} (same B and hd, Hq "
                         f"a multiple of Hkv)")
    if hd % 16 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} is not a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim axis must be "
                         "contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if Sq and (Sk == 0 or (window is not None and Sq > Sk + window - 1)):
        raise ValueError(f"flash_attention: with Sq={Sq}, Sk={Sk}, "
                         f"window={window} some query row sees no key")
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = alignment_error(name, t.data_ptr(), t.shape, t.stride(),
                              t.element_size())
        if err:
            raise ValueError(err)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or Hq == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    lib_fn = _build.entry("flash_attention", _SYMBOLS[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("flash_attention", lib_fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, hd, ctypes.addressof(strides), int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        q.device.index, stream))
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
flash_attention.launches = 0
