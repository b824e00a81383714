"""CUDA kernel wrappers for causal grouped-query flash attention (K4) and
its backward.

Computes attention over aligned positions (query row i and key j sit at
positions i and j): row i sees keys j <= i (causal) and j > i - window.
q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), in `repro`'s layout.
The forward ports the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``; the kernel itself, its bound and its design are
described in ``csrc/flash_attention.cu``. Its plain version is
`repro_torch.kernels.ref.flash_attention_ref`. On fp32 inputs that
require grad, `flash_attention` is a ``torch.autograd.Function``: its
forward also writes each row's log-sum-exp, and its backward is
`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``, which has no
Pallas counterpart: `repro` differentiates its plain attention), whose
plain version is `repro_torch.kernels.ref.flash_attention_bwd_ref`.

The wrappers launch their kernels on CUDA tensors, or raise: they never
fall back to a plain version (`repro_torch.kernels.ops.flash_attention`
picks the plain version, which autograd differentiates, for CPU tensors
only).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
# q, k, v, out, lse; B, Sq, Sk, Hq, Hkv, hd; strides; causal, window,
# scale, device; stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 +
             (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_int, ctypes.c_void_p))
# q, k, v, out, dout, lse, delta, dq, dk, dv, ds, part; B, Sq, Sk, Hq,
# Hkv, hd; strides; causal, window, scale; plan; device; stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 6 +
                 (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p))
MAX_HEAD_DIM = 256
#: bytes of each cp.async copy (and ldmatrix row) of the kernel
ALIGN = 16
#: the backward's threads a block of (b) and of the split sum, query rows
#: a tile, and the dynamic shared memory a block may take
#: (csrc/flash_attention_bwd.cu's kBwdThreads, flash_attention.cuh's kBQ
#: and kMaxSmem)
BWD_THREADS = 256
QUERY_TILE = 64
MAX_SMEM = 232448
#: the backward's scratch of scale dS^T holds at most this many bytes:
#: longer key ranges are walked in slabs of keys
BWD_SCRATCH_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How `flash_attention_bwd` launches its kernels at one shape
    (csrc/flash_attention_bwd.cu's (a), (b), (c) and the split sum).

    ``block_keys`` keys a (b) block and a tile of (c); ``splits`` blocks
    share a GQA group's query heads in (b) (each its Hq / Hkv / splits
    heads); ``slab_keys`` keys a pass of (b) and (c), ``n_slabs`` passes;
    ``grids`` each launch's (x, y, z) in order, under "delta", "dkdv"
    ((KV head, split), batch, key tile), "dq" (head, batch, query tile)
    and "reduce" (the C entry derives each slab's from ``launch`` the
    same way): the tile is the slowest axis, so the blocks with the most
    work start first when causal; ``smem`` the dynamic shared bytes of
    (b) and (c) and ``stages`` (b)'s Q/dO stages; ``scratch`` the shapes
    of the fp32 scratch tensors ("ds", and "part" when splits > 1);
    ``launch`` the ints the C entry takes."""
    block_keys: int
    splits: int
    slab_keys: int
    n_slabs: int
    query_tiles: int
    stages: int
    grids: Dict[str, Tuple[Tuple[int, int, int], ...]]
    smem: Dict[str, int]
    scratch: Dict[str, Tuple[int, ...]]
    launch: Tuple[int, ...]

    def scratch_bytes(self) -> int:
        return 4 * sum(math.prod(s) for s in self.scratch.values())


def backward_block_keys(hd: int) -> int:
    """Keys a (b) block takes at head size ``hd``: 64, or 32 above 128
    (K, V and a stage of Q and dO must fit shared memory)."""
    return 64 if hd <= 128 else 32


def backward_smem(hd: int) -> Tuple[int, int, int]:
    """((b)'s dynamic shared bytes, its Q/dO stages, (c)'s bytes), as
    csrc/flash_attention_bwd.cu's KVTiles and QTiles lay them out: (b)
    holds K and V tiles, P and dS, and one or two stages of Q and dO,
    rows padded by 4 floats; (c) two stages of a scratch tile and a K
    tile."""
    bk, pitch = backward_block_keys(hd), hd + 4
    fixed = 2 * bk * pitch + 2 * QUERY_TILE * (bk + 4)
    stage = 2 * QUERY_TILE * pitch
    stages = 2 if (fixed + 2 * stage) * 4 <= MAX_SMEM else 1
    return ((fixed + stages * stage) * 4, stages,
            2 * bk * (QUERY_TILE + 4 + pitch) * 4)


def backward_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                  sms: int) -> BackwardPlan:
    """The launch plan of `flash_attention_bwd` for these shapes on a
    card of ``sms`` SMs. The scratch of scale dS^T, (B, Hq, query tiles,
    slab keys, 64) fp32, stays within BWD_SCRATCH_BYTES unless one key
    tile already exceeds it; the splits are the fewest (a divisor of Hq /
    Hkv) that give (b)'s first pass two blocks an SM, else Hq / Hkv. Pure
    arithmetic, so the CPU tests reach it."""
    bk = backward_block_keys(hd)
    rep = Hq // Hkv
    n_qt = -(-Sq // QUERY_TILE)
    key_tiles = -(-Sk // bk)
    per_key = B * Hq * n_qt * QUERY_TILE * 4
    slab = bk * max(1, min(key_tiles, BWD_SCRATCH_BYTES // (per_key * bk)))
    n_slabs = -(-Sk // slab)
    first = -(-min(slab, Sk) // bk) * Hkv * B
    splits = next((d for d in range(1, rep + 1)
                   if rep % d == 0 and first * d >= 2 * sms), rep)
    dkdv_smem, stages, dq_smem = backward_smem(hd)
    n4 = B * Sk * Hkv * hd // 4
    reduce_blocks = max(1, min(-(-n4 // BWD_THREADS), 8 * sms))
    grids = {
        "delta": ((-(-B * Sq * Hq // 4), 1, 1),),
        "dkdv": tuple((Hkv * splits, B, -(-min(slab, Sk - s * slab) // bk))
                      for s in range(n_slabs)),
        "dq": ((Hq, B, n_qt),) * n_slabs,
        "reduce": ((reduce_blocks, 2, 1),) if splits > 1 else ()}
    scratch = {"ds": (B, Hq, n_qt, slab, QUERY_TILE)}
    if splits > 1:
        scratch["part"] = (2, splits, B, Sk, Hkv, hd)
    return BackwardPlan(
        block_keys=bk, splits=splits, slab_keys=slab, n_slabs=n_slabs,
        query_tiles=n_qt, stages=stages, grids=grids,
        smem={"dkdv": dkdv_smem, "dq": dq_smem}, scratch=scratch,
        launch=(bk, splits, slab, n_slabs, dkdv_smem, dq_smem,
                reduce_blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    """K4's backward takes fp32 only: refuse other inputs that require
    grad rather than return a result autograd cannot follow."""
    if q.dtype != torch.float32 and (q.requires_grad or k.requires_grad
                                     or v.requires_grad):
        raise NotImplementedError(
            f"flash_attention has no {q.dtype} backward (fp32 only): bf16 "
            f"LM training is ROADMAP item 14d-3 (speed work after the "
            f"port); call it under torch.no_grad() or "
            f"torch.inference_mode()")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window):
    """(B, Sq, Sk, Hq, Hkv, hd) of inputs the kernels take, or raise."""
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
    return B, Sq, Sk, Hq, Hkv, hd


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                     for i in range(3)))


def _forward(q, k, v, causal, window, with_lse):
    """Launch the forward; returns (out, lse or None). lse is the (B, Hq,
    Sq) fp32 log-sum-exp of each row's scaled, masked scores."""
    B, Sq, Sk, Hq, Hkv, hd = _check(q, k, v, window)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if B == 0 or Sq == 0 or Hq == 0:
        return out, lse
    strides = _strides(q, k, v)
    lib_fn = _build.entry("flash_attention", _SYMBOLS[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("flash_attention", lib_fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
        ctypes.addressof(strides), int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        q.device.index, stream))
    flash_attention.launches += 1
    return out, lse


class _Attention(torch.autograd.Function):
    """K4 under autograd: the forward saves q, k, v, out and the row
    log-sum-exps; the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


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
    fp32 inputs that require grad (grad mode on) go through the
    autograd Function, whose backward launches `flash_attention_bwd`;
    bf16 ones raise (`check_no_grad`). Adds one to
    ``flash_attention.launches`` per kernel launch (under activation
    recompute, ``torch.utils.checkpoint``, the forward launches again in
    the backward pass)."""
    check_no_grad(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None):
    """The forward launch the autograd Function makes, outside autograd:
    (out, lse), lse the (B, Hq, Sq) fp32 natural log-sum-exp of each
    row's scaled, masked scores. Adds one to ``flash_attention.launches``."""
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """dq, dk, dv of `flash_attention` at (q, k, v) for the gradient
    ``dout`` of its output: fp32 only, q, k and v as the forward takes
    them, ``out`` and ``lse`` the forward's (`flash_attention_with_lse`),
    dout (B, Sq, Hq, hd) (copied if not contiguous and 16-byte aligned).
    Returns contiguous fp32 (B, Sq, Hq, hd), (B, Sk, Hkv, hd) twice. One
    call launches the kernels of `backward_plan` (the row sums D =
    rowsum(dout * out), then dk and dv with scale dS to a scratch and dq
    from it, once per slab of keys, then the sum of the head splits where
    there are several) and adds one to ``flash_attention_bwd.launches``.
    The scratch (`BackwardPlan.scratch_bytes`) lives for the call."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: fp32 only, got {q.dtype} "
                        f"(bf16 training is ROADMAP item 14d-3)")
    B, Sq, Sk, Hq, Hkv, hd = _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be fp32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if not (out.is_contiguous() and lse.is_contiguous()) or \
            out.data_ptr() % ALIGN:
        raise ValueError("flash_attention_bwd: out and lse must be the "
                         "forward's (contiguous, aligned)")
    dout = dout.contiguous()
    if dout.data_ptr() % ALIGN:
        dout = dout.clone()
    dq = torch.empty_like(dout)
    dk = torch.empty((B, Sk, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    plan = backward_plan(B, Sq, Sk, Hq, Hkv, hd, _sm_count(q.device.index))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ds = torch.empty(plan.scratch["ds"], dtype=torch.float32,
                     device=q.device)
    part = torch.empty(plan.scratch["part"], dtype=torch.float32,
                       device=q.device) if plan.splits > 1 else None
    strides = _strides(q, k, v)
    launch = (ctypes.c_int * len(plan.launch))(*plan.launch)
    lib_fn = _build.entry("flash_attention_bwd", "flash_attention_bwd_f32",
                          _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("flash_attention_bwd", lib_fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ds.data_ptr(),
        None if part is None else part.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
        ctypes.addressof(strides), int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        ctypes.addressof(launch), q.device.index, stream))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the main path and reads them after): forward
#: launches (the autograd Function's included), and backward calls (the
#: kernels of `backward_plan` each)
flash_attention.launches = 0
flash_attention_bwd.launches = 0
