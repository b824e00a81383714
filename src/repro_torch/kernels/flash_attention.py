"""CUDA kernel wrappers for causal grouped-query flash attention (K4) and
its backward.

Computes attention over aligned positions (query row i and key j sit at
positions i and j): row i sees keys j <= i (causal) and j > i - window.
q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), in `repro`'s layout.
The forward ports the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``; the kernel itself, its bound and its design are
described in ``csrc/flash_attention.cu``. Its plain version is
`repro_torch.kernels.ref.flash_attention_ref`. On inputs that require
grad (fp32 or bf16), `flash_attention` is a ``torch.autograd.Function``:
its forward also writes each row's log-sum-exp, and its backward is
`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``, which has no
Pallas counterpart: `repro` differentiates its plain attention, at bf16
with its cast points), whose plain version is
`repro_torch.kernels.ref.flash_attention_bwd_ref`. The source is built
twice, one library an element type: fp32 (`flash_attention_bwd`'s
count) and bf16 (`flash_attention_bwd_bf16`'s).

The wrappers launch their kernels on CUDA tensors, or raise: they never
fall back to a plain version (`repro_torch.kernels.ops.flash_attention`
picks the plain version, which autograd differentiates, for CPU tensors
only). On "meta" tensors they run the checks and allocate what a launch
allocates (the backward's scratch of `backward_plan` included, planned
for the SM count of `repro_torch.kernels.meta.target`), and launch
nothing. `work` and `bwd_work` are the bytes and operations of one call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import meta as _meta

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
# q, k, v, out, lse; B, Sq, Sk, Hq, Hkv, hd; strides; causal, window,
# scale, device; stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 +
             (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_int, ctypes.c_void_p))
# q, k, v, out, dout, lse, delta, dq, dk, dv, ds, part, dq32; B, Sq, Sk,
# Hq, Hkv, hd; strides; causal, window, scale; plan; device; stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 6 +
                 (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p))
#: the backward's library and C entry by element type (one source, built
#: with FA_BWD_BF16 for bf16: `_build.DEFINES`)
_BWD_ENTRIES = {torch.float32: ("flash_attention_bwd",
                                "flash_attention_bwd_f32"),
                torch.bfloat16: ("flash_attention_bwd_bf16",
                                 "flash_attention_bwd_bf16")}
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
    of the fp32 scratch tensors ("ds"; "part" when splits > 1, and at
    bf16 always, with "dq", the fp32 dQ the slabs add into); ``launch``
    the ints the C entry takes."""
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
                  sms: int, element_size: int = 4) -> BackwardPlan:
    """The launch plan of `flash_attention_bwd` for these shapes on a
    card of ``sms`` SMs. The scratch of scale dS^T, (B, Hq, query tiles,
    slab keys, 64) fp32, stays within BWD_SCRATCH_BYTES unless one key
    tile already exceeds it; the splits are the fewest (a divisor of Hq /
    Hkv) that give (b)'s first pass two blocks an SM, else Hq / Hkv. Pure
    arithmetic, so the CPU tests reach it.

    By ``element_size``: the tiles, shared memory, slabs and splits are
    the same at 2 (bf16) as at 4 (the kernels convert bf16 tiles to fp32
    as they load them); at 2 the partials' scratch "part" is there
    whatever the splits and an fp32 "dq" is added, and the last launch
    (the bf16 finish kernel) has a third row of blocks for dQ."""
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
    bf16 = element_size == 2
    n4 = max(B * Sk * Hkv, B * Sq * Hq if bf16 else 0) * hd // 4
    reduce_blocks = max(1, min(-(-n4 // BWD_THREADS), 8 * sms))
    grids = {
        "delta": ((-(-B * Sq * Hq // 4), 1, 1),),
        "dkdv": tuple((Hkv * splits, B, -(-min(slab, Sk - s * slab) // bk))
                      for s in range(n_slabs)),
        "dq": ((Hq, B, n_qt),) * n_slabs,
        "reduce": ((reduce_blocks, 3 if bf16 else 2, 1),)
        if splits > 1 or bf16 else ()}
    scratch = {"ds": (B, Hq, n_qt, slab, QUERY_TILE)}
    if splits > 1 or bf16:
        scratch["part"] = (2, splits, B, Sk, Hkv, hd)
    if bf16:
        scratch["dq"] = (B, Sq, Hq, hd)
    return BackwardPlan(
        block_keys=bk, splits=splits, slab_keys=slab, n_slabs=n_slabs,
        query_tiles=n_qt, stages=stages, grids=grids,
        smem={"dkdv": dkdv_smem, "dq": dq_smem}, scratch=scratch,
        launch=(bk, splits, slab, n_slabs, dkdv_smem, dq_smem,
                reduce_blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the mask lets through: row i sees keys j <= i
    when causal, j > i - window under a window (every key otherwise)."""
    i = torch.arange(Sq, dtype=torch.int64)
    lo = torch.zeros_like(i) if window is None else \
        (i - window + 1).clamp_min(0)
    hi = i.clamp_max(Sk - 1) if causal else torch.full_like(i, Sk - 1)
    return int((hi - lo + 1).clamp_min(0).sum())


def work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
         causal: bool, window: Optional[int], element_size: int):
    """(bytes, flops) the forward must at least move and do: q, k, v read
    once and out written once; 4 hd flops (two products) per visible
    (query, key) pair of every head (`visible_pairs`)."""
    nbytes = element_size * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd)
    return nbytes, 4 * B * Hq * hd * visible_pairs(Sq, Sk, causal, window)


def bwd_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
             causal: bool, window: Optional[int], element_size: int):
    """(bytes, flops) the backward must at least move and do: q, k, v,
    out and dout read once, lse (fp32) read once, dq, dk and dv written
    once, in ``element_size`` bytes but lse; 10 hd flops (five products)
    per visible (query, key) pair of every head."""
    nbytes, flops = work(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                         element_size)
    # `work` counts q, k, v and out: add dout, dq, dk, dv and lse
    nbytes += element_size * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd) \
        + 4 * B * Hq * Sq
    return nbytes, flops // 4 * 10


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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window):
    """(B, Sq, Sk, Hq, Hkv, hd) of inputs the kernels take, or raise."""
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise _meta.RefusedType(
            f"flash_attention: q, k and v must share one dtype, "
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
        raise _meta.RefusedValue(f"flash_attention: head_dim {hd} is not a "
                                 f"multiple of 16 up to {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim axis must be "
                         "contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if Sq and (Sk == 0 or (window is not None and Sq > Sk + window - 1)):
        raise ValueError(f"flash_attention: with Sq={Sq}, Sk={Sk}, "
                         f"window={window} some query row sees no key")
    if q.device.type not in ("cuda", "meta") or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = alignment_error(name, t.data_ptr(), t.shape, t.stride(),
                              t.element_size())
        if err:
            raise _meta.RefusedValue(err)
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
    if q.device.type == "meta":
        _meta.record("flash_attention", work(
            B, Sq, Sk, Hq, Hkv, hd, causal, window, q.element_size()),
            q.dtype)
        return out, lse
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


def _fold(info, in_dims, *tensors):
    """The vmap rule's fold: each tensor's vmapped dimension moved to the
    front (an unbatched tensor broadcast to the vmap's size) and merged
    into the batch axis, (N, B, ...) to (N * B, ...), so one launch
    serves every vmapped slice. A view where the layout allows it; the
    kernel's checks see the folded tensor as any other."""
    n = info.batch_size

    def one(t, dim):
        t = t.expand((n,) + t.shape) if dim is None else t.movedim(dim, 0)
        return t.reshape((n * t.shape[1],) + t.shape[2:])
    return tuple(one(t, d) for t, d in zip(tensors, in_dims))


def _unfold(info, t):
    """(N * B, ...) back to (N, B, ...), the vmapped dimension first."""
    return t.unflatten(0, (info.batch_size, -1))


class _Attention(torch.autograd.Function):
    """K4 under autograd: the forward launches with the row log-sum-exps
    and saves q, k, v, out and lse; the backward is
    `flash_attention_bwd`. A vmapped call reaches it in two ways: through
    `_Forward`'s vmap rule, on the folded (real) tensors, when every
    input is batched (a batched tensor reports no ``requires_grad``: the
    LM clients' attention); or directly, with its own vmap rule below,
    when an unbatched input requires grad (a k or v shared by every
    vmapped slice). Either way one forward launch and one backward call
    serve the folded batch, and the backward is recorded on it."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _forward(q, k, v, causal, window, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        out, lse = _Attention.apply(*_fold(info, in_dims[:3], q, k, v),
                                    causal, window)
        return (_unfold(info, out), _unfold(info, lse)), (0, 0)


class _Forward(torch.autograd.Function):
    """K4's forward without its LSE, for calls that take no gradient
    inside a ``torch.func`` transform (evaluation and the reward probes
    of the LM clients, the personalized prefill): one launch, as
    `_forward`. Under ``torch.func.vmap`` a batched tensor reports no
    ``requires_grad`` whatever the tensor under it needs, so a vmapped
    call whose unbatched inputs need no gradient comes here: the rule
    folds the vmapped dimension into the batch axis (`_fold`) and hands
    the folded tensors, which do report it, back to `flash_attention`. A call that trains thus
    records `_Attention` on the folded batch, one that does not launches
    this forward on it, and no batched tensor reaches ``data_ptr()``."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _forward(q, k, v, causal, window, with_lse=False)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, dout):
        raise RuntimeError("flash_attention: a gradient reached the "
                           "no-grad launch")

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        out = flash_attention(*_fold(info, in_dims[:3], q, k, v),
                              causal=causal, window=window)
        return _unfold(info, out), 0


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
    Inputs that require grad (grad mode on) go through the autograd
    Function, whose backward launches `flash_attention_bwd` at their
    dtype (fp32 or bf16). Other calls launch the forward
    directly, or, inside a ``torch.func`` transform (``vmap``), through
    `_Forward`, whose vmap rule folds the vmapped axis into the batch
    axis. Adds one to ``flash_attention.launches`` per kernel launch
    (under activation recompute, ``torch.utils.checkpoint``, the forward
    launches again in the backward pass)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window)[0]
    if torch._C._are_functorch_transforms_active():
        return _Forward.apply(q, k, v, causal, window)
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
    ``dout`` of its output: q, k and v as the forward takes them (fp32
    or bf16), ``out`` and ``lse`` the forward's
    (`flash_attention_with_lse`: out in q's dtype, lse fp32), dout (B,
    Sq, Hq, hd) in q's dtype (copied if not contiguous and 16-byte
    aligned). Returns contiguous (B, Sq, Hq, hd), (B, Sk, Hkv, hd) twice
    in q's dtype; at bf16 the gradient of the plain attention with
    `repro`'s cast points (``csrc/flash_attention_bwd.cu``). One call
    launches the kernels of `backward_plan` (the row sums D =
    rowsum(dout * out), then dk and dv with scale dS to a scratch and dq
    from it, once per slab of keys, then the sum of the head splits where
    there are several, or at bf16 the finish kernel) and adds one to
    ``flash_attention_bwd.launches`` (fp32) or
    ``flash_attention_bwd_bf16.launches`` (bf16). The scratch
    (`BackwardPlan.scratch_bytes`) lives for the call."""
    B, Sq, Sk, Hq, Hkv, hd = _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        if t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be {dtype} "
                             f"on {q.device}, got {t.dtype} on {t.device}")
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
    meta = q.device.type == "meta"
    plan = backward_plan(B, Sq, Sk, Hq, Hkv, hd, _meta.target_sms() if meta
                         else _sm_count(q.device.index), q.element_size())
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ds = torch.empty(plan.scratch["ds"], dtype=torch.float32,
                     device=q.device)
    part, dq32 = (torch.empty(plan.scratch[name], dtype=torch.float32,
                              device=q.device)
                  if name in plan.scratch else None
                  for name in ("part", "dq"))
    if meta:
        _meta.record("flash_attention_bwd", bwd_work(
            B, Sq, Sk, Hq, Hkv, hd, causal, window, q.element_size()),
            q.dtype)
        return dq, dk, dv
    strides = _strides(q, k, v)
    launch = (ctypes.c_int * len(plan.launch))(*plan.launch)
    library, symbol = _BWD_ENTRIES[q.dtype]
    lib_fn = _build.entry(library, symbol, _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(library, lib_fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ds.data_ptr(),
        None if part is None else part.data_ptr(),
        None if dq32 is None else dq32.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
        ctypes.addressof(strides), int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        ctypes.addressof(launch), q.device.index, stream))
    if q.dtype == torch.bfloat16:
        flash_attention_bwd_bf16.launches += 1
    else:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd_bf16(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None):
    """`flash_attention_bwd` on bf16 inputs only (the library built with
    FA_BWD_BF16), whose calls ``flash_attention_bwd_bf16.launches``
    counts; any other dtype raises ``TypeError``."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd_bf16: bf16 inputs, got "
                        f"{q.dtype}")
    return flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                               window=window)


#: kernel launches since the last reset (plain ints; chip_smoke.py zeroes
#: them before driving the main path and reads them after): forward
#: launches (the autograd Function's included), and backward calls (the
#: kernels of `backward_plan` each) of the fp32 and the bf16 library
flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_bf16.launches = 0
