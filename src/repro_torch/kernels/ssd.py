"""CUDA kernel wrapper for the Mamba2 chunked SSD scan (K5).

Computes what `repro_torch.kernels.ref.ssd_ref` computes: x (b, l, h, p)
already scaled by dt, dlogA (b, l, h), B and C (b, l, n) shared by every
head, an optional h0 (b, h, p, n); returns y (b, l, h, p) and h_last
(b, h, p, n). Port of the Pallas TPU kernel ``repro/kernels/ssd.py::
ssd``; the kernels, their bound and their design are described in
``csrc/ssd.cu``.

One op is three launches on the current stream, the chunks in parallel,
with the grids and shared memory of `launch_plan` (the kernels launch
with these values and decode their blocks from them):

1. ``ssd_chunk_kernel``: per (b, head, chunk) the prefix sums of dlogA
   and the chunk's own state contribution; per (b, chunk, causal pair of
   64-row tiles) the scores C Bᵀ, once for all heads (and C transposed);
2. ``ssd_pass_kernel``: the states passed along the chunks (in place),
   and h_last;
3. ``ssd_output_kernel``: per (b, head, chunk, 64-row query tile)
   e^{cum} C hᵀ where a state enters the chunk, plus the decayed, masked
   scores times x.

x, B and C are read in place through their strides. Where each has a
16-byte aligned base address and row strides the kernels copy them in
16-byte pieces, else in 4-byte pieces (`aligned16`): a misaligned input
is neither refused nor copied on the host.

The wrapper launches the kernels on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.ssd` picks the
plain version for CPU tensors only).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 7 + (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
MAX_HEAD_DIM = 128   # p
MAX_STATE = 128      # n, a multiple of 4
#: shared memory a block may opt in to on Hopper (227 KB)
MAX_SMEM = 232448
#: the largest x extent of a CUDA grid
MAX_GRID_X = 2 ** 31 - 1
THREADS = 128        # a block of ssd_chunk_kernel or ssd_output_kernel
PASS_THREADS = 256   # a block of ssd_pass_kernel
TILE = 64            # rows of a query or key tile
PASS_VALUES = 8      # state values a thread of ssd_pass_kernel carries


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launches of one op (``csrc/ssd.cu``): p padded to ``pw`` (64 or
    128), ``nc`` chunks of ``nt`` 64-row tiles, ``ntri`` causal tile pairs
    a chunk; per kernel its grid and its dynamic shared memory in bytes;
    the workspace shapes (float32); ``launch``, the six launch values
    ``ssd_f32`` takes."""
    pw: int
    nc: int
    nt: int
    ntri: int
    grids: dict
    smem: dict
    workspace: dict
    launch: tuple


def smem_bytes(p: int) -> dict:
    """Dynamic shared memory, in bytes, that a block of ``ssd_chunk_kernel``
    and of ``ssd_output_kernel`` is launched with: what the kernels carve
    out of it (``csrc/ssd.cu``), which depends on p's padding alone.
    ``chunk``: the larger of a state block's (``chunk_state``: B and x
    tiles two stages deep, the scan's warp totals and its last sum) and a
    scores block's (``chunk_scores``: C and B tiles, rows padded to n + 4
    floats); ``output``: transposed score tiles (rows padded to 68 floats)
    and x tiles two stages deep, the query and key prefix sums.
    ``ssd_pass_kernel`` has only its static 8 KB transpose tile."""
    pw = 64 if p <= 64 else 128
    n, warps = MAX_STATE, THREADS // 32
    state = 2 * TILE * n + 2 * TILE * pw + warps + 1
    scores = 2 * TILE * (n + 4)
    output = 2 * TILE * (TILE + 4) + 2 * TILE * pw + 3 * TILE
    return {"chunk": 4 * max(state, scores), "output": 4 * output}


def launch_plan(b: int, l: int, H: int, p: int, n: int, L: int) -> Plan:
    """The three launches for an op of these shapes (L the chunk length,
    l a multiple of it): grids as ``(x, y)``, shared memory, and the
    workspaces (``cum`` (b, H, l); ``scores`` (b, nc, ntri, 64, 64), each
    tile key rows by query columns; ``ct``, C transposed by query tile,
    (b, nc, nt, n, 64); ``states`` (b, nc, H, n, pw)). Raises
    ``ValueError`` where a grid would exceed CUDA's extent."""
    pw = 64 if p <= 64 else 128
    nc = l // L
    nt = -(-L // TILE)
    ntri = nt * (nt + 1) // 2
    grids = {"chunk": (b * H * nc + b * nc * ntri, 1),
             "pass": (b * H, -(-n * pw // (PASS_THREADS * PASS_VALUES))),
             "output": (b * H * nc * nt, 1)}
    for name, (gx, _) in grids.items():
        if gx > MAX_GRID_X:
            raise ValueError(f"ssd: the {name} kernel's grid of {gx} blocks "
                             f"is more than CUDA takes ({MAX_GRID_X})")
    smem = smem_bytes(p)
    return Plan(pw=pw, nc=nc, nt=nt, ntri=ntri, grids=grids, smem=smem,
                workspace={"cum": (b, H, l),
                           "scores": (b, nc, ntri, TILE, TILE),
                           "ct": (b, nc, nt, n, TILE),
                           "states": (b, nc, H, n, pw)},
                launch=(grids["chunk"][0], smem["chunk"], *grids["pass"],
                        grids["output"][0], smem["output"]))


def kernel_flops(b: int, l: int, H: int, p: int, n: int, L: int,
                 with_h0: bool) -> dict:
    """Flops the kernels are modelled to do (2 per fmaf; not counted on
    the card), by part, as ``csrc/ssd.cu`` does them at p's padding: the
    scores over whole 64 x 64 tiles of every causal pair; the states over
    whole key tiles; the scores times x over whole key tiles off the
    diagonal and, on it, each warp's keys up to its last row (16-row
    steps); C hᵀ where a state enters a chunk (every chunk but the first,
    or every chunk with h0)."""
    plan = launch_plan(b, l, H, p, n, L)
    pw, nc, nt = plan.pw, plan.nc, plan.nt
    # (row, key) pairs of a diagonal tile: each warp's 16 rows run to the
    # warp's last row
    diag_keys = sum(min(TILE, 16 * (w + 1)) * 16
                    for w in range(THREADS // 32))
    scores = b * nc * plan.ntri * TILE * TILE * n * 2
    states = b * H * nc * nt * TILE * pw * MAX_STATE * 2
    off = nt * (nt - 1) // 2
    intra = b * H * nc * (off * TILE * TILE + nt * diag_keys) * pw * 2
    carried = b * H * (nc if with_h0 else nc - 1) * nt * TILE * n * pw * 2
    return {"scores": scores, "states": states, "intra": intra,
            "carried": carried,
            "total": scores + states + intra + carried}


def aligned16(t: torch.Tensor, dims) -> bool:
    """Whether ``t``'s base address and its strides along ``dims`` (those
    of extent > 1) are multiples of 16 bytes: the kernels' 16-byte
    copies need both."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 4 == 0 for d in dims if t.shape[d] > 1)


def check_no_grad(*tensors: Optional[torch.Tensor]):
    """K5 has no backward (nor has the Pallas kernel): refuse inputs that
    require grad rather than return a result autograd cannot follow."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd has no backward yet: SSM and hybrid LM training is ROADMAP "
            "Queue 1 item 14d-2; call it under torch.no_grad() or "
            "torch.inference_mode()")


def ssd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dlogA: (b, l, h); B, C: (b, l, n); h0: (b, h, p, n)
    or None. All float32 on one CUDA device; the last axis of x, B and C
    contiguous (other strides are read as they are, at any alignment).
    p <= 128; n a multiple of 4 up to 128; l a multiple of L = min(chunk,
    l). Returns (y (b, l, h, p), h_last (b, h, p, n)), float32. bf16 is
    refused: the model casts the scan's inputs to float32
    (``csrc/ssd.cu``). The workspaces hold about b l (H + (L + 64) / 2 +
    n + H n pw / L) floats: 11 MB at mamba2-370m's serve shape. Adds one
    to ``ssd.launches`` per op (three kernel launches)."""
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
    plan = launch_plan(b, l, H, p, n, L)
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd: the last axis of x, B and C must be "
                         "contiguous")
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise ValueError(f"ssd kernel needs every input on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    dev = x.device
    y = torch.empty((b, l, H, p), dtype=x.dtype, device=dev)
    h_last = torch.empty((b, H, p, n), dtype=x.dtype, device=dev)
    if y.numel() == 0:   # b or H is 0: no block to launch
        return y, h_last
    # one allocation for the four workspaces, each at a 16-byte boundary
    sizes = [math.prod(plan.workspace[k])
             for k in ("cum", "scores", "ct", "states")]
    starts = [sum(-(-m // 4) * 4 for m in sizes[:i]) for i in range(4)]
    work = torch.empty(starts[-1] + sizes[-1], dtype=torch.float32,
                       device=dev)
    h0c = None if h0 is None else h0.contiguous()
    vec = int(aligned16(x, (0, 1, 2)) and aligned16(B, (0, 1)) and
              aligned16(C, (0, 1)))
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dlogA.stride(0), dlogA.stride(1), dlogA.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    lib_fn = _build.entry("ssd", "ssd_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("ssd", lib_fn(
        x.data_ptr(), dlogA.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0c is None else h0c.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), *(work.data_ptr() + 4 * i for i in starts),
        b, l, H, p, n, L, vec, strides, (ctypes.c_int * 6)(*plan.launch),
        dev.index, stream))
    ssd.launches += 1
    return y, h_last


#: ops since the last reset, one per three-launch op (a plain int;
#: chip_smoke.py zeroes it before driving the main path and reads it
#: after)
ssd.launches = 0
