"""CUDA kernel wrappers for the Mamba2 chunked SSD scan (K5) and its
backward.

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

On inputs that require grad (grad mode on), `ssd` is a
``torch.autograd.Function``: its forward keeps the workspaces ``cum`` and
``states`` (16.8 MB at mamba2-370m's train shape), and its backward is
`ssd_bwd` (``csrc/ssd_bwd.cu``, six launches with the grids and shared
memory of `backward_plan`: dh_in terms and scores; the reverse state
pass; the state terms of dC and dB summed over groups of heads; dx, two
heads a block; W per group of heads; dC, dB and d dlogA. No Pallas
counterpart: `repro` differentiates its oracle), whose plain version is
`repro_torch.kernels.ref.ssd_bwd_ref`.

Under ``torch.func.vmap`` (`repro_torch.fl.engine.vmap_clients`, the LM
clients) the autograd Function folds the vmapped axis into b (the rules
of `flash_attention`'s `_fold` and `_unfold`), so one op serves every
vmapped slice. Each op's launches lie in the span ``k5`` and each
backward's in ``k5_bwd`` (`repro_torch.obs`), and the counters
``k5.calls``, ``k5.tokens`` and ``k5.seqs.l<l>`` (``k5_bwd.*`` the same)
add 1, b l and, under the call's own length l, b: each call's (b, l) as
far as its work goes, which at one length is linear in b (`work`,
`bwd_work`).

The wrappers launch their kernels on CUDA tensors, or raise: they never
fall back to a plain version (`repro_torch.kernels.ops.ssd` picks the
plain version, which autograd differentiates, for CPU tensors only). On
"meta" tensors they run the checks and allocate what a launch allocates
(the outputs and both ops' workspaces), and launch nothing
(`repro_torch.kernels.meta`). `work` and `bwd_work` are the bytes and
operations of one op.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from .. import obs as _obs
from . import _build
from . import meta as _meta

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
# the backward's: x, B, C, dy, dh_last, cum, states; dx, d dlogA, dB, dC,
# dh0; the workspaces (an array of pointers); b, l, H, p, n, L, groups,
# has_h0, vec; strides; grid; device; stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 9 + (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
#: heads whose W a block of the backward sums (csrc/ssd_bwd.cu kGroupHeads)
BWD_GROUP_HEADS = 8
#: heads whose state terms a state block of the backward sums
#: (csrc/ssd_bwd.cu kStateHeads)
BWD_STATE_HEADS = 8
#: a block of the backward's state, dx and W kernels (a dx block's two
#: halves of 128 threads take one head each of a pair)
BWD_MAIN_THREADS = 256
#: columns of n a state block, or a dC / dB block of the final kernel,
#: takes (csrc/ssd_bwd.cu kNH)
BWD_COLS = 64
#: the backward's workspaces, in the order the C entry takes them
BWD_WORKSPACES = ("dst", "sc", "bt", "lam", "wp", "mp", "sd", "sv")


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


@functools.lru_cache(maxsize=64)
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
            raise _meta.RefusedValue(
                f"ssd: the {name} kernel's grid of {gx} blocks "
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


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The launches of one backward (``csrc/ssd_bwd.cu``): p padded to
    ``pw``, ``nc`` chunks of ``nt`` 64-row tiles and ``ntri`` causal tile
    pairs, ``groups`` head groups of `BWD_GROUP_HEADS`, ``ny`` pass blocks
    a (b, head), ``nh`` blocks of `BWD_COLS` columns of n, ``hp`` head
    pairs, ``sg`` head groups of `BWD_STATE_HEADS`; per kernel its grid
    and its dynamic shared memory in bytes; the workspace shapes
    (float32, in `BWD_WORKSPACES` order); ``launch``, the twelve launch
    values ``ssd_bwd_f32`` takes."""
    pw: int
    nc: int
    nt: int
    ntri: int
    groups: int
    ny: int
    nh: int
    hp: int
    sg: int
    grids: dict
    smem: dict
    workspace: dict
    launch: tuple

    def scratch_bytes(self) -> int:
        """Bytes of the workspaces, each at a 16-byte boundary."""
        return sum(-(-math.prod(s) // 4) * 16
                   for s in self.workspace.values())


def backward_smem(p: int) -> dict:
    """Dynamic shared memory, in bytes, that a block of each backward
    kernel is launched with: what ``csrc/ssd_bwd.cu`` carves out, which
    depends on p's padding alone. ``chunk``: the larger of a dh_in block's
    C and dy tiles two stages deep and a scores block's C and B tiles;
    ``state``: two stages of a dy or x tile, a tile of h_in^T or g^T rows
    and the rows' cum; ``dx``: two stages of one shared A tile and each
    half's X tile and cum, the halves' key cum; ``w``: the pair's score
    tile, the warps' column sums, the tile the halves exchange, two stages
    of dy and x tiles with both rows' cum; ``final``: a dC / dB block's W
    tile and B or C rows."""
    pw = 64 if p <= 64 else 128
    T, N, warps = TILE, MAX_STATE, THREADS // 32
    gp, cp, fp = T + 4, N + 4, pw + 4
    state = 2 * (2 * T * fp + T)
    dx = 2 * T * gp + 4 * T * pw + 4 * T + 2 * T
    w = 2 * T * (T + 8) + (BWD_MAIN_THREADS // 32) * T + \
        2 * (2 * T * fp + 2 * T)
    return {"chunk": 4 * max(2 * T * N + 2 * T * pw, 2 * T * cp),
            "state": 4 * state, "dx": 4 * dx, "w": 4 * w,
            "final": 4 * max(T * gp + T * BWD_COLS, warps)}


@functools.lru_cache(maxsize=64)
def backward_plan(b: int, l: int, H: int, p: int, n: int,
                  L: int) -> BackwardPlan:
    """The six launches of a backward of these shapes (L the chunk
    length, l a multiple of it), as ``csrc/ssd_bwd.cu`` decodes them:
    ``chunk`` (b H nc dh_in blocks, then b nc ntri score blocks),
    ``pass`` ((b H, ny)), ``state`` (2 b nc nt sg nh blocks), ``dx`` (b nc
    nt hp blocks), ``w`` (b nc ntri groups blocks), ``final`` (2 nh b nc
    nt dC / dB blocks, then b H nc d dlogA blocks); each kernel's
    shared memory (`backward_smem`); the workspaces, none of them
    (b, l, H, n): ``sd`` (2, sg, b, l, n) holds dC's and dB's state
    terms summed over each group of `BWD_STATE_HEADS` heads, ``sv``
    (b, H, l, 2, nh) each head's dcum state terms by kind and column
    block. Raises ``ValueError``
    where a grid would exceed CUDA's extent."""
    pw = 64 if p <= 64 else 128
    nc = l // L
    nt = -(-L // TILE)
    ntri = nt * (nt + 1) // 2
    groups = -(-H // BWD_GROUP_HEADS)
    ny = -(-n * pw // (PASS_THREADS * PASS_VALUES))
    nh = -(-n // BWD_COLS)
    hp = -(-H // 2)
    sg = -(-H // BWD_STATE_HEADS)
    grids = {"chunk": (b * H * nc + b * nc * ntri, 1), "pass": (b * H, ny),
             "state": (2 * b * nc * nt * sg * nh, 1),
             "dx": (b * nc * nt * hp, 1), "w": (b * nc * ntri * groups, 1),
             "final": (2 * nh * b * nc * nt + b * H * nc, 1)}
    for name, (gx, _) in grids.items():
        if gx > MAX_GRID_X:
            raise _meta.RefusedValue(
                f"ssd_bwd: the {name} kernel's grid of {gx} "
                f"blocks is more than CUDA takes ({MAX_GRID_X})")
    T = TILE
    smem = backward_smem(p)
    work = {"dst": (b, nc, H, n, pw), "sc": (b, nc, ntri, T, T),
            "bt": (b, nc, nt, n, T), "lam": (b, H, nc, ny),
            "wp": (b, nc, groups, ntri, T, T), "mp": (b, nc, ntri, H, 2, T),
            "sd": (2, sg, b, l, n), "sv": (b, H, l, 2, nh)}
    return BackwardPlan(
        pw=pw, nc=nc, nt=nt, ntri=ntri, groups=groups, ny=ny, nh=nh, hp=hp,
        sg=sg, grids=grids, smem=smem,
        workspace={k: work[k] for k in BWD_WORKSPACES},
        launch=(grids["chunk"][0], smem["chunk"], *grids["pass"],
                *(v for k in ("state", "dx", "w", "final")
                  for v in (grids[k][0], smem[k]))))


def backward_flops(b: int, l: int, H: int, p: int, n: int, L: int,
                   with_h0: bool, with_dh_last: bool) -> dict:
    """The least flops of K5's backward (2 per multiply-add), by part:
    per head, dx's scores times dy and W's dy . x over the causal pairs;
    the (L, p, n) products of dx's state term and w in every chunk a
    gradient leaves (all but the last without dh_last), of v in every
    chunk a state enters (all but the first without h0), and of the
    chunk's dh_in term in every chunk whose dh_in is needed (all but the
    first without h0); once per (b, chunk), the scores and the W products
    of dB and dC (B and C are shared by the heads)."""
    nc = l // L
    pairs = L * (L + 1) // 2
    g_chunks = nc - 1 + int(with_dh_last)
    h_chunks = nc - 1 + int(with_h0)
    state = b * H * L * 2 * n * p
    parts = {"scores": b * nc * pairs * 2 * n,
             "dx": b * H * nc * pairs * 2 * p,
             "W": b * H * nc * pairs * 2 * p,
             "dx_state": state * g_chunks, "w": state * g_chunks,
             "v": state * h_chunks, "dh_in": state * h_chunks,
             "dB_dC": 2 * b * nc * pairs * 2 * n}
    return {**parts, "total": sum(parts.values())}


def work(b: int, l: int, H: int, p: int, n: int, chunk: int,
         with_h0: bool):
    """(bytes, flops) the forward must at least move and do: x, dlogA, B,
    C (and h0) read once, y and h_last written once; the scores C_i . B_j
    of the causal pairs once per (b, chunk), since B and C are shared by
    the heads (2n each), then per head the scores times X (2p per pair),
    the state update (2 L n p per chunk) and the carried-in C h^T (2 L n p
    per chunk that receives a state: all but the first without h0)."""
    L = min(chunk, l)
    c = l // L
    pairs = L * (L + 1) // 2
    carried = c - (0 if with_h0 else 1)
    flops = (b * c * pairs * 2 * n
             + b * H * (c * pairs * 2 * p + c * 2 * L * n * p
                        + carried * 2 * L * n * p))
    nbytes = 4 * (2 * b * l * H * p + b * l * H + 2 * b * l * n
                  + (2 if with_h0 else 1) * b * H * p * n)
    return nbytes, flops


def bwd_work(b: int, l: int, H: int, p: int, n: int, chunk: int,
             with_h0: bool, with_dh_last: bool):
    """(bytes, flops) the backward must at least move and do: x, B, C,
    dy, the forward's cum and states (and dh_last) read once; dx, d
    dlogA, dB and dC (and dh0) written once; `backward_flops`."""
    L = min(chunk, l)
    state = b * H * p * n
    states = math.prod(launch_plan(b, l, H, p, n, L).workspace["states"])
    nbytes = 4 * (3 * b * l * H * p + 4 * b * l * n + 2 * b * l * H +
                  states + (state if with_dh_last else 0) +
                  (state if with_h0 else 0))
    return nbytes, backward_flops(b, l, H, p, n, L, with_h0,
                                  with_dh_last)["total"]


def aligned16(t: torch.Tensor, dims) -> bool:
    """Whether ``t``'s base address and its strides along ``dims`` (those
    of extent > 1) are multiples of 16 bytes: the kernels' 16-byte
    copies need both."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 4 == 0 for d in dims if t.shape[d] > 1)


def ssd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dlogA: (b, l, h); B, C: (b, l, n); h0: (b, h, p, n)
    or None. All float32 on one CUDA device; the last axis of x, B and C
    contiguous (other strides are read as they are, at any alignment).
    p <= 128; n a multiple of 4 up to 128; l a multiple of L = min(chunk,
    l). Returns (y (b, l, h, p), h_last (b, h, p, n)), float32. bf16 is
    refused: a bf16 model casts the scan's inputs to float32, as
    `repro`'s does (``models/ssm.py``), so bf16 training needs no bf16
    scan (``csrc/ssd.cu``). The
    workspaces hold about b l (H + (L + 64) / 2 + n + H n pw / L) floats:
    11 MB at mamba2-370m's serve shape. Inputs that require grad (grad
    mode on), and every call inside a ``torch.func`` transform
    (``vmap``), go through the autograd Function, whose backward launches
    `ssd_bwd` and whose rule folds the vmapped axis into b. Adds one
    to ``ssd.launches`` per op (three kernel launches; under activation
    recompute the forward runs again in the backward pass)."""
    if torch._C._are_functorch_transforms_active() or (
            torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                            for t in (x, dlogA, B, C, h0))):
        return _Scan.apply(x, dlogA, B, C, h0, chunk)[:2]
    return _forward(x, dlogA, B, C, chunk, h0)[:2]


def ssd_with_work(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int = 256,
                  h0: Optional[torch.Tensor] = None):
    """The forward launch the autograd Function makes, outside autograd:
    (y, h_last, cum, states), the last two the workspaces `ssd_bwd`
    takes (``cum`` (b, H, l), ``states`` (b, nc, H, n, pw), slot c the
    state entering chunk c). Adds one to ``ssd.launches``."""
    return _forward(x, dlogA, B, C, chunk, h0)


def _check(x, dlogA, B, C, chunk, h0):
    """(b, l, H, p, n, L) of inputs the kernels take, or raise."""
    tensors = (x, dlogA, B, C) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise _meta.RefusedType(
            f"ssd: x, dlogA, B, C and h0 must be float32, got "
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
        raise _meta.RefusedValue(f"seq {l} not divisible by chunk {L}")
    if not 0 < p <= MAX_HEAD_DIM:
        raise _meta.RefusedValue(
            f"ssd: head_dim {p} is not in 1..{MAX_HEAD_DIM}")
    if n % 4 or not 0 < n <= MAX_STATE:
        raise _meta.RefusedValue(
            f"ssd: state {n} is not a multiple of 4 up to "
            f"{MAX_STATE}")
    launch_plan(b, l, H, p, n, L)   # raises for a grid past CUDA's
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd: the last axis of x, B and C must be "
                         "contiguous")
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device
                                                    for t in tensors):
        raise ValueError(f"ssd kernel needs every input on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    return b, l, H, p, n, L


def _count(name: str, b: int, l: int):
    """The op's call, its tokens, and its b under its length l
    (`repro_torch.obs`)."""
    _obs.count(name + ".calls")
    _obs.count(name + ".tokens", b * l)
    _obs.count(f"{name}.seqs.l{l}", b)


def _forward(x, dlogA, B, C, chunk, h0):
    """Launch the forward; returns (y, h_last, cum, states), the last two
    None where there is no block to launch."""
    b, l, H, p, n, L = _check(x, dlogA, B, C, chunk, h0)
    plan = launch_plan(b, l, H, p, n, L)
    dev = x.device
    y = torch.empty((b, l, H, p), dtype=x.dtype, device=dev)
    h_last = torch.empty((b, H, p, n), dtype=x.dtype, device=dev)
    if y.numel() == 0:   # b or H is 0: no block to launch
        return y, h_last, None, None
    # one allocation for the four workspaces, each at a 16-byte boundary
    sizes = [math.prod(plan.workspace[k])
             for k in ("cum", "scores", "ct", "states")]
    starts = [sum(-(-m // 4) * 4 for m in sizes[:i]) for i in range(4)]
    work_ = torch.empty(starts[-1] + sizes[-1], dtype=torch.float32,
                        device=dev)
    h0c = None if h0 is None else h0.contiguous()
    if dev.type == "meta":
        _meta.record("ssd", work(b, l, H, p, n, L, h0 is not None), x.dtype)
        return y, h_last, *_views(work_, starts, sizes, plan)
    vec = int(aligned16(x, (0, 1, 2)) and aligned16(B, (0, 1)) and
              aligned16(C, (0, 1)))
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dlogA.stride(0), dlogA.stride(1), dlogA.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    with _obs.span("k5"):
        lib_fn = _build.entry("ssd", "ssd_f32", _ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check("ssd", lib_fn(
            x.data_ptr(), dlogA.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0c is None else h0c.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), *(work_.data_ptr() + 4 * i for i in starts),
            b, l, H, p, n, L, vec, strides,
            (ctypes.c_int * 6)(*plan.launch), dev.index, stream))
    _count("k5", b, l)
    ssd.launches += 1
    return (y, h_last, *_views(work_, starts, sizes, plan))


def _views(work_, starts, sizes, plan):
    """(cum, states): the workspaces the backward takes, as views of the
    forward's one allocation."""
    return (work_[starts[0]:starts[0] + sizes[0]].view(
        plan.workspace["cum"]), work_[starts[3]:starts[3] + sizes[3]].view(
        plan.workspace["states"]))


def _fold(info, in_dims, *tensors):
    """The vmap rule's fold (`flash_attention._fold`): each tensor's
    vmapped dimension moved to the front (an unbatched tensor broadcast
    to the vmap's size) and merged into b, (N, b, ...) to (N b, ...); a
    None stays None."""
    n = info.batch_size

    def one(t, dim):
        if t is None:
            return None
        t = t.expand((n,) + t.shape) if dim is None else t.movedim(dim, 0)
        return t.reshape((n * t.shape[1],) + t.shape[2:])
    return tuple(one(t, d) for t, d in zip(tensors, in_dims))


def _unfold(info, t):
    """(N b, ...) back to (N, b, ...), the vmapped dimension first; None
    stays None."""
    return None if t is None else t.unflatten(0, (info.batch_size, -1))


class _Scan(torch.autograd.Function):
    """K5 under autograd: the forward saves x, dlogA, B and C (as the views
    they arrive as), h0 and its workspaces ``cum`` and ``states`` (outputs
    that take no gradient); the backward is `ssd_bwd`. An unused h_last
    arrives as None (no zeros are made for it). Every call inside a
    ``torch.func`` transform comes here, since a batched tensor reports no
    ``requires_grad`` (the LM clients' scans): the rule below folds the
    vmapped axis into b and applies the Function again on the folded
    (real) tensors, which do report it. Under grad mode one forward and
    one backward thus serve the folded batch, and the backward is
    recorded on it; without grad (the clients' evaluation and reward
    probes) the forward alone runs on it, and the workspaces go with the
    discarded outputs. No batched tensor reaches ``data_ptr()``."""

    @staticmethod
    def forward(x, dlogA, B, C, h0, chunk):
        return _forward(x, dlogA, B, C, chunk, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dlogA, B, C, h0, chunk = inputs
        _, _, cum, states = output
        ctx.mark_non_differentiable(*(t for t in (cum, states)
                                      if t is not None))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dlogA, B, C, h0, cum, states)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dh_last, _dcum, _dstates):
        x, dlogA, B, C, h0, cum, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_bwd(x, dlogA, B, C, ctx.chunk, h0, dy, dh_last, cum,
                        states)
        return grads + (None,)

    @staticmethod
    def vmap(info, in_dims, x, dlogA, B, C, h0, chunk):
        out = _Scan.apply(*_fold(info, in_dims[:5], x, dlogA, B, C, h0),
                          chunk)
        return tuple(_unfold(info, t) for t in out), (0, 0, 0, 0)


def ssd_bwd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor],
            dy: torch.Tensor, dh_last: Optional[torch.Tensor],
            cum: torch.Tensor, states: torch.Tensor
            ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, d dlogA, dB, dC, dh0) of `ssd` at (x, dlogA, B, C, h0) for the
    gradients ``dy`` (b, l, h, p) of y and ``dh_last`` (b, h, p, n) of
    h_last (None: zeros, with no launch to make them): x, dlogA, B, C and
    h0 as the forward took them (dlogA is checked, not read), ``cum`` and
    ``states`` its workspaces (`ssd_with_work`). dy and dh_last are copied
    if not contiguous. Returns contiguous float32 tensors of the inputs'
    shapes; dh0 is None when h0 is. One call launches the six kernels of
    `backward_plan` and adds one to ``ssd_bwd.launches``; its workspaces
    (`BackwardPlan.scratch_bytes`: 53 MB at mamba2-370m's train shape)
    live for the call."""
    b, l, H, p, n, L = _check(x, dlogA, B, C, chunk, h0)
    plan = backward_plan(b, l, H, p, n, L)
    dev = x.device
    for name, t, shape in (("dy", dy, (b, l, H, p)),
                           ("dh_last", dh_last, (b, H, p, n)),
                           ("cum", cum, (b, H, l)),
                           ("states", states, (b, plan.nc, H, n, plan.pw))):
        if t is not None and (tuple(t.shape) != shape or
                              t.dtype != torch.float32 or t.device != dev):
            raise ValueError(f"ssd_bwd: {name} must be float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not (cum.is_contiguous() and states.is_contiguous()):
        raise ValueError("ssd_bwd: cum and states must be the forward's "
                         "(contiguous)")
    dx = torch.empty((b, l, H, p), dtype=x.dtype, device=dev)
    ddlogA = torch.empty((b, l, H), dtype=x.dtype, device=dev)
    dB = torch.empty((b, l, n), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    dh0 = torch.empty((b, H, p, n), dtype=x.dtype, device=dev) \
        if h0 is not None else None
    if dx.numel() == 0:   # b or H is 0: no block to launch
        return dx, ddlogA, dB.zero_(), dC.zero_(), dh0
    dy = dy.contiguous()
    dhl = None if dh_last is None else dh_last.contiguous()
    sizes = [math.prod(plan.workspace[k]) for k in BWD_WORKSPACES]
    starts = [sum(-(-m // 4) * 4 for m in sizes[:i])
              for i in range(len(sizes))]
    work_ = torch.empty(starts[-1] + sizes[-1], dtype=torch.float32,
                        device=dev)
    if dev.type == "meta":
        _meta.record("ssd_bwd", bwd_work(b, l, H, p, n, L, h0 is not None,
                                         dh_last is not None), x.dtype)
        return dx, ddlogA, dB, dC, dh0
    ptrs = (ctypes.c_void_p * len(starts))(
        *(work_.data_ptr() + 4 * i for i in starts))
    vec = int(aligned16(x, (0, 1, 2)) and aligned16(B, (0, 1)) and
              aligned16(C, (0, 1)) and aligned16(dy, (0, 1, 2)))
    strides = (ctypes.c_longlong * 7)(
        x.stride(0), x.stride(1), x.stride(2), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1))
    grid = (ctypes.c_int * len(plan.launch))(*plan.launch)
    with _obs.span("k5_bwd"):
        lib_fn = _build.entry("ssd_bwd", "ssd_bwd_f32", _BWD_ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check("ssd_bwd", lib_fn(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            None if dhl is None else dhl.data_ptr(), cum.data_ptr(),
            states.data_ptr(), dx.data_ptr(), ddlogA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(),
            None if dh0 is None else dh0.data_ptr(),
            ctypes.addressof(ptrs), b, l, H, p, n, L, plan.groups,
            int(h0 is not None), vec, ctypes.addressof(strides),
            ctypes.addressof(grid), dev.index, stream))
    _count("k5_bwd", b, l)
    ssd_bwd.launches += 1
    return dx, ddlogA, dB, dC, dh0


#: ops since the last reset (plain ints; chip_smoke.py zeroes them before
#: driving the main path and reads them after): one per three-launch
#: forward (the autograd Function's included), one per six-launch
#: backward
ssd.launches = 0
ssd_bwd.launches = 0
