"""CUDA kernel wrapper for PaperCNN's convolution stack (K7).

Computes, for G models at once, each model's conv1 -> bias -> ReLU ->
2x2 max-pool -> conv2 -> bias -> ReLU -> 2x2 max-pool over its batch of
NHWC images, flattened in NHWC order: the (G, B, flat) features that
`repro_torch.models.classifier.PaperCNN` hands to its dense layers. It
replaces no TPU kernel (`repro` leaves the convolutions to XLA): it runs
the models' inference forwards, the greedy's reward probes first among
them; the kernel, its bound and its design are described in
``csrc/cnn_features.cu``. Its plain version is
`repro_torch.kernels.ref.cnn_features_ref` (grouped cuDNN convolutions
on the card, the CPU's on the CPU).

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops.cnn_features`
picks the plain version for CPU tensors only). On "meta" tensors it runs
the checks and allocates the output, and launches nothing
(`repro_torch.kernels.meta`). `work` is the bytes and operations of one
call, `launch_plan` the kernel's tiles and shared-memory carve-up.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import obs as _obs
from . import _build
from . import meta as _meta

_ARGTYPES = ((ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong)
             + (ctypes.c_void_p, ctypes.c_longlong) * 4
             + (ctypes.c_void_p,) + (ctypes.c_int,) * 17 + (ctypes.c_void_p,))
#: the (input channels, conv1 channels, conv2 channels) the library is
#: built for: PaperCNN's (3, 6, 16), the tests' narrow (4, 8), and one
#: input channel of each
KERNELS = ((3, 6, 16), (3, 4, 8), (1, 6, 16), (1, 4, 8))
#: the most images a block takes
TILE_IMAGES = 4
#: shared memory a block may ask for (H100: 227 KB), and the most with
#: which two blocks share an SM (its 228 KB, less 1 KB a block)
MAX_SMEM = 232_448
PAIR_SMEM = 115_712
#: the grid's y extent (tiles of a model's images)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    """One launch's tiling and shared-memory carve-up, in floats where not
    said: ``tiles`` blocks along a model's images, each of at most
    ``tile_images``; a staged input row ``rs`` and image ``is_``; the
    pooled conv1 maps' rows ``rs2``, channel planes ``cs2`` and images
    ``is2``; ``smem_bytes`` a block."""
    tiles: int
    tile_images: int
    rs: int
    is_: int
    rs2: int
    cs2: int
    is2: int
    smem_bytes: int


def pooled(H: int, W: int):
    """((p1h, p1w), (p2h, p2w)): the sizes after each conv5 + pool, which
    floors as ``max_pool2d``."""
    p1h, p1w = (H - 4) // 2, (W - 4) // 2
    return (p1h, p1w), ((p1h - 4) // 2, (p1w - 4) // 2)


def _at_least(least: int, residue: int, modulus: int) -> int:
    """The smallest s >= ``least`` with s = ``residue`` (mod ``modulus``)."""
    return least + (residue - least) % modulus


def weight_floats(cin: int, c1: int, c2: int) -> int:
    """Floats of a model's staged weights (csrc: Shape::WEIGHTS): conv1's
    taps padded to a multiple of 4 channels, its bias likewise."""
    c1p = -(-c1 // 4) * 4
    return 25 * cin * c1p + c1p + 25 * c1 * c2 + c2


def launch_plan(B: int, H: int, W: int, cin: int, c1: int,
                c2: int) -> Plan:
    """The kernel's plan for B images of H x W x cin a model. Thread k of
    a block's conv1 pass owns the k-th (image, pooled pixel) and reads
    its rows as 8-byte words; the staged rows and images are padded so
    that thread k's words start at word 2 cin k (mod 32), whatever row
    or image it is on: 16 threads of a half-warp then hit 32 distinct
    banks (when cin p1w is even; else rows are only kept even). conv2's
    pooled planes are padded the same way for its scalar loads: pixel k
    of a block's conv2 pass (threads 2 k and 2 k + 1, a half of its
    channels each) reads word 2 k (mod 32), so the 16 pixels of a warp
    hit 16 distinct banks. Each block takes at most ``TILE_IMAGES``
    images, fewer where two blocks would not share an SM, the images
    spread evenly over the tiles. Raises where an image leaves no pooled
    conv2 output or does not fit in shared memory, or the tiles exceed
    the grid."""
    (p1h, p1w), (p2h, p2w) = pooled(H, W)
    if p2h < 1 or p2w < 1:
        raise _meta.RefusedValue(
            f"cnn_features: an image of {H} x {W} leaves no pooled conv2 "
            f"output (two conv5 + pool need 14 x 14 at least)")
    row = W * cin
    rs = (_at_least(row, cin * p1w, 16) if cin * p1w % 2 == 0
          else row + row % 2)
    is_ = _at_least(H * rs, 2 * cin * p1h * p1w, 32)
    rs2 = _at_least(p1w, p2w, 16)
    cs2 = p1h * rs2
    is2 = _at_least(c1 * cs2, 2 * p2h * p2w, 32)
    weights = weight_floats(cin, c1, c2)

    def fits(limit):
        return (limit // 4 - weights) // (is_ + is2)

    pair = min(TILE_IMAGES, fits(PAIR_SMEM))
    tile = pair if pair >= 1 else min(1, fits(MAX_SMEM))
    if tile < 1:
        raise _meta.RefusedValue(
            f"cnn_features: one {H} x {W} x {cin} image and its maps "
            f"need more shared memory than a block has ({MAX_SMEM} bytes)")
    tiles = -(-B // tile)
    if tiles > MAX_GRID_Y:
        raise _meta.RefusedValue(
            f"cnn_features: B = {B} images take {tiles} tiles, more than "
            f"the grid's {MAX_GRID_Y}")
    return Plan(tiles, tile, rs, is_, rs2, cs2, is2,
                4 * (weights + tile * (is_ + is2)))


def work(G: int, B: int, H: int, W: int, cin: int, c1: int, c2: int):
    """(bytes, flops) one call must at least move and do: the images and
    the weights read once, the features written once; a multiply and an
    add per tap at every conv position that reaches a pooled output."""
    (p1h, p1w), (p2h, p2w) = pooled(H, W)
    macs = (4 * p1h * p1w * 25 * cin * c1 + 4 * p2h * p2w * 25 * c1 * c2)
    params = 25 * cin * c1 + c1 + 25 * c1 * c2 + c2
    nbytes = 4 * (G * B * H * W * cin + G * params + G * B * p2h * p2w * c2)
    return nbytes, 2 * G * B * macs


def _inner_contiguous(t: torch.Tensor, start: int) -> bool:
    """Whether ``t``'s dims from ``start`` on are laid out contiguously
    (a dim of size 1 may have any stride)."""
    expect = 1
    for size, stride in reversed(list(zip(t.shape[start:],
                                          t.stride()[start:]))):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def cnn_features(x: torch.Tensor, conv1_w: torch.Tensor,
                 conv1_b: torch.Tensor, conv2_w: torch.Tensor,
                 conv2_b: torch.Tensor) -> torch.Tensor:
    """x: (G, B, H, W, cin) fp32 images; conv1_w: (G, 5, 5, cin, c1) and
    conv2_w: (G, 5, 5, c1, c2) HWIO; conv1_b: (G, c1); conv2_b: (G, c2),
    all fp32 on one CUDA device, each image and each model's leaf laid
    out contiguously (the strides between models and images are free).
    Returns the (G, B, p2h * p2w * c2) features, NHWC-flattened. Adds one
    to ``cnn_features.launches`` per kernel launch, and G to the
    ``k7.models`` counter (`repro_torch.obs`). On "meta" tensors: the
    checks and the output, no launch."""
    args = (x, conv1_w, conv1_b, conv2_w, conv2_b)
    dev = x.device
    if dev.type not in ("cuda", "meta") or any(t.device != dev
                                               for t in args):
        raise ValueError(
            f"cnn_features kernel needs every tensor on one CUDA device, "
            f"got {[str(t.device) for t in args]}")
    if any(t.dtype != torch.float32 for t in args):
        raise _meta.RefusedType(
            f"cnn_features: every tensor must be float32, got "
            f"{[str(t.dtype) for t in args]}")
    if x.dim() != 5 or conv1_w.dim() != 5 or conv2_w.dim() != 5 or \
            conv1_b.dim() != 2 or conv2_b.dim() != 2:
        raise ValueError("cnn_features: x (G, B, H, W, cin), conv weights "
                         "(G, 5, 5, in, out) and biases (G, out) expected")
    G, B, H, W, cin = x.shape
    c1, c2 = conv1_w.shape[-1], conv2_w.shape[-1]
    if tuple(conv1_w.shape) != (G, 5, 5, cin, c1) or \
            tuple(conv2_w.shape) != (G, 5, 5, c1, c2) or \
            tuple(conv1_b.shape) != (G, c1) or \
            tuple(conv2_b.shape) != (G, c2):
        raise ValueError(
            f"cnn_features: shapes {[tuple(t.shape) for t in args]} are no "
            f"5x5 conv stack of x (G, B, H, W, cin)")
    if (cin, c1, c2) not in KERNELS:
        raise _meta.RefusedValue(
            f"cnn_features: (cin, c1, c2) = {(cin, c1, c2)} is none of the "
            f"built kernels {KERNELS}")
    if not (_inner_contiguous(x, 2) and all(
            _inner_contiguous(t, 1) for t in args[1:])):
        raise ValueError("cnn_features: each image and each model's leaf "
                         "must be contiguous")
    if G > MAX_GRID_X:
        raise _meta.RefusedValue(f"cnn_features: G = {G} models is more "
                                 f"than the grid takes ({MAX_GRID_X})")
    _, (p2h, p2w) = pooled(H, W)
    plan = launch_plan(max(B, 1), H, W, cin, c1, c2)
    out = torch.empty((G, B, p2h * p2w * c2), dtype=torch.float32,
                      device=dev)
    if dev.type == "meta":
        _meta.record("cnn_features", work(G, B, H, W, cin, c1, c2),
                     x.dtype)
        return out
    if G == 0 or B == 0:
        return out
    sxg, sxb = x.stride(0), x.stride(1)
    vec = int(W * cin % 4 == 0 and x.data_ptr() % 16 == 0 and
              (G == 1 or sxg % 4 == 0) and (B == 1 or sxb % 4 == 0))
    with _obs.span("k7"):
        _obs.count("k7.models", G)
        lib_fn = _build.entry("cnn_features", "cnn_features_f32", _ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check("cnn_features", lib_fn(
            x.data_ptr(), sxg, sxb,
            conv1_w.data_ptr(), conv1_w.stride(0),
            conv1_b.data_ptr(), conv1_b.stride(0),
            conv2_w.data_ptr(), conv2_w.stride(0),
            conv2_b.data_ptr(), conv2_b.stride(0),
            out.data_ptr(), G, B, H, W, cin, c1, c2, plan.tiles,
            plan.tile_images, plan.rs, plan.is_, plan.rs2, plan.cs2,
            plan.is2, vec, plan.smem_bytes, dev.index, stream))
    cnn_features.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
cnn_features.launches = 0
