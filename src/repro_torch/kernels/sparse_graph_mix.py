"""CUDA kernel wrapper for the neighbor-list Eq.-4 mix.

Computes ``out[n] = self_w[n] W_self[n] + sum_b nbr_w[n, b]
W_peers[idx[n, b]]`` over the (N, B) neighbor lists of the
budget-constrained greedy (idx -1 is an empty slot with weight 0,
duplicate indices add). Port of the Pallas TPU kernel
``repro/kernels/sparse_graph_mix.py::sparse_graph_mix`` on one device
(under a client mesh `repro_torch.kernels.ops.sparse_graph_mix` launches
it once per visiting panel of its rotation, with ``W_peers`` that
panel); the kernel, its bound and its design are described in
``csrc/sparse_graph_mix.cu``. Its plain version is
`repro_torch.kernels.ref.sparse_graph_mix_ref`.

The wrapper launches the kernel on CUDA tensors, or raises: it never
falls back to the plain version (`repro_torch.kernels.ops` picks the
plain version for CPU tensors only). On "meta" tensors it runs the
checks and allocates the output, and launches nothing
(`repro_torch.kernels.meta`). `work` is the bytes and operations of one
call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import meta as _meta
from .graph_mix import vector_width

_SYMBOLS = {torch.float32: "sparse_graph_mix_f32",
            torch.bfloat16: "sparse_graph_mix_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)
#: column vectors of one output row a block owns (csrc: kThreads * kVecs);
#: it only sizes the grid, whose blocks stride over the tiles
BLOCK_VECTORS = 256 * 2
#: the largest grid extents CUDA takes: x (clients) and y (P tiles)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


def launch_grid(N: int, P: int, cols: int) -> int:
    """The y extent of the kernel's (N, y) grid for N clients and P
    columns moved ``cols`` at a time. x is one block per client, so the
    blocks of one P tile are launched together; y walks the P tiles with
    a stride of y (a block takes tiles y0, y0 + y, ...), so every P fits.
    Raises where N exceeds the grid's x extent."""
    if N > MAX_GRID_X:
        raise _meta.RefusedValue(
            f"sparse_graph_mix: N = {N} clients is more than "
            f"the kernel's grid takes ({MAX_GRID_X})")
    tiles = -(-P // (BLOCK_VECTORS * cols))
    return max(1, min(tiles, MAX_GRID_Y))


def work(N: int, B: int, P: int, element_size: int, slots: int,
         peer_rows: int):
    """(bytes, flops) one call must at least move and do: self_w, nbr_w
    and nbr_idx read once, W_self read and out written once, and the
    ``peer_rows`` distinct rows of a separate W_peers that the lists name
    (0 where W_peers is W_self: those rows are W_self's); a multiply and
    an add per column of the self term and of each of the ``slots``
    valid slots. The count depends on the lists: a shape-only call
    counts every slot valid and every row of a separate table named."""
    return (4 * N + 8 * N * B + element_size * (2 * N + peer_rows) * P,
            2 * P * (N + slots))


def sparse_graph_mix(self_w: torch.Tensor, nbr_w: torch.Tensor,
                     nbr_idx: torch.Tensor, W_self: torch.Tensor,
                     W_peers: torch.Tensor) -> torch.Tensor:
    """self_w: (N,) fp32; nbr_w: (N, B) fp32; nbr_idx: (N, B) int32 in
    [0, N) or -1; W_self, W_peers: (N, P), both fp32 or both bf16. All
    contiguous on one CUDA device. Returns the (N, P) mix in W_self's
    dtype, fp32 accumulation. The tables may start at any element
    boundary: two columns a thread where P is even and W_self, W_peers
    and out are aligned to two elements, else one (`vector_width`). Adds
    one to ``sparse_graph_mix.launches`` per kernel launch. On "meta"
    tensors: the checks and the output, no launch."""
    dev = W_self.device
    tensors = (self_w, nbr_w, nbr_idx, W_self, W_peers)
    if dev.type not in ("cuda", "meta") or any(t.device != dev
                                               for t in tensors):
        raise ValueError(f"sparse_graph_mix kernel needs every tensor on "
                         f"one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if self_w.dtype != torch.float32 or nbr_w.dtype != torch.float32:
        raise _meta.RefusedType(f"sparse_graph_mix: self_w and nbr_w must be "
                                f"float32, got {self_w.dtype}, {nbr_w.dtype}")
    if nbr_idx.dtype != torch.int32:
        raise _meta.RefusedType(
            f"sparse_graph_mix: nbr_idx must be int32, got "
            f"{nbr_idx.dtype}")
    if W_self.dtype not in _SYMBOLS or W_peers.dtype != W_self.dtype:
        raise _meta.RefusedType(
            f"sparse_graph_mix: W_self and W_peers must both "
            f"be float32 or both bfloat16, got {W_self.dtype}, "
            f"{W_peers.dtype}")
    if W_self.dim() != 2 or W_peers.shape != W_self.shape or \
            nbr_idx.dim() != 2 or nbr_w.shape != nbr_idx.shape or \
            self_w.shape != (W_self.shape[0],) or \
            nbr_idx.shape[0] != W_self.shape[0]:
        raise ValueError(
            f"sparse_graph_mix: shapes self_w {tuple(self_w.shape)}, "
            f"nbr_w {tuple(nbr_w.shape)}, nbr_idx {tuple(nbr_idx.shape)}, "
            f"W_self {tuple(W_self.shape)}, W_peers "
            f"{tuple(W_peers.shape)} do not fit (N,), (N, B), (N, B), "
            f"(N, P), (N, P)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_graph_mix: every tensor must be contiguous")
    N, B = nbr_idx.shape
    P = W_self.shape[1]
    out = torch.empty_like(W_self)
    if dev.type == "meta":
        _meta.record("sparse_graph_mix", work(
            N, B, P, W_self.element_size(), N * B,
            0 if W_peers is W_self else min(N, N * B)), W_self.dtype)
        return out
    if N == 0 or P == 0:
        return out
    cols = vector_width(P, W_self.element_size(), W_self.data_ptr(),
                        W_peers.data_ptr(), out.data_ptr())
    grid_y = launch_grid(N, P, cols)
    fn = _build.entry("sparse_graph_mix", _SYMBOLS[W_self.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("sparse_graph_mix", fn(
        self_w.data_ptr(), nbr_w.data_ptr(), nbr_idx.data_ptr(),
        W_self.data_ptr(), W_peers.data_ptr(), out.data_ptr(), N, B, P,
        cols, grid_y, dev.index, stream))
    sparse_graph_mix.launches += 1
    return out


#: kernel launches since the last reset (a plain int; chip_smoke.py zeroes
#: it before driving the main path and reads it after)
sparse_graph_mix.launches = 0
