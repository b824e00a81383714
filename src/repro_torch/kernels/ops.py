"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

The choice follows the device of the tensors and nothing else: no
environment variable and no ``impl=`` argument selects an
implementation. On a CUDA tensor an op launches its kernel or raises.

The three Eq.-4 ops take ``mesh=`` / ``client_axes=``: under a client
mesh (`repro_torch.launch.mesh`) each rank holds its (n_loc, ...) rows
and computes its own row block, the peers' rows reaching it only through
`repro_torch.sharding.collectives` (`repro.kernels.ops`' ``shard_map``
paths). The dense mix and the top-k mix all-gather the peer panels
(compressed ones for top-k: 2K words a peer) and launch K1 / K3 on the
(n_loc, N) row block; the neighbor-list mix rotates the peer panels
shard to shard and launches K2 once per visiting panel, so a rank never
holds more than one (n_loc, P) panel of peers.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..analysis.registry import exchange_site
from ..sharding import collectives as _coll
from . import compressed_graph_mix as _k3
from . import flash_attention as _k4
from . import graph_mix as _k1
from . import ref
from . import rglru_scan as _k6
from . import sparse_graph_mix as _k2
from . import ssd as _k5


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


@exchange_site(charges="caller")
def graph_mix(A: torch.Tensor, W: torch.Tensor, *, mesh=None,
              client_axes=None) -> torch.Tensor:
    """Eq.-4 mixing matmul ``A @ W`` ((M, N) @ (N, P)), fp32 accumulation,
    output in W's dtype (`repro.kernels.ops.graph_mix`). Under ``mesh``, A
    is this rank's (n_loc, N) row block and W its (n_loc, P) rows: the
    peer panels are all-gathered and K1 runs on the row block. K1 sums
    each output row over n = 0..N-1 whatever M is, so the rows are the
    single-device rows bit for bit."""
    if mesh is not None:
        W = _coll.all_gather_rows(W, mesh, client_axes)
    if _on_cpu(A, W):
        return ref.graph_mix_ref(A, W)
    return _k1.graph_mix(A, W)


def _rotation_schedule(axis_sizes: dict, client_axes: Sequence[str]):
    """The shard-to-shard rotation plan over the (possibly multi-axis)
    client mesh, from the axis sizes alone: ``(sizes, steps)``, ``steps``
    a list of (axes moved, cumulative per-axis offsets), one single-axis
    cyclic shift per axis moved, whose offsets visit every non-zero shard
    offset of the torus once. Row-major over ``client_axes`` (the
    rightmost axis fastest; a carry moves the next axis too), as
    `repro.kernels.ops._rotation_schedule`."""
    sizes = [axis_sizes[a] for a in client_axes]
    steps = []
    off = [0] * len(sizes)
    total = 1
    for size in sizes:
        total *= size
    for _ in range(total - 1):
        moves = []
        for ax in reversed(range(len(sizes))):
            off[ax] = (off[ax] + 1) % sizes[ax]
            moves.append(client_axes[ax])
            if off[ax] != 0:
                break
        steps.append((tuple(moves), tuple(off)))
    return sizes, steps


def rotate(parts: Tuple[torch.Tensor, ...], visit: Callable, mesh,
           client_axes) -> None:
    """Drive the rotation of `_rotation_schedule`: ``visit(src, panel)``
    sees this rank's own ``parts`` first (``src`` its shard index), then,
    after each step's shift, the parts of shard ``src`` that the step
    brought. A step's single-axis shifts (two or more where a carry
    moves the next axis too) are composed into one exchange
    (`collectives.ppermute_next` over the axes moved), so each part
    crosses D - 1 times a rotation, the count the wire-bytes audit
    (`analysis.commaudit`) holds it to. One panel of parts is held at a
    time."""
    ca = _coll.client_axes_of(mesh, client_axes)
    sizes, schedule = _rotation_schedule(_coll.mesh_axis_sizes(mesh), ca)
    coords = [_coll.axis_index(mesh, a) for a in ca]

    def source(offsets):
        src = 0
        for c, o, size in zip(coords, offsets, sizes):
            src = src * size + (c - o) % size
        return src

    visit(source((0,) * len(ca)), parts)
    panel = tuple(parts)
    for moves, offsets in schedule:
        shifted = []
        for x in panel:
            shifted.append(_coll.ppermute_next(x, mesh, moves))
        panel = tuple(shifted)
        visit(source(offsets), panel)


def local_slots(nbr_idx: torch.Tensor, src: int, n_loc: int):
    """The slots of (n_loc, B) neighbor lists that name a row of shard
    ``src`` (rows ``src * n_loc ...``): ``(match, local)``, the bool mask
    and the row within that shard's panel (clamped in range)."""
    local = nbr_idx.long() - src * n_loc
    match = (nbr_idx >= 0) & (local >= 0) & (local < n_loc)
    return match, local.clamp(0, n_loc - 1)


@exchange_site(charges="caller")
def sparse_graph_mix(self_w: torch.Tensor, nbr_w: torch.Tensor,
                     nbr_idx: torch.Tensor, W_self: torch.Tensor,
                     W_peers: Optional[torch.Tensor] = None, *,
                     peer_parts: Optional[Tuple[torch.Tensor, ...]] = None,
                     peer_decode: Optional[Callable] = None, mesh=None,
                     client_axes=None) -> torch.Tensor:
    """Neighbor-list Eq.-4 mix
    ``out[n] = self_w[n] W_self[n] + sum_b nbr_w[n, b] W_peers[idx[n, b]]``
    (idx -1 = empty slot), fp32 accumulation, output in W_self's dtype
    (`repro.kernels.ops.sparse_graph_mix`). The peer table is
    ``W_peers`` (default ``W_self``), or ``peer_decode(*peer_parts)``:
    the parts are what peers transmit (a codec's payload).

    Under ``mesh`` every tensor holds this rank's n_loc rows and the
    peer parts rotate shard to shard (`rotate`): each visiting panel is
    decoded, kept to the slots that name its rows, and mixed by one K2
    launch with ``W_peers`` that (n_loc, P) panel; the self term is
    added at offset 0 only. The contributions add in visit order, not
    slot order, so the sum matches the single-device one to fp32
    rounding (`repro` holds its own rotation to 1e-5)."""
    if peer_parts is None:
        peer_parts = (W_self if W_peers is None else W_peers,)
    if peer_decode is None:
        peer_decode = lambda part, *_: part  # noqa: E731

    def local(sw, nw, idx, peers):
        if _on_cpu(sw, nw, idx, W_self, peers):
            return ref.sparse_graph_mix_ref(sw, nw, idx, W_self, peers)
        return _k2.sparse_graph_mix(sw, nw, idx, W_self, peers)

    if mesh is None:
        return local(self_w, nbr_w, nbr_idx, peer_decode(*peer_parts))
    n_loc = W_self.shape[0]
    out = None

    def visit(src, panel):
        nonlocal out
        match, rows = local_slots(nbr_idx, src, n_loc)
        idx = torch.where(match, rows, -1).to(torch.int32).contiguous()
        w = torch.where(match, nbr_w, 0.0).contiguous()
        sw = self_w if out is None else torch.zeros_like(self_w)
        part = local(sw, w, idx, peer_decode(*panel).contiguous())
        out = part if out is None else out + part

    rotate(peer_parts, visit, mesh, client_axes)
    return out


@exchange_site(charges="caller")
def sparse_peer_rows(nbr_idx: torch.Tensor, peers: torch.Tensor, *, mesh,
                     client_axes=None) -> torch.Tensor:
    """(n_loc, B, P): slot b of row n holds the peer row ``nbr_idx[n, b]``
    of the whole (N, P) table whose rows ``peers`` are this rank's, zeros
    at -1 slots, fetched by the rotation (`rotate`): what the robust
    rules of `fl.robust` read under a mesh in place of
    ``peers[nbr_idx]``, with no (N, P) table on any rank."""
    n_loc = peers.shape[0]
    out = torch.zeros(tuple(nbr_idx.shape) + tuple(peers.shape[1:]),
                      dtype=peers.dtype, device=peers.device)

    def visit(src, panel):
        nonlocal out
        match, rows = local_slots(nbr_idx, src, n_loc)
        out = torch.where(match[..., None], panel[0][rows], out)

    rotate((peers,), visit, mesh, client_axes)
    return out


@exchange_site(charges="caller")
def compressed_graph_mix(A: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, p_dim: int, *, mesh=None,
                         client_axes=None) -> torch.Tensor:
    """``A @ densify(vals, idx)`` over (N, K) top-k payloads, fp32
    accumulation (`repro.kernels.ops.compressed_graph_mix`). Under
    ``mesh``, A is this rank's (n_loc, N) row block and (vals, idx) its
    rows: the compressed payloads are all-gathered (2K words a peer)
    and K3 runs on the row block."""
    if mesh is not None:
        vals = _coll.all_gather_rows(vals, mesh, client_axes)
        idx = _coll.all_gather_rows(idx, mesh, client_axes)
    if _on_cpu(A, vals, idx):
        return ref.compressed_graph_mix_ref(A, vals, idx, p_dim)
    return _k3.compressed_graph_mix(A, vals, idx, p_dim)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention over aligned positions, optional sliding
    window: q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), output in q's
    dtype (`repro.kernels.ops.flash_attention`). Differentiable in fp32
    and bf16: on CPU tensors autograd differentiates the plain version
    (at bf16 with `repro`'s cast points), on CUDA tensors the kernel's
    backward runs (`kernels.flash_attention`)."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _k4.flash_attention(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 chunked SSD scan: x (b, l, h, p) already scaled by dt,
    dlogA (b, l, h), B and C (b, l, n), h0 (b, h, p, n) or None; returns
    (y (b, l, h, p), h_last (b, h, p, n)) (`repro.kernels.ops.ssd`).
    Differentiable in fp32: on CPU tensors autograd differentiates the
    plain version, on CUDA tensors the kernel's backward runs
    (`kernels.ssd`)."""
    if _on_cpu(x, dlogA, B, C, *(() if h0 is None else (h0,))):
        return ref.ssd_ref(x, dlogA, B, C, chunk, h0)
    return _k5.ssd(x, dlogA, B, C, chunk=chunk, h0=h0)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` over axis 1: a, b
    (B, S, W) float32, h0 (B, W) or None; returns (h (B, S, W), h_last
    (B, W)) (`repro.kernels.rglru_scan.rglru_scan`, whose oracle `repro`'s
    model runs). Differentiable: on CPU tensors autograd differentiates
    the plain version, on CUDA tensors the kernel's backward runs
    (`kernels.rglru_scan`)."""
    if _on_cpu(a, b, *(() if h0 is None else (h0,))):
        return ref.linear_scan_ref(a, b, h0)
    return _k6.rglru_scan(a, b, h0)
