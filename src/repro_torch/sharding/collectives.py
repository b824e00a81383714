"""The collectives of the mesh: the only way one shard's values reach
another (port of the ``jax.lax.all_gather(tiled=True)``, ``ppermute``,
``psum``, ``pmax`` and ``axis_index`` calls inside `repro`'s
``shard_map`` bodies, and of `repro.sharding.compat.mesh_axis_sizes`).

A mesh is a `repro_torch.launch.mesh` ``DeviceMesh``, one process per
shard: the client mesh ``('pod', 'data')`` of the DPFL clients, or a
mesh with a ``'model'`` axis (the LM's experts and sequence-sharded
caches). The client axis is split row-major over the client axes, so
the shard index of a rank is its row-major position over them, and
`all_gather_rows` returns the rows in global order. `psum` and `pmax`
reduce over the ranks that share this rank's coordinates off the axes
named.

How a CUDA tensor crosses ranks is one fixed table, `TRANSPORT`, keyed by
backend and op, never a try/except at run time: gloo all-gathers and
all-reduces CUDA tensors itself (``ProcessGroupGloo`` stages them
through the host), but its send and receive take CPU tensors only, so
`ppermute_next` copies through a pinned host buffer and back. That copy
is the transport of a simulated exchange between processes that share
one card; it is not a fallback, and every kernel still runs on the card.
CPU tensors go as they are.

Each op runs inside `repro_torch.analysis.guards.allow_transfers`: a
round runs under the ``no_transfer`` fence, and a host copy or a gloo
exchange synchronizes by nature. ``counts`` holds the calls, bytes and
seconds of each op since the last reset. An op on CUDA tensors waits for
the device to reach it before its clock starts (the exchange would wait
for it anyway), so its seconds are the exchange's own, not the compute
queued before it.

A `ShapeMesh` is a mesh of shapes alone: the axis names, their sizes
and one rank's coordinates, with no process group. On it the ops take
"meta" tensors only, return "meta" tensors of the result's shape and
record each call as a real one (`recording`): the dry run
(`repro_torch.launch.dryrun`, `fl_dryrun`) runs the port's own step code
as one rank of a production mesh this way.

Inside a `recording` block each call also leaves a `CallRecord`: the
op, what this rank sent, the group's size, the call site (the first
frame outside this module) and its region: the span of `TAGS` open
around the call (`repro_torch.obs`), such as the GGC refresh's.
`repro_torch.analysis.commaudit` reads them as
`repro`'s audit reads the collectives of the compiled round. Outside
such a block a call records nothing and looks up no call site.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import obs as _obs
from ..analysis.guards import allow_transfers

#: (backend, op) -> how a CUDA tensor crosses ranks: "device" (the
#: backend takes the CUDA tensor) or "host" (through a pinned host copy).
#: gloo's rows only: NCCL's, on a host with more than one GPU, are what
#: is left of ROADMAP item 12b
TRANSPORT: Dict[Tuple[str, str], str] = {
    ("gloo", "all_gather"): "device",
    ("gloo", "ppermute"): "host",
    ("gloo", "all_reduce"): "device",
}
#: the spans that tag the collectives called inside them, in their
#: `CallRecord`: the GGC refresh (`repro_torch.analysis.commaudit.REFRESH`)
TAGS = ("refresh",)
#: the counted ops; `psum` and `pmax` cross by the "all_reduce" row
OPS = ("all_gather", "ppermute", "psum", "pmax")
_TRANSPORT_OP = {"psum": "all_reduce", "pmax": "all_reduce"}
#: op -> [calls, bytes sent by this rank, seconds] since the last
#: `reset_counts`
counts: Dict[str, list] = {op: [0, 0, 0.0] for op in OPS}
#: (mesh layout, axes) -> the subgroup of a reduction over several axes
#: but not all (`_group`), made once per process
_subgroups: Dict[tuple, object] = {}


@dataclasses.dataclass(frozen=True)
class CallRecord:
    """One call of a collective on this rank.

    op:         one of `OPS`
    shape:      the shape of the tensor this rank sent
    dtype:      its dtype, as ``str(torch.dtype)``
    sent_bytes: its bytes
    group_size: the ranks taking part (a ppermute's: the ranks of the
                axes it shifts along)
    site:       ``"<file under repro_torch/>:<function>"`` of the first
                frame outside this module (a caller outside the package:
                its file's name)
    region:     the innermost span of `TAGS` open around the call,
                however deep (`repro_torch.obs.span`), or None
    """
    op: str
    shape: Tuple[int, ...]
    dtype: str
    sent_bytes: int
    group_size: int
    site: str
    region: Optional[str]


# the lists of the active `recording` blocks
_recorders: List[List[CallRecord]] = []


class ShapeMesh:
    """A mesh of ``shape`` with axis names ``axes``, ranks row-major, seen
    from ``rank``: what `make_mesh`'s ``DeviceMesh`` answers about axes
    and coordinates, with no ``torch.distributed`` behind it. The
    collectives take "meta" tensors on it and only those."""

    device_type = "meta"

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in length")
        self.mesh = torch.arange(math.prod(shape)).reshape(shape)
        self.mesh_dim_names = axes
        if not 0 <= rank < self.mesh.numel():
            raise ValueError(f"rank {rank} is not in the {shape} mesh")
        self.rank = int(rank)

    def size(self) -> int:
        return self.mesh.numel()

    def get_local_rank(self, axis: str) -> int:
        return _coords(self, self.rank)[axis]

    def __repr__(self) -> str:
        return (f"ShapeMesh({tuple(self.mesh.shape)}, {self.mesh_dim_names}, "
                f"rank={self.rank})")


def _shape_only(mesh, *tensors: torch.Tensor) -> bool:
    """Whether ``mesh`` is a `ShapeMesh`; it refuses a tensor off "meta"."""
    if not isinstance(mesh, ShapeMesh):
        return False
    for t in tensors:
        if t.device.type != "meta":
            raise ValueError(f"a ShapeMesh takes 'meta' tensors only, got "
                             f"one on {t.device}")
    return True


def _rank(mesh) -> int:
    """This process's rank in ``mesh``'s world (a `ShapeMesh`'s own)."""
    return mesh.rank if isinstance(mesh, ShapeMesh) else dist.get_rank()


def reset_counts():
    for op in OPS:
        counts[op] = [0, 0, 0.0]


@contextlib.contextmanager
def recording():
    """Record the collective calls made inside the block: yields a list
    that gains one `CallRecord` a call, in call order."""
    recs: List[CallRecord] = []
    _recorders.append(recs)
    try:
        yield recs
    finally:
        _recorders.pop()


def _region() -> Optional[str]:
    return next((s for s in reversed(_obs.stack()) if s in TAGS), None)


_HERE = os.path.abspath(__file__)
_SKIP = (_HERE, os.path.abspath(contextlib.__file__))


def _call_site() -> str:
    frame = sys._getframe(1)
    while frame is not None and \
            os.path.abspath(frame.f_code.co_filename) in _SKIP:
        frame = frame.f_back
    if frame is None:
        return "?"
    path = frame.f_code.co_filename.replace(os.sep, "/")
    at = path.rfind("/repro_torch/")
    name = path[at + 1:] if at >= 0 else os.path.basename(path)
    return f"{name}:{frame.f_code.co_name}"


def transport(op: str, tensor: torch.Tensor, group=None) -> str:
    """How ``tensor`` crosses ranks in ``op``: "cpu" for a CPU tensor,
    else the `TRANSPORT` entry of the group's backend."""
    if tensor.device.type == "cpu":
        return "cpu"
    backend = str(dist.get_backend(group))
    op = _TRANSPORT_OP.get(op, op)
    if (backend, op) not in TRANSPORT:
        raise ValueError(f"no transport for {op} on the {backend} backend "
                         f"(the mesh runs on gloo; NCCL's rows are ROADMAP "
                         f"item 12b)")
    return TRANSPORT[(backend, op)]


@contextlib.contextmanager
def _exchange(op: str, t: torch.Tensor, group_size: int):
    """One call of collective ``op`` sending ``t`` to a group of
    ``group_size`` ranks: inside `allow_transfers`, its `CallRecord`
    appended to every active `recording`, and the call, ``t``'s bytes and the seconds from the device
    reaching the call to its return added to ``counts[op]``."""
    nbytes = t.numel() * t.element_size()
    if _recorders:
        rec = CallRecord(op, tuple(t.shape), str(t.dtype), nbytes,
                         group_size, _call_site(), _region())
        for recs in _recorders:
            recs.append(rec)
    with allow_transfers():
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        yield
    c = counts[op]
    c[0] += 1
    c[1] += nbytes
    c[2] += time.perf_counter() - t0


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def client_axes_of(mesh, client_axes=None) -> tuple:
    """The client axes: ``client_axes``, or whichever of ('pod', 'data')
    the mesh has (`repro.fl.engine.FLEngine.shard_clients`)."""
    if client_axes is None:
        return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return tuple(client_axes)


def _coords(mesh, rank: int) -> dict:
    where = (mesh.mesh == rank).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, where[0].tolist()))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def num_shards(mesh, client_axes: Sequence[str] = None) -> int:
    """Shards of the client axis: the product of the client axes' sizes
    (``client_axes`` None: `client_axes_of`, here and below)."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in client_axes_of(mesh, client_axes))


def shard_index(mesh, client_axes: Sequence[str] = None, rank=None) -> int:
    """Row-major position of ``rank`` (default: this one) over the client
    axes: the block of client rows it owns."""
    sizes = mesh_axis_sizes(mesh)
    c = _coords(mesh, _rank(mesh) if rank is None else rank)
    index = 0
    for a in client_axes_of(mesh, client_axes):
        index = index * sizes[a] + c[a]
    return index


def _group(mesh, axes):
    """(process group, its member ranks in group order) of the ranks that
    share this rank's coordinates off ``axes``: the world, one axis's
    group of the mesh, or (several axes, not all) a subgroup made once
    per process by every rank (`_subgroups`, keyed by the mesh's layout),
    since a collective is entered by all. A `ShapeMesh` has no process
    group: (None, the members, laid out as the subgroups are)."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(axes)
    if not axes or set(axes) - set(names):
        raise ValueError(f"axes {axes} are not axes of the mesh {names}")
    if isinstance(mesh, ShapeMesh):
        at = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in at]
        blocks = mesh.mesh.permute(rest + at).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in at)).tolist()
        return None, next(b for b in blocks if mesh.rank in b)
    if set(axes) == set(names):
        return None, list(range(dist.get_world_size()))
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        return group, dist.get_process_group_ranks(group)
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
           names, axes)
    if key not in _subgroups:
        at = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in at]
        blocks = mesh.mesh.permute(rest + at).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in at))
        _subgroups[key] = dist.new_subgroups_by_enumeration(
            blocks.tolist())[0]
    group = _subgroups[key]
    return group, dist.get_process_group_ranks(group)


def axes_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (a name or a tuple of names)."""
    sizes = mesh_axis_sizes(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(sizes[a] for a in axes)


def _all_reduce(op: str, x: torch.Tensor, mesh, axes) -> torch.Tensor:
    group, members = _group(mesh, (axes,) if isinstance(axes, str)
                            else axes)
    if len(members) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    if _shape_only(mesh, x):
        with _exchange(op, out, len(members)):
            pass
        return out
    # refuses a backend off the table; gloo's all_reduce row is "device"
    transport(op, x, group)
    with _exchange(op, out, len(members)):
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "psum"
                        else dist.ReduceOp.MAX, group=group)
    return out


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks that differ from this one only on
    ``axes`` (a name or a tuple of names): ``jax.lax.psum(x, axes)``. A
    new tensor, the same bits on every rank of the group; ``x`` itself
    where the axes' sizes multiply to 1 (no collective)."""
    return _all_reduce("psum", x, mesh, axes)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the same ranks as `psum`:
    ``jax.lax.pmax(x, axes)``."""
    return _all_reduce("pmax", x, mesh, axes)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce("psum", x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


def psum_replicated(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`psum` whose result every rank of the group then uses alike (the
    sum of the ranks' parts of one value): its backward passes the
    cotangent through unchanged, as jax's ``psum`` under ``shard_map``
    transposes to a broadcast. Summing the cotangent again would count a
    replicated cotangent once per rank of the group."""
    if axes_size(mesh, axes) == 1 or not (torch.is_grad_enabled()
                                            and x.requires_grad):
        return psum(x, mesh, axes)
    return _PsumReplicated.apply(x, mesh, axes)


def pvary(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x``, whole on every rank of the group, handed to a computation
    that differs from rank to rank (a rank's experts): the identity
    forward, and a `psum` of the cotangent over ``axes`` backward, since
    each rank's part of the gradient is only its own computation's (jax's
    ``pvary``, whose transpose is ``psum``)."""
    if axes_size(mesh, axes) == 1 or not (torch.is_grad_enabled()
                                            and x.requires_grad):
        return x
    return _Pvary.apply(x, mesh, axes)


def all_gather_rows(x: torch.Tensor, mesh,
                    client_axes=None) -> torch.Tensor:
    """The tiled all-gather of ``x``'s rows over the client axes: every
    shard's (n_loc, ...) block, in global row order (``all_gather(x, ca,
    axis=0, tiled=True)``)."""
    ca = client_axes_of(mesh, client_axes)
    group, members = _group(mesh, ca)
    as_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if as_bool else x).contiguous()
    if _shape_only(mesh, send):
        with _exchange("all_gather", send, len(members)):
            out = send.new_empty((len(members) * send.shape[0],)
                                 + tuple(send.shape[1:]))
        return out.bool() if as_bool else out
    order = sorted(range(len(members)),
                   key=lambda i: shard_index(mesh, ca, members[i]))
    # refuses a backend off the table; every all_gather entry of it is
    # "device", so the tensor goes as it is
    transport("all_gather", send, group)
    with _exchange("all_gather", send, len(members)):
        chunks = [torch.empty_like(send) for _ in members]
        dist.all_gather(chunks, send, group=group)
        out = torch.cat([chunks[i] for i in order], dim=0)
    return out.bool() if as_bool else out


def ppermute_next(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The cyclic shift by +1 along each of ``axes`` (a name or a tuple of
    names) at once: this rank sends ``x`` to the rank one further on
    every axis named and returns what the rank one back on each sent.
    One axis is `repro`'s ``ppermute(x, axis, [(i, (i + 1) % size)])``;
    several are the shifts of that many such calls composed, made as one
    exchange, so a panel crosses once. The identity where the axes'
    sizes multiply to 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axis_sizes(mesh)
    if math.prod(sizes[a] for a in axes) == 1:
        return x
    if _shape_only(mesh, x):
        x = x.contiguous()
        with _exchange("ppermute", x, math.prod(sizes[a] for a in axes)):
            out = torch.empty_like(x)
        return out
    c = _coords(mesh, dist.get_rank())
    names = list(mesh.mesh_dim_names)

    def rank_at(step):
        pos = [c[n] for n in names]
        for a in axes:
            at = names.index(a)
            pos[at] = (pos[at] + step) % sizes[a]
        return int(mesh.mesh[tuple(pos)])

    dst, src = rank_at(1), rank_at(-1)
    x = x.contiguous()
    with _exchange("ppermute", x, math.prod(sizes[a] for a in axes)):
        staged = transport("ppermute", x) == "host"
        if staged:
            send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            send.copy_(x)
            recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        else:
            send, recv = x, torch.empty_like(x)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, send, dst),
                 dist.P2POp(dist.irecv, recv, src)]):
            req.wait()
        out = recv.to(x.device) if staged else recv
    return out
