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

Each op runs outside `repro_torch.fl.round_engine.no_sync`'s fence: it
lifts CUDA's sync-debug mode for its own span, since a host copy or a
gloo exchange synchronizes by nature, and restores it after.
``counts`` holds the calls, bytes and seconds of each op since the last
reset. An op on CUDA tensors waits for the device to reach it before
its clock starts (the exchange would wait for it anyway), so its seconds
are the exchange's own, not the compute queued before it.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

#: (backend, op) -> how a CUDA tensor crosses ranks: "device" (the
#: backend takes the CUDA tensor) or "host" (through a pinned host copy).
#: gloo's rows only: NCCL's, on a host with more than one GPU, are what
#: is left of ROADMAP item 12b
TRANSPORT: Dict[Tuple[str, str], str] = {
    ("gloo", "all_gather"): "device",
    ("gloo", "ppermute"): "host",
    ("gloo", "all_reduce"): "device",
}
#: the counted ops; `psum` and `pmax` cross by the "all_reduce" row
OPS = ("all_gather", "ppermute", "psum", "pmax")
_TRANSPORT_OP = {"psum": "all_reduce", "pmax": "all_reduce"}
#: op -> [calls, bytes sent by this rank, seconds] since the last
#: `reset_counts`
counts: Dict[str, list] = {op: [0, 0, 0.0] for op in OPS}
#: (mesh layout, axes) -> the subgroup of a reduction over several axes
#: but not all (`_group`), made once per process
_subgroups: Dict[tuple, object] = {}


def reset_counts():
    for op in OPS:
        counts[op] = [0, 0, 0.0]


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
def _exchange(op: str, t: torch.Tensor):
    """One call of collective ``op`` sending ``t``: CUDA's sync-debug
    mode (`no_sync`'s fence) lifted for its span, and the call, ``t``'s
    bytes and the seconds from the device reaching the call to its
    return added to ``counts[op]``."""
    cuda = t.device.type == "cuda"
    if cuda:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
    c = counts[op]
    c[0] += 1
    c[1] += t.numel() * t.element_size()
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
    c = _coords(mesh, dist.get_rank() if rank is None else rank)
    index = 0
    for a in client_axes_of(mesh, client_axes):
        index = index * sizes[a] + c[a]
    return index


def _group(mesh, axes):
    """(process group, its member ranks in group order) of the ranks that
    share this rank's coordinates off ``axes``: the world, one axis's
    group of the mesh, or (several axes, not all) a subgroup made once
    per process by every rank (`_subgroups`, keyed by the mesh's layout),
    since a collective is entered by all."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(axes)
    if not axes or set(axes) - set(names):
        raise ValueError(f"axes {axes} are not axes of the mesh {names}")
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
    # refuses a backend off the table; gloo's all_reduce row is "device"
    transport(op, x, group)
    out = x.clone(memory_format=torch.contiguous_format)
    with _exchange(op, out):
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


def all_gather_rows(x: torch.Tensor, mesh,
                    client_axes=None) -> torch.Tensor:
    """The tiled all-gather of ``x``'s rows over the client axes: every
    shard's (n_loc, ...) block, in global row order (``all_gather(x, ca,
    axis=0, tiled=True)``)."""
    ca = client_axes_of(mesh, client_axes)
    group, members = _group(mesh, ca)
    as_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if as_bool else x).contiguous()
    order = sorted(range(len(members)),
                   key=lambda i: shard_index(mesh, ca, members[i]))
    # refuses a backend off the table; every all_gather entry of it is
    # "device", so the tensor goes as it is
    transport("all_gather", send, group)
    with _exchange("all_gather", send):
        chunks = [torch.empty_like(send) for _ in members]
        dist.all_gather(chunks, send, group=group)
        out = torch.cat([chunks[i] for i in order], dim=0)
    return out.bool() if as_bool else out


def ppermute_next(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The cyclic shift by +1 along ``axis``: this rank sends ``x`` to the
    next coordinate and returns what the previous one sent (`repro`'s
    ``ppermute(x, axis, [(i, (i + 1) % size)])``). The identity on an
    axis of size 1."""
    size = mesh_axis_sizes(mesh)[axis]
    if size == 1:
        return x
    c = _coords(mesh, dist.get_rank())
    names = list(mesh.mesh_dim_names)
    at = names.index(axis)

    def rank_at(coord):
        pos = [c[n] for n in names]
        pos[at] = coord % size
        return int(mesh.mesh[tuple(pos)])

    dst, src = rank_at(c[axis] + 1), rank_at(c[axis] - 1)
    x = x.contiguous()
    with _exchange("ppermute", x):
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
