"""The collectives of the client mesh: the only way one shard's rows
reach another (port of the ``jax.lax.all_gather(tiled=True)``,
``ppermute`` and ``axis_index`` calls inside `repro`'s ``shard_map``
bodies, and of `repro.sharding.compat.mesh_axis_sizes`).

A mesh is `repro_torch.launch.mesh.make_client_mesh`'s ``DeviceMesh``,
one process per shard. The client axis is split row-major over the
client axes, so the shard index of a rank is its row-major position
over them, and `all_gather_rows` returns the rows in global order.

How a CUDA tensor crosses ranks is one fixed table, `TRANSPORT`, keyed by
backend and op, never a try/except at run time: gloo all-gathers CUDA
tensors itself (``ProcessGroupGloo`` stages them through the host), but
its send and receive take CPU tensors only, so `ppermute_next` copies
through a pinned host buffer and back. That copy is the transport of a
simulated exchange between processes that share one card; it is not a
fallback, and every kernel still runs on the card. CPU tensors go as
they are.

Each op runs outside `repro_torch.fl.round_engine.no_sync`'s fence: it
lifts CUDA's sync-debug mode for its own span, since a host copy or a
gloo exchange synchronizes by nature, and restores it after.
``counts`` holds the calls and bytes of each op since the last reset.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

#: (backend, op) -> how a CUDA tensor crosses ranks: "device" (the
#: backend takes the CUDA tensor) or "host" (through a pinned host copy)
#: (gloo only: NCCL on a card with more than one GPU is ROADMAP item 12b)
TRANSPORT: Dict[Tuple[str, str], str] = {
    ("gloo", "all_gather"): "device",
    ("gloo", "ppermute"): "host",
}
OPS = ("all_gather", "ppermute")
#: op -> [calls, bytes sent by this rank] since the last `reset_counts`
counts: Dict[str, list] = {op: [0, 0] for op in OPS}


def reset_counts():
    for op in OPS:
        counts[op] = [0, 0]


def transport(op: str, tensor: torch.Tensor, group=None) -> str:
    """How ``tensor`` crosses ranks in ``op``: "cpu" for a CPU tensor,
    else the `TRANSPORT` entry of the group's backend."""
    if tensor.device.type == "cpu":
        return "cpu"
    backend = str(dist.get_backend(group))
    if (backend, op) not in TRANSPORT:
        raise ValueError(f"no transport for {op} on the {backend} backend "
                         f"(the client mesh runs on gloo; other backends "
                         f"are ROADMAP item 12b)")
    return TRANSPORT[(backend, op)]


@contextlib.contextmanager
def _unfenced(t: torch.Tensor):
    """Lift CUDA's sync-debug mode (`no_sync`'s fence) for one collective."""
    if t.device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


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


def _client_group(mesh, client_axes):
    """(process group, its member ranks in group order) of the ranks that
    share this rank's coordinates off the client axes."""
    names = tuple(mesh.mesh_dim_names)
    if set(client_axes) == set(names):
        return None, list(range(dist.get_world_size()))
    if len(client_axes) == 1:
        group = mesh.get_group(client_axes[0])
        return group, dist.get_process_group_ranks(group)
    raise ValueError(f"client axes {client_axes} of mesh axes {names}")


def all_gather_rows(x: torch.Tensor, mesh,
                    client_axes=None) -> torch.Tensor:
    """The tiled all-gather of ``x``'s rows over the client axes: every
    shard's (n_loc, ...) block, in global row order (``all_gather(x, ca,
    axis=0, tiled=True)``)."""
    ca = client_axes_of(mesh, client_axes)
    group, members = _client_group(mesh, ca)
    as_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if as_bool else x).contiguous()
    order = sorted(range(len(members)),
                   key=lambda i: shard_index(mesh, ca, members[i]))
    # refuses a backend off the table; every all_gather entry of it is
    # "device", so the tensor goes as it is
    transport("all_gather", send, group)
    with _unfenced(send):
        chunks = [torch.empty_like(send) for _ in members]
        dist.all_gather(chunks, send, group=group)
        out = torch.cat([chunks[i] for i in order], dim=0)
    counts["all_gather"][0] += 1
    counts["all_gather"][1] += send.numel() * send.element_size()
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
    with _unfenced(x):
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
    counts["ppermute"][0] += 1
    counts["ppermute"][1] += x.numel() * x.element_size()
    return out
