"""The client mesh: one process per shard of clients (port of
`repro.launch.mesh.make_client_mesh`).

`repro` shards the FL client axis over a ``('pod', 'data')`` jax mesh of
devices (``FLEngine.shard_clients``, DESIGN.md §8). Here a shard is a
process: `make_client_mesh` lays the initialised ``torch.distributed``
world out as a `DeviceMesh` of shape ``(pods, n // pods)`` with those
axis names, ranks row-major, so rank r owns client rows
``[r * n_loc, (r + 1) * n_loc)``, as ``shard_map`` splits the client axis.

`run_on_client_mesh` starts such a world on one host: ``world`` spawned
processes, gloo over a ``file://`` store, one CPU thread each. It is the
counterpart of `repro`'s forced host devices. On a card every rank uses
the same device; gloo moves what crosses ranks
(`repro_torch.sharding.collectives` says how), and every kernel still
runs on the card.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXES = ("pod", "data")
#: the kernels the sharded DPFL paths launch, built once by the launcher
#: before it spawns the ranks (so they never race on the build)
CLIENT_MESH_KERNELS = ("graph_mix", "sparse_graph_mix",
                       "compressed_graph_mix")


def make_client_mesh(n_devices: Optional[int] = None, *, pods: int = 1,
                     device_type: Optional[str] = None):
    """The ``('pod', 'data')`` `DeviceMesh` of shape ``(pods, n // pods)``
    over the initialised world (``n`` defaults to, and must equal, its
    size). ``device_type`` defaults to ``cuda`` where there is a card.
    Raises ``ValueError`` where ``n`` does not split into ``pods``."""
    from torch.distributed.device_mesh import DeviceMesh

    if n_devices is not None and n_devices % pods:
        raise ValueError(f"{n_devices} devices not divisible into {pods} "
                         f"pods")
    if not dist.is_initialized():
        raise RuntimeError("make_client_mesh: torch.distributed is not "
                           "initialised (run_on_client_mesh does it)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n % pods:
        raise ValueError(f"{n} devices not divisible into {pods} pods")
    if n != world:
        raise ValueError(f"make_client_mesh: {n} devices, but the world "
                         f"has {world} processes (one per shard)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(pods, n // pods),
                      mesh_dim_names=AXES)


def _rank_main(rank, world, pods, device, init_file, timeout, fn, args,
               results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        mesh = make_client_mesh(world, pods=pods, device_type=dev.type)
        out = fn(mesh, dev, *args)
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_client_mesh(fn: Callable, world: int, *, pods: int = 1,
                       device="cuda", init_file: Optional[str] = None,
                       args: tuple = (), timeout: float = 900.0):
    """Run ``fn(mesh, device, *args)`` on every rank of a ``world``-process
    client mesh of ``pods`` pods and return rank 0's result.

    Each rank is a process spawned with the ``spawn`` start method: gloo
    from the ``file://`` store ``init_file`` (default: a fresh file in a
    temporary directory; it must not exist yet), one CPU thread, the
    mesh of `make_client_mesh`, every rank on ``device``. ``fn`` and its
    arguments are pickled, so ``fn`` is a module-level function; rank 0's
    result comes back pickled. On a CUDA device the kernels of
    `CLIENT_MESH_KERNELS` are built here first. Any rank's exception is
    raised here (``RuntimeError`` carrying its traceback), the other
    ranks are stopped, and so is a rank that dies or outlasts
    ``timeout`` seconds."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build(CLIENT_MESH_KERNELS)
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="client_mesh_")
        init_file = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, pods, str(dev), init_file, timeout,
                               fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    done, errors, out = set(), {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world and not errors:
            try:
                rank, status, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        errors[r] = f"rank {r} exited with {p.exitcode}"
                if time.monotonic() > deadline:
                    errors[-1] = f"the client mesh outlasted {timeout} s"
                continue
            done.add(rank)
            if status == "error":
                errors[rank] = payload
            elif rank == 0:
                out = payload
    finally:
        for p in procs:
            if errors and p.is_alive():
                p.kill()
            p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        first = min(errors)
        raise RuntimeError(f"client mesh of {world} ranks ({pods} pods) "
                           f"failed on rank {first}:\n{errors[first]}")
    return out
