"""Meshes of processes, one per shard (port of
`repro.launch.mesh.make_client_mesh`, `make_host_mesh` and
`make_production_mesh`, and of `repro.sharding.compat.make_mesh`).

`repro` shards the FL client axis over a ``('pod', 'data')`` jax mesh of
devices (``FLEngine.shard_clients``, DESIGN.md §8), and an LM's batch,
experts and decode caches over ``('data', 'model')`` or ``('pod', 'data',
'model')``. Here a shard is a process: `make_mesh` lays the initialised
``torch.distributed`` world out as a `DeviceMesh` of the given shape and
axis names, ranks row-major; `make_client_mesh` is the ``(pods,
n // pods)`` client mesh, so rank r owns client rows
``[r * n_loc, (r + 1) * n_loc)``, as ``shard_map`` splits the client axis.

`run_on_mesh` starts such a world on one host: one spawned process per
shard, gloo over a ``file://`` store, one CPU thread each. It is the
counterpart of `repro`'s forced host devices. On a card every rank uses
the same device; gloo moves what crosses ranks
(`repro_torch.sharding.collectives` says how), and every kernel still
runs on the card. `run_on_client_mesh` is its client-mesh form.

`make_production_mesh` is `repro`'s production mesh as a
`repro_torch.sharding.collectives.ShapeMesh`: shapes and one rank's
coordinates, no processes, for the dry run.
"""
from __future__ import annotations

import datetime
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXES = ("pod", "data")
#: `repro`'s production meshes (``src/repro/launch/mesh.py``): one pod of
#: 16 x 16, and two pods
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
#: the axis names a mesh may carry (`repro`'s)
MESH_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """`repro`'s production mesh, (16, 16) ("data", "model") or, with
    ``multi_pod``, (2, 16, 16) ("pod", "data", "model"), as a `ShapeMesh`
    seen from rank 0: what the dry run runs one rank of."""
    from ..sharding.collectives import ShapeMesh

    shape, axes = PRODUCTION[bool(multi_pod)]
    return ShapeMesh(shape, axes, 0)


def make_client_mesh(n_devices: Optional[int] = None, *, pods: int = 1,
                     device_type: Optional[str] = None):
    """The ``('pod', 'data')`` `DeviceMesh` of shape ``(pods, n // pods)``
    over the initialised world (``n`` defaults to, and must equal, its
    size). ``device_type`` defaults to ``cuda`` where there is a card.
    Raises ``ValueError`` where ``n`` does not split into ``pods``."""
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
    return make_mesh((pods, n // pods), AXES, device_type=device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """The `DeviceMesh` of ``shape`` with axis names ``axes`` (of
    `MESH_AXES`, in `repro`'s order, e.g. ``('data', 'model')`` or
    ``('pod', 'data', 'model')``) over the initialised world, ranks
    row-major: ``repro.sharding.compat.make_mesh(shape, axes)``. The
    shape's product must be the world's size. ``device_type`` defaults
    to ``cuda`` where there is a card."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes) or [a for a in MESH_AXES if a in axes] \
            != list(axes):
        raise ValueError(f"mesh axes {axes} of shape {shape}: names of "
                         f"{MESH_AXES}, in that order, one a dimension")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not "
                           "initialised (run_on_mesh does it)")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"make_mesh: a {shape} mesh has {n} shards, but "
                         f"the world has {world} processes (one per shard)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _rank_main(rank, shape, axes, device, init_file, timeout, fn, args,
               results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=math.prod(shape),
            timeout=datetime.timedelta(seconds=timeout))
        mesh = make_mesh(shape, axes, device_type=dev.type)
        out = fn(mesh, dev, *args)
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_mesh(fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
                device="cuda", init_file: Optional[str] = None,
                args: tuple = (), timeout: float = 900.0):
    """Run ``fn(mesh, device, *args)`` on every rank of a mesh of
    ``shape`` and axis names ``axes`` (`make_mesh`) and return rank 0's
    result.

    Each rank is a process spawned with the ``spawn`` start method: gloo
    from the ``file://`` store ``init_file`` (default: a fresh file in a
    temporary directory; it must not exist yet), one CPU thread, the
    mesh of `make_mesh`, every rank on ``device``. ``fn`` and its
    arguments are pickled, so ``fn`` is a module-level function; rank 0's
    result comes back pickled. On a CUDA device every kernel of the port
    (`repro_torch.kernels._build.SOURCES`: the Eq.-4 mixes, attention and
    the rest, with the backwards that local training launches) is built
    here first, so the ranks never race on a build. Any rank's exception
    is raised here (``RuntimeError`` carrying its traceback), the other
    ranks are stopped, and so is a rank that dies or outlasts
    ``timeout`` seconds."""
    shape, axes = tuple(shape), tuple(axes)
    world = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build()
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="mesh_")
        init_file = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, shape, axes, str(dev), init_file, timeout,
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
                    errors[-1] = f"the mesh outlasted {timeout} s"
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
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} of {world} ranks "
                           f"failed on rank {first}:\n{errors[first]}")
    return out


def run_on_client_mesh(fn: Callable, world: int, *, pods: int = 1,
                       device="cuda", init_file: Optional[str] = None,
                       args: tuple = (), timeout: float = 900.0):
    """`run_on_mesh` on the client mesh of ``world`` ranks in ``pods``
    pods (`make_client_mesh`): ``fn(mesh, device, *args)`` on every
    rank, rank 0's result returned. Raises ``ValueError`` where
    ``world`` does not split into ``pods``."""
    if world % pods:
        raise ValueError(f"{world} devices not divisible into {pods} pods")
    return run_on_mesh(fn, (pods, world // pods), AXES, device=device,
                       init_file=init_file, args=args, timeout=timeout)
