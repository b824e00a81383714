"""Runtime guards of the round engine and the serving loop (port of
`repro.analysis.guards`, DESIGN.md §13). Three tools, cheap enough to
leave on:

* :func:`no_transfer` — a fence that turns a host synchronization inside
  the region into an error. On CUDA it is ``torch.cuda.set_sync_debug_mode
  ("error")``, the previous mode restored on exit: any operation that
  waits for the device raises ``RuntimeError``. :func:`allow_transfers`
  re-opens a hole (a history flush, a collective's exchange) inside a
  fenced region and closes it again after.

  `repro`'s fence refuses three classes of transfer: an implicit
  host-to-device commit of a numpy array or Python value, a
  device-to-device copy, and an explicit device-to-host pull. CUDA's
  sync-debug mode catches only the copies that synchronize with the
  host. On an H100 (chip_smoke.py's guards phase and
  tests/test_torch_cuda.py make each of these transfers inside the fence,
  against chip_smoke.py's table ``TRANSFER_FENCED``):

  - ``.item()`` and ``.cpu()`` of a CUDA tensor raise: a pull to pageable
    host memory waits for the device;
  - ``torch.as_tensor(np_array, device="cuda")`` and ``torch.tensor(3.0,
    device="cuda")`` raise: a copy from pageable host memory is a
    blocking ``cudaMemcpy``;
  - a Python scalar in ``x + 1.0`` passes: the scalar rides in the
    kernel's arguments, and nothing is copied;
  - a pinned, non-blocking host-to-device copy passes: it is queued on
    the stream and nothing waits. A round that commits host values this
    way is not caught.

  A device-to-device copy between two cards cannot be shown on a machine
  with one card; a copy within one card never synchronizes and passes.
  torch itself warns that the mode "does not yet detect all
  synchronizing operations": the fence is as wide as the table, no
  wider.

  On the CPU both are no-ops: there is no device to wait for, and this
  build of torch has no ``torch.cuda.get_sync_debug_mode`` to call (it
  raises "Torch not compiled with CUDA enabled"). The CPU tests check
  that, and only the card checks a fence.

* :func:`recompile_sentinel` — asserts how many kernel libraries a region
  compiles or loads. The port has no ``torch.compile`` and no CUDA graph:
  what it can recompile is a kernel library, which `kernels._build` builds
  with ``nvcc`` at first use and loads with ``ctypes`` (its ``counts``).
  A warm region must add none.

* :func:`donation_report` / :func:`assert_donatable` — which round-state
  leaves could be donated to a round: a leaf is donatable when the output
  holds a leaf at the same path with the same shape and dtype, as in
  `repro`. The port also reports which of them the round updated in
  place (the same storage, ``data_ptr``, before and after).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..kernels import _build

__all__ = ["RecompileError", "TransferError", "no_transfer",
           "allow_transfers", "recompile_sentinel", "donation_report",
           "assert_donatable"]

# the CUDA fences entered and not yet left
_depth = 0


class RecompileError(AssertionError):
    """A guarded region compiled or loaded more (or fewer) kernel
    libraries than expected."""


class TransferError(RuntimeError):
    """Names a transfer-guard violation (torch raises its own
    ``RuntimeError``; this name exists so callers can document intent)."""


@contextlib.contextmanager
def no_transfer(device):
    """Fail on a host synchronization inside the region on CUDA
    ``device``; a no-op on any other device. Wrap the unavoidable host
    touches (history flushes, result pulls) in :func:`allow_transfers`."""
    global _depth
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def allow_transfers():
    """Lift the fence of an active :func:`no_transfer` region for the
    block, and restore it after; a no-op where no CUDA fence is active."""
    if not _depth:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _SentinelHandle:
    """Yielded by :func:`recompile_sentinel`; reads `kernels._build`'s
    counts of the watched kernels against their values at entry."""

    def __init__(self, names):
        self.names = list(_build.SOURCES if names is None else names)
        self.start = {n: tuple(_build.counts[n]) for n in self.names}

    def _new(self) -> Dict[str, tuple]:
        return {n: (_build.counts[n][0] - self.start[n][0],
                    _build.counts[n][1] - self.start[n][1])
                for n in self.names}

    def new_builds(self) -> int:
        """``nvcc`` builds since entry."""
        return sum(b for b, _ in self._new().values())

    def new_loads(self) -> int:
        """Library loads since entry."""
        return sum(n for _, n in self._new().values())

    def new_compiles(self) -> int:
        """Kernels that gained a library since entry: each built, loaded,
        or both (a first use builds where the library is missing, then
        loads) counts once."""
        return sum(max(b, n) for b, n in self._new().values())

    def compiled_names(self) -> List[str]:
        return [k for k, (b, n) in self._new().items() if b or n]


@contextlib.contextmanager
def recompile_sentinel(names=None, *, expect_new: int = 1,
                       max_new: Optional[int] = None):
    """Assert how many of the kernels ``names`` (default: every kernel of
    `kernels._build.SOURCES`) gain a library inside the region
    (`_SentinelHandle.new_compiles`): exactly ``expect_new``, or at most
    ``max_new`` when given. A warm region adds 0; a kernel's first use
    in a process adds 1. An exception from the body propagates and skips
    the check. Raises :class:`RecompileError` on violation."""
    handle = _SentinelHandle(names)
    yield handle
    got = handle.new_compiles()
    if max_new is not None:
        if got > max_new:
            raise RecompileError(
                f"recompile_sentinel: {got} new compile(s) "
                f"({handle.compiled_names()}), expected at most {max_new}")
    elif got != expect_new:
        raise RecompileError(
            f"recompile_sentinel: {got} new compile(s) "
            f"({handle.compiled_names()}), expected exactly {expect_new} "
            f"— a kernel library was built or loaded inside the region")


def _leaves(tree, path: str = "") -> Dict[str, Any]:
    """{path: leaf} of the tensors in ``tree``, paths written as
    `repro`'s ``jax.tree_util.keystr`` writes them (``.field`` for a
    dataclass field, ``['key']`` for a dict key in sorted order, ``[i]``
    for a list item). Leaves that are not tensors (the port's host-int
    round counter) and None are left out."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.update(_leaves(getattr(tree, f.name), f"{path}.{f.name}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{path}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}[{i}]"))
    return out


def _copy(tree):
    """``tree`` with every tensor cloned and the structure rebuilt."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _copy(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree


def donation_report(fn, *args) -> Dict[str, Any]:
    """Which tensor leaves of ``args[0]`` could be donated to ``fn``:
    ``{"donatable": [...], "blocked": [...], "in_place": [...],
    "donatable_bytes": int}``. A leaf is donatable when ``fn``'s output
    holds a leaf at the same path with the same shape and dtype, else
    blocked; ``in_place`` lists the donatable leaves whose storage the
    output keeps (``fn`` updated them in place or passed them through).

    `repro` traces ``fn`` with ``jax.eval_shape`` and runs nothing. Here
    ``fn`` runs once, on a copy of ``args[0]`` (the caller's state is
    left as it was): the port's kernels cannot run on "meta" tensors. The
    port keeps the round counter ``t`` as a host int, not a tensor, so it
    is in neither list where `repro`'s lists hold ``.t``."""
    state = _copy(args[0])
    before = _leaves(state)
    ptrs = {p: t.data_ptr() for p, t in before.items()}
    after = _leaves(fn(state, *args[1:]))
    report = {"donatable": [], "blocked": [], "in_place": [],
              "donatable_bytes": 0}
    for path, leaf in before.items():
        peer = after.get(path)
        if peer is not None and peer.shape == leaf.shape and \
                peer.dtype == leaf.dtype:
            report["donatable"].append(path)
            report["donatable_bytes"] += leaf.numel() * leaf.element_size()
            if peer.data_ptr() == ptrs[path]:
                report["in_place"].append(path)
        else:
            report["blocked"].append(path)
    return report


def assert_donatable(fn, *args):
    """Raise if any leaf of ``args[0]`` could not be donated to ``fn``."""
    rep = donation_report(fn, *args)
    if rep["blocked"]:
        raise AssertionError(
            f"buffers not donatable (shape/dtype changes across the call): "
            f"{rep['blocked']}")
    return rep
