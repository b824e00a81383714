"""Shape-only calls of the kernels, on "meta" tensors.

Each kernel wrapper takes "meta" tensors as it takes CUDA ones: it runs
the kernel's checks and allocates what its launch allocates (outputs,
workspaces and scratch, in the same order and shapes), then returns
those tensors without launching. A check that the card would fail
raises a `Refusal` on either device. "meta" tensors hold no values, so
nothing is computed and nothing falls back to a plain version: a CUDA
tensor still launches or raises, a CPU tensor still takes the plain
version (`repro_torch.kernels.ops`).

Inside a `recording` block each such call leaves a `KernelCall`: the
kernel, and the bytes and operations of one call (each module's
``work``), which `repro_torch.roofline.analysis.count_step` adds to the
step's count. A kernel whose launch plan reads the card (K4's backward
reads its SM count) takes it from `target`, set by the caller from the
target card's row of the hardware table; it is never guessed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One shape-only call: ``name`` (the kernel's `_build` name), the
    bytes it must move and the operations it must do (its ``work``), and
    the dtype of its inputs (which peak rate bounds it)."""
    name: str
    nbytes: int
    flops: int
    dtype: str


_recorders: List[List[KernelCall]] = []
_sms: List[int] = []


class Refusal(Exception):
    """A check refusing a call that the card cannot run as asked: a dtype
    no kernel takes, a size past a kernel's limits or CUDA's grid, a
    split that does not divide. The dry run records a step that raises
    one as "refused" (`repro_torch.launch.dryrun`); any other error is
    its own fault. Each is also the built-in error its check raises."""


class RefusedValue(Refusal, ValueError):
    pass


class RefusedType(Refusal, TypeError):
    pass


class RefusedNotImplemented(Refusal, NotImplementedError):
    pass


@contextlib.contextmanager
def recording():
    """Record the shape-only kernel calls made inside the block: yields a
    list that gains one `KernelCall` a call, in call order."""
    calls: List[KernelCall] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.pop()


def record(name: str, work, dtype) -> None:
    """Append the call of kernel ``name`` with ``work`` = (bytes, flops)
    on ``dtype`` inputs to every active `recording`."""
    call = KernelCall(name, int(work[0]), int(work[1]),
                      str(dtype).replace("torch.", ""))
    for calls in _recorders:
        calls.append(call)


@contextlib.contextmanager
def target(sms: int):
    """Plan the shape-only calls inside the block for a card of ``sms``
    streaming multiprocessors (the hardware table's row)."""
    _sms.append(int(sms))
    try:
        yield
    finally:
        _sms.pop()


def target_sms() -> int:
    """The SM count of the innermost `target`; raises ``ValueError``
    outside one."""
    if not _sms:
        raise ValueError("a shape-only kernel plan needs the target card's "
                         "SM count: call it inside kernels.meta.target(sms)")
    return _sms[-1]
