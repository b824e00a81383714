"""Spans and counters at the layer boundaries of the DPFL round.

Tracing is on while a ``torch.profiler`` profile runs (torch's own
enabled flag, the one ``record_function`` reads) or between `enable`
and `disable` (or inside ``with tracing():``). Off, a `span` pushes its
name on the stack of open spans and pops it, and does nothing else: it
keeps no record, opens no profiler range and adds no device operation.
On, a span also opens ``torch.profiler.record_function("repro::<name>")``,
so that it lies on the profiler's host timeline (and its mirror on the
device's), and keeps a `Record` in memory: its name, its id, the id of
the recorded span it opened inside, the round ``t`` of the enclosing
``round`` span, and its host start and end in ns by `time.time_ns`,
the clock the profiler's events use (``start_ns()`` of a kineto event),
so that a record and the device operations launched inside it line up.

`count` adds to a host int and `tally` adds a device scalar into a
device accumulator, both only while tracing is on. A tally never reads
the device, so a round may tally inside `guards.no_transfer`'s fence.
`snapshot` returns what was kept, with the tallies read to host ints:
call it after a synchronize, outside the fence. `reset` clears it.

The stack of open spans is kept whether tracing is on or off: a
collective's `CallRecord` takes its tag from it
(`repro_torch.sharding.collectives`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

#: the prefix of a span's ``record_function`` range
PREFIX = "repro::"

#: torch's flag: a profiler is running (what ``record_function`` reads)
_profiler_enabled = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    """One span that closed while tracing was on."""
    name: str
    id: int
    #: the id of the innermost recorded span it opened inside, or None
    parent: Optional[int]
    #: the round of the enclosing ``round`` span, or None outside one
    t: Optional[int]
    #: host clock (`time.time_ns`, the profiler's), ns
    start_ns: int
    end_ns: int


class _State:
    def __init__(self):
        self.enabled = False
        #: the names of the open spans, innermost last, traced or not
        self.stack: List[str] = []
        #: the open spans that keep a record, innermost last
        self.recorded: List["span"] = []
        self.next_id = 0
        self.records: List[Record] = []
        self.counts: Dict[str, int] = {}
        self.tallies: Dict[str, torch.Tensor] = {}


_state = _State()


def active() -> bool:
    """Whether spans, counts and tallies are kept now."""
    return _state.enabled or _profiler_enabled()


def enable():
    """Keep spans, counts and tallies with no profiler running."""
    _state.enabled = True


def disable():
    """Undo `enable` (a running profiler still turns tracing on)."""
    _state.enabled = False


@contextlib.contextmanager
def tracing():
    """`enable` for the block, then the setting it found."""
    was = _state.enabled
    _state.enabled = True
    try:
        yield
    finally:
        _state.enabled = was


def stack() -> Tuple[str, ...]:
    """The names of the spans open now, outermost first."""
    return tuple(_state.stack)


class span:
    """``with span(name):`` marks the block as the layer ``name``. A
    ``round`` span gives its round ``t`` to every record inside it."""
    __slots__ = ("name", "t", "_id", "_range", "_start")

    def __init__(self, name: str, t: Optional[int] = None):
        self.name, self.t = name, t
        self._range = None

    def __enter__(self):
        _state.stack.append(self.name)
        if active():
            st = _state
            outer = st.recorded[-1] if st.recorded else None
            self._id = st.next_id
            st.next_id += 1
            if self.t is None and outer is not None:
                self.t = outer.t
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._start = time.time_ns()
            self._range.__enter__()
            st.recorded.append(self)
        return self

    def __exit__(self, *exc):
        rng = self._range
        if rng is not None:
            st = _state
            st.recorded.pop()
            rng.__exit__(*exc)
            outer = st.recorded[-1]._id if st.recorded else None
            st.records.append(Record(self.name, self._id, outer, self.t,
                                     self._start, time.time_ns()))
            self._range = None
        _state.stack.pop()
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the host counter ``name`` while tracing is on."""
    if active():
        _state.counts[name] = _state.counts.get(name, 0) + n


def tally(name: str, x: torch.Tensor, n: int = 1):
    """Add ``n`` times the device scalar ``x`` (an integer tensor) into the
    device accumulator ``name`` while tracing is on; reads nothing back."""
    if not active():
        return
    acc = _state.tallies.get(name)
    if acc is None:
        acc = _state.tallies[name] = torch.zeros((), dtype=torch.int64,
                                                 device=x.device)
    acc.add_(x, alpha=n)


def snapshot() -> dict:
    """``{"records": [Record, ...] in the order they closed, "counts":
    {name: int}, "tallies": {name: int}}``: what tracing kept since the
    last `reset`. Reads the tallies off the device."""
    return {"records": list(_state.records),
            "counts": dict(_state.counts),
            "tallies": {k: int(v.item()) for k, v in _state.tallies.items()}}


def reset():
    """Forget the records, counts and tallies (open spans stay open)."""
    _state.records.clear()
    _state.counts.clear()
    _state.tallies.clear()
