"""Reduce a ``torch.profiler`` trace of the timed window to what the
per-layer metrics read.

Device operations (kernels, copies, fills; not the ranges' own mirrors on
the device timeline) come from the profiler's device trace. Each is
charged to the host ranges (`spans.PREFIX` layers) that were open when
it was launched: its launch is the CUDA runtime call with the same
correlation id, so a kernel launched from the autograd engine's thread during a local
train counts for the local train. ``busy_s`` is the union of the device
operations' intervals, and a layer's device time the union of its own
operations' intervals (cuDNN's grouped convolutions run kernels side by
side, so a sum of durations would count their overlap twice).
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .spans import PREFIX

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    rounds: int
    busy_s: float = 0.0
    kernels: int = 0
    device_ops: int = 0
    #: device seconds in which an operation launched inside the layer's
    #: range ran (the union of their intervals: operations overlap)
    layer_s: Dict[str, float] = field(default_factory=dict)
    #: device seconds by operation name
    by_name: Dict[str, float] = field(default_factory=dict)
    #: idle seconds by the innermost layer open on the host at the gap
    idle_by_layer: Dict[str, float] = field(default_factory=dict)
    #: device operations whose launch time could not be found
    unattributed: int = 0


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    return kind() if callable(kind) else ""


#: host-side CUDA runtime and driver calls (a launch, a copy, a fill)
_API = re.compile(r"^cu(da)?[A-Z]")


def _annotation(ev, name: str) -> bool:
    """A range's mirror on the device timeline, not a device operation."""
    flag = getattr(ev, "is_user_annotation", None)
    return name.startswith(PREFIX) or (callable(flag) and bool(flag())) \
        or _kind(ev) == "gpu_user_annotation"


def _seconds(merged) -> float:
    return sum(e - s for s, e in merged) / 1e9


def _union(intervals: List[Tuple[int, int]]):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


class _Ranges:
    """The host intervals of one layer's ranges, for point lookups."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = _union(spans)
        self.starts = [s for s, _ in self.spans]

    def covers(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def reduce(events, window_s: float, rounds: int) -> Trace:
    """``events``: the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    out = Trace(window_s=window_s, rounds=rounds)
    device = []                      # (start, end, name, corr, kind)
    launch_at: Dict[int, int] = {}   # runtime correlation id -> host time
    ranges: Dict[str, list] = defaultdict(list)
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        if ev.device_type() == DeviceType.CUDA:
            kind = _kind(ev)
            if _annotation(ev, name) or (kind and kind not in _DEVICE_KINDS):
                continue
            device.append((start, start + ev.duration_ns(), name,
                           ev.correlation_id(), kind))
        elif name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((start,
                                               start + ev.duration_ns()))
        elif _API.match(name) or _kind(ev) in ("cuda_runtime", "cuda_driver"):
            launch_at[ev.correlation_id()] = start
    layers = {name: _Ranges(sp) for name, sp in ranges.items()}
    layer_ops: Dict[str, list] = defaultdict(list)
    by_name: Dict[str, int] = defaultdict(int)
    for start, end, name, corr, kind in device:
        dur = end - start
        by_name[name] += dur
        out.device_ops += 1
        if kind == "kernel" or (not kind and not name.startswith(
                ("Memcpy", "Memset"))):
            out.kernels += 1
        t = launch_at.get(corr)
        if t is None:
            out.unattributed += 1
            continue
        for layer, rng in layers.items():
            if rng.covers(t):
                layer_ops[layer].append((start, end))
    merged = _union([(s, e) for s, e, *_ in device])
    out.busy_s = _seconds(merged)
    out.layer_s = {k: _seconds(_union(v)) for k, v in layer_ops.items()}
    out.by_name = {k: v / 1e9 for k, v in by_name.items()}
    idle: Dict[str, int] = defaultdict(int)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        open_ = [(rng.spans[bisect.bisect_right(rng.starts, end) - 1][0],
                  layer) for layer, rng in layers.items() if rng.covers(end)]
        # the innermost range open: the one that started last
        label = max(open_)[1] if open_ else "outside the layers' spans"
        idle[label] += nxt - end
    out.idle_by_layer = {k: v / 1e9 for k, v in idle.items()}
    return out


def top(d: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
