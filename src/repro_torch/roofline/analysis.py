"""Roofline terms of one step, counted by running it on "meta" tensors
(the port's counterpart of `repro.roofline.analysis`, which reads XLA's
compiled HLO and cost analysis).

`count_step` runs a step of the port's own code on "meta" tensors, as one
rank of a mesh (`repro_torch.sharding.collectives.ShapeMesh`), and
counts:

* FLOPs: each aten op's by ``torch.utils.flop_counter``'s formulas
  (`OpCounter`: FlopCounterMode's counts without FlopCounterMode, whose
  module hooks hold tensors alive and would swell the peak), plus each
  kernel's ``work`` (`repro_torch.kernels.meta`: a kernel on
  "meta" launches nothing, so its operations are its module's count);
* HBM bytes: every aten op reads its inputs once and writes its outputs
  once (views and bare allocations move nothing), plus the kernels'
  ``work``. Nothing is fused, so this is an upper bound on what a fused
  program moves; the record says so;
* the peak: every storage the step allocates, each rounded up to the
  CUDA caching allocator's 512 bytes, live from its allocation to its
  release (`PeakTracker`), over what was allocated before the step;
* collective bytes: the `CallRecord`s of the step's collectives, each
  the bytes its rank receives (`repro_torch.analysis.commaudit.
  wire_bytes`).

A meta run executes every loop iteration, so it needs no counterpart of
`repro`'s ``roofline/hlo.py``, which multiplies XLA's while bodies by
their trip counts.

`roofline_terms` turns the counts into times at a card's rates: compute
at the peak rate of the step's dtype, memory at the HBM bandwidth,
collectives at one link's bandwidth. The rates are data-sheet numbers
(`CARDS`), so every term is a model, not a measurement.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from collections import Counter, defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary


class Card(NamedTuple):
    """A card's data-sheet rates: HBM bytes/s, fp32 FLOP/s outside the
    tensor cores, dense bf16 FLOP/s on the tensor cores, streaming
    multiprocessors, one direction of its NVLink (bytes/s) and its
    memory (bytes)."""
    hbm_bw: float
    fp32_flops: float
    bf16_flops: float
    sms: int
    link_bw: float
    memory: float


#: NVIDIA data sheets. A kernel's bound takes the rate of its inputs'
#: type (a kernel on bf16 inputs could use the tensor cores); an fp32
#: step runs its products in IEEE fp32 (TF32 is off in the port). Link:
#: half the data sheet's bidirectional NVLink rate (H100 SXM and H200 900
#: GB/s over 18 links; the PCIe and NVL cards' bridges 600 GB/s).
CARDS: Dict[str, Card] = {
    "H200": Card(4.8e12, 67e12, 989e12, 132, 450e9, 141e9),
    "H100 PCIe": Card(2.0e12, 51e12, 756e12, 114, 300e9, 80e9),
    "H100 NVL": Card(3.9e12, 60e12, 835e12, 132, 300e9, 94e9),
    "H100": Card(3.35e12, 67e12, 989e12, 132, 450e9, 80e9)}


def card_for(name: str) -> Optional[Card]:
    """The `CARDS` row whose key ``name`` (a device name, e.g. "NVIDIA
    H100 80GB HBM3") contains, the first in the table's order; None."""
    for key, card in CARDS.items():
        if key in name:
            return card
    return None


@dataclasses.dataclass(frozen=True)
class HW:
    """The card a roofline is drawn for: a `CARDS` row and its name."""
    name: str = "H100"

    @property
    def card(self) -> Card:
        return CARDS[self.name]

    def peak(self, dtype: str) -> float:
        return self.card.bf16_flops if dtype == "bfloat16" \
            else self.card.fp32_flops


def _round(nbytes: int, to: int = 512) -> int:
    return -(-nbytes // to) * to


class PeakTracker(TorchDispatchMode):
    """The bytes live on the device while it is active: every storage an
    op makes off the host (the step's "meta" or CUDA tensors; the host's
    own arithmetic is not device memory), rounded up to ``round_to``
    bytes (the caching allocator's 512), counted from its first sight to
    its release. ``peak`` is the
    most at once; storages alive before the block (which in-place ops
    and views hand back) are not counted."""

    def __init__(self, round_to: int = 512):
        super().__init__()
        self.round_to = round_to
        self.live = WeakIdKeyDictionary()
        self.now = 0
        self.peak = 0

    def _free(self, n: int):
        self.now -= n

    def track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self.live:
            return
        n = _round(st.nbytes(), self.round_to)
        self.live[st] = n
        weakref.finalize(st, self._free, n)
        self.now += n
        self.peak = max(self.peak, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # an in-place op or a view returns storage it was given: no new
        # allocation, whenever that storage was made
        given = {t.untyped_storage()._cdata
                 for t in tree_leaves((args, kwargs or {}))
                 if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "cpu" and \
                    t.untyped_storage()._cdata not in given:
                self.track(t)
        return out


#: ops that allocate without writing, or only relabel
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "set_"}


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and
                              not r.alias_info.is_write for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    # an expanded (stride 0) tensor reads no more than its storage
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.join(_ROOT, "roofline"), os.path.join(_ROOT, "kernels",
                                                       "meta.py"))


def call_site() -> str:
    """Where the current op comes from: in a backward pass the autograd
    node running it ("backward:MmBackward0"), else the innermost frame in
    the port's package ("models/lm.py:attn_apply"), else "other"."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_ROOT) and not path.startswith(_SKIP):
            return f"{os.path.relpath(path, _ROOT)}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "other"


class OpCounter(TorchDispatchMode):
    """Each aten op's HBM bytes and flops while active: its device tensors
    read once and its outputs written once (views, bare allocations and
    host tensors move no HBM bytes), its flops by FlopCounterMode's
    formulas (``flop_registry``). ``bytes``, ``flops``; ``by_op`` ({aten
    op: flops}); ``by_site`` ({`call_site`: [bytes, flops]}): `repro`'s
    breakdown groups the HLO by its op_name metadata, this one by where
    the op was called, since the port's layers are functions, not module
    calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.by_op: Dict[str, int] = Counter()
        self.by_site: Dict[str, List[int]] = defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet.__name__ in _FREE or _is_view(func):
            return func(*args, **kwargs)
        if packet not in flop_registry and not \
                torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                               "Meta"):
            # an op with no kernel of its own (``matmul`` under inference
            # mode) is counted as the ops it decomposes into, as the
            # dispatcher runs it; one with a kernel (``silu_backward``)
            # runs whole, as on the card
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        seen, n = set(), 0
        for t in tree_leaves((args, kwargs)) + tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "cpu" \
                    and id(t) not in seen:
                seen.add(id(t))
                n += _nbytes(t)
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        self.bytes += n
        self.flops += flops
        if flops:
            self.by_op[packet.__name__] += flops
        row = self.by_site[call_site()]
        row[0] += n
        row[1] += flops
        return out


@dataclasses.dataclass
class StepCount:
    """What `count_step` counted of one step on one rank.

    flops / hbm_bytes: the aten ops' plus the kernels' (``kernel_*``
    alone); peak_bytes: the most bytes live at once over the step's own
    allocations; collective_bytes: the bytes this rank receives, summed
    over ``records`` (its `CallRecord`s); kernels: the `KernelCall`s;
    by_site: {call site: [bytes, flops]} of the aten ops (`OpCounter`);
    flops_by_op: aten op -> flops (what the "Global" row of
    FlopCounterMode's table holds)."""
    flops: int
    hbm_bytes: int
    peak_bytes: int
    collective_bytes: int
    kernel_flops: int
    kernel_bytes: int
    kernels: list
    records: list
    by_site: Dict[str, List[int]]
    flops_by_op: Dict[str, int]
    output: object = None


def count_step(fn: Callable, *, hw: HW = HW()) -> StepCount:
    """Run ``fn()`` (a step on "meta" tensors) once and count it: the
    aten ops by `OpCounter`, the peak by `PeakTracker`, the kernels'
    shape-only calls (their ``work``, planned for ``hw``'s SM count) and
    the collectives' `CallRecord`s."""
    from ..analysis.commaudit import wire_bytes
    from ..kernels import meta as kmeta
    from ..sharding import collectives as coll

    # the tracker beneath the counter: it sees the ops a composite op
    # decomposes into (a copy that ``reshape`` makes inside ``matmul``
    # under inference mode), which the card allocates too
    with kmeta.target(hw.card.sms), kmeta.recording() as kcalls, \
            coll.recording() as recs, PeakTracker() as peak, \
            OpCounter() as oc:
        out = fn()
    k_flops = sum(c.flops for c in kcalls)
    k_bytes = sum(c.nbytes for c in kcalls)
    return StepCount(
        flops=oc.flops + k_flops, hbm_bytes=oc.bytes + k_bytes,
        peak_bytes=peak.peak,
        collective_bytes=sum(wire_bytes(c) for c in recs),
        kernel_flops=k_flops, kernel_bytes=k_bytes, kernels=list(kcalls),
        records=list(recs), by_site=dict(oc.by_site),
        flops_by_op=dict(oc.by_op), output=out)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   hw: HW = HW(), dtype: str = "float32",
                   kernels: List = ()) -> dict:
    """Per-rank times (s) at ``hw``'s rates: compute = the aten flops at
    the peak of ``dtype`` plus each kernel's at its inputs' dtype's,
    memory = HBM bytes / HBM bandwidth, collective = bytes / one link's
    bandwidth; ``dominant`` the largest. ``flops`` includes the kernels'
    (as `StepCount.flops`)."""
    k_flops = defaultdict(int)
    for c in kernels:
        k_flops[c.dtype] += c.flops
    aten = flops - sum(k_flops.values())
    compute_s = aten / hw.peak(dtype) + sum(
        f / hw.peak(dt) for dt, f in k_flops.items())
    terms = {"compute_s": compute_s,
             "memory_s": hbm_bytes / hw.card.hbm_bw,
             "collective_s": collective_bytes / hw.card.link_bw}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant,
            "step_time_lower_bound_s": terms[dominant]}


def analyze_count(count: StepCount, hw: HW = HW(), dtype: str = "float32",
                  modelled_collective_bytes: int = 0) -> dict:
    """The roofline record of a `StepCount`: per-device counts, the peak
    against the card's memory, and `roofline_terms`, the collective term
    over the counted bytes plus ``modelled_collective_bytes`` (the
    exchanges a step needs that the port has no code for, from the layer
    shapes)."""
    coll_bytes = count.collective_bytes + modelled_collective_bytes
    return {
        "per_device": {
            "flops": count.flops, "hbm_bytes": count.hbm_bytes,
            "kernel_flops": count.kernel_flops,
            "kernel_bytes": count.kernel_bytes,
            "collective_bytes": coll_bytes,
            "collective_bytes_counted": count.collective_bytes,
            "collective_bytes_modelled": modelled_collective_bytes,
            "collective_calls": len(count.records),
            "kernel_calls": dict(Counter(c.name for c in count.kernels)),
        },
        "hbm_bytes_note": "unfused upper bound: every aten op reads its "
                          "inputs and writes its outputs once, plus each "
                          "kernel's work",
        "card": hw.name,
        "rates_note": "modelled from the card's data-sheet rates "
                      "(roofline.analysis.CARDS), not measured",
        "roofline": roofline_terms(count.flops, count.hbm_bytes, coll_bytes,
                                   hw, dtype, count.kernels),
    }
