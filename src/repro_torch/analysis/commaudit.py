"""Wire-bytes audit of the DPFL communication claims (port of
`repro.analysis.commaudit`, DESIGN.md §14).

`DPFLResult.comm_bytes` is arithmetic: realized downloads x the codec's
static wire size. This module holds it against the bytes the mesh's
collectives move. `audit_config` runs one round of the exact
``round_step`` that `run_dpfl` dispatches (`core.dpfl.dpfl_round_step`)
on the engine's mesh; every collective call of
`repro_torch.sharding.collectives` leaves a `CallRecord` on its rank;
`audit_records` classifies each rank's calls against the codec's payload
catalogue and `reconcile` holds the received wire bytes against the
claimed bytes in exact Python ints. `repro` reads the same facts from
the compiled round's HLO: each collective's kind, operand bytes, group
and place in the program.

Replication factor (`repro`'s derivation, unchanged). One round claims
``E x bpm`` bytes (E realized downloads, bpm = `compress.bytes_per_model`).
On D ranks the engine simulates those downloads with one panel exchange
per payload part: the dense mix all-gathers each part (each rank sends
its S = N/D rows, S·b_part bytes), the neighbor-list mix rotates each
part D-1 steps. Counting RECEIVED bytes over all ranks:

  all-gather:          S·b_part x (G-1) recv/rank x D ranks
  ppermute:            S·b_part x 1 recv/rank x D ranks, x (D-1) steps

Both sum over the parts (Σ b_part = bpm) to the same total:

  wire_model = N x bpm x (D-1)            per round, every codec
             = claimed x R,   R = N(D-1)/E

On one device there is no collective at all: wire = 0. `reconcile`
asserts ``wire x E == claimed x N x (D-1)`` cross-multiplied in exact
ints. E is static (= N·min(budget, N-1)) exactly when ``cfg.random_graph``
and full participation; greedy and participating configs get the
structural audit (payload classification, refresh attribution, no
unexplained model-sized call) without the exact count.

Classification is exact-match, not a threshold: a call is a model
payload iff it is an all-gather or a ppermute whose per-rank operand
bytes hit the codec catalogue. A call inside the span ``"refresh"``
(the GGC refresh: `repro`'s ``cond`` branch; `collectives.TAGS`) is
attributed and not charged; the refresh probes the decoded peers, so
under a lossy codec the decoded fp32 panel (S·4P) is a refresh part too.
A call whose site lies in model or training code (``/models/``,
``/data/``, ``fl/engine.py``, ``optim``) is the simulation's own
traffic: reported under "training" and never a failure; a call from
``prng.py`` is "rng". Everything else stays under one raw model (4P
bytes x its calls on the rank: "control") or FAILS the audit as
UNEXPLAINED.

What differs from `repro`: a record is one rank's call, where an HLO
collective stands for every device. So a row here is one rank's calls
at one site (its ``path`` starts with the rank), `wire_bytes` counts the
calling rank's received bytes, and the report sums the rows of every
rank; the part-exchange count of the exact mode is held on each rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..fl import compress as _compress

__all__ = ["AuditRow", "AuditReport", "payload_catalogue",
           "wire_bytes", "audit_records", "audit_config",
           "static_downloads_per_round", "reconcile", "REFRESH"]

#: the span of the GGC refresh, the region of the collectives inside it
#: (`collectives.TAGS`)
REFRESH = "refresh"
#: call sites of the simulation's own traffic (`repro`'s ``_TRAINING_SRC``)
_TRAINING_SRC = ("/models/", "/data/", "fl/engine.py", "optim")
#: call sites of PRNG traffic
_RNG_SRC = ("prng.py",)
#: the ops that can carry a payload
_PAYLOAD_OPS = ("all_gather", "ppermute")


@dataclass
class AuditRow:
    """One rank's calls of one op at one site with one size, group and
    region, classified: ``kind`` is the `collectives` op, ``name`` the
    call site, ``path`` the rank, then the region tag, if any."""
    kind: str
    name: str
    operand_bytes: int
    mult: int
    path: tuple
    classification: str      # "payload:<part>" | "refresh:<part>" |
    #                          "training" | "rng" | "control" |
    #                          "UNEXPLAINED"
    wire_bytes: int          # received bytes of the rank, x mult


@dataclass
class AuditReport:
    n_clients: int
    n_devices: int
    n_params: int
    codec: str                      # "none" | "identity" | "topk" | "int8"
    graph_repr: str
    bytes_per_model: int
    rows: List[AuditRow] = field(default_factory=list)
    wire_model_bytes: int = 0       # payload wire per round (refresh out)
    wire_refresh_bytes: int = 0     # payload-sized wire of the refresh
    wire_training_bytes: int = 0    # the simulation's own traffic
    wire_control_bytes: int = 0
    expected_wire_model_bytes: int = 0   # N x bpm x (D-1)
    claimed_downloads: Optional[int] = None  # E, when statically derivable
    exact: bool = False             # E static -> reconciliation asserted
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def replication_factor(self) -> Optional[Tuple[int, int]]:
        """R as an exact fraction (N(D-1), E), or None when E is
        round-dependent."""
        if self.claimed_downloads is None:
            return None
        return (self.n_clients * (self.n_devices - 1),
                self.claimed_downloads)

    def table(self) -> str:
        """Human-readable claimed-vs-wire table."""
        hdr = (f"commaudit: N={self.n_clients} D={self.n_devices} "
               f"P={self.n_params} codec={self.codec} "
               f"repr={self.graph_repr} bpm={self.bytes_per_model}")
        lines = [hdr, f"{'collective':<20}{'operand':>10}{'x':>4}"
                      f"{'wire':>14}  class @ path"]
        for r in self.rows:
            lines.append(f"{r.kind:<20}{r.operand_bytes:>10}{r.mult:>4}"
                         f"{r.wire_bytes:>14}  {r.classification} @ "
                         f"{'/'.join(r.path)} {r.name}")
        lines.append(f"wire model/round = {self.wire_model_bytes} "
                     f"(expected N*bpm*(D-1) = "
                     f"{self.expected_wire_model_bytes}), refresh = "
                     f"{self.wire_refresh_bytes}, training = "
                     f"{self.wire_training_bytes}, control = "
                     f"{self.wire_control_bytes}")
        if self.claimed_downloads is not None:
            E = self.claimed_downloads
            lines.append(
                f"claimed/round = {E} downloads x {self.bytes_per_model} "
                f"= {E * self.bytes_per_model} bytes; replication "
                f"R = N(D-1)/E = {self.n_clients * (self.n_devices - 1)}"
                f"/{E}")
        for f in self.failures:
            lines.append(f"FAIL: {f}")
        return "\n".join(lines)


def _codec_name(comp) -> str:
    return "none" if comp is None else comp.codec


def payload_catalogue(comp, n_clients: int, n_devices: int,
                      n_params: int) -> List[Tuple[str, int]]:
    """[(part name, per-rank operand bytes)] one exchange moves. Shard
    rows S = N/D; parts mirror the codec's payload dtypes (topk: fp32
    vals + int32 idx, int8: s8 q + one fp32 scale per model), so the part
    sizes sum to S x bytes_per_model exactly for every codec."""
    S = n_clients // n_devices
    comp = _compress.normalize(comp)
    if comp is None:
        return [("fp32", S * 4 * n_params)]
    if comp.codec == "topk":
        K = _compress.topk_k(comp, n_params)
        return [("vals", S * 4 * K), ("idx", S * 4 * K)]
    if comp.codec == "int8":
        qb = (n_params * comp.quant_bits + 7) // 8
        return [("q", S * qb), ("scale", S * 4)]
    raise ValueError(comp.codec)


def wire_bytes(c, mult: int = 1) -> int:
    """Received bytes of the rank that made call ``c`` (a
    `collectives.CallRecord`), times ``mult`` such calls: all-gather, the
    other G-1 members' operands; ppermute, one operand-sized panel;
    all-reduce (psum, pmax), G-1 partial sums' worth (ring-equivalent).
    G is the call's group. `repro`'s ``wire_bytes(c, n_devices)`` counts
    one HLO collective for all D devices and takes G from the mesh where
    the HLO names no group; a record always carries its group, and the
    sum of this over the D ranks' calls of one collective is `repro`'s
    number."""
    if c.op == "ppermute":
        return c.sent_bytes * mult
    return c.sent_bytes * (c.group_size - 1) * mult


def static_downloads_per_round(cfg, n_clients: int) -> Optional[int]:
    """Realized downloads E per training round when it is a static int:
    the Fig.-3 random graph under full participation downloads each
    client's min(budget, N-1) sampled peers every round. Greedy graphs
    and participation schedules make E data-dependent -> None."""
    if not cfg.random_graph or cfg.participation is not None:
        return None
    budget = cfg.budget if cfg.budget is not None else n_clients - 1
    return n_clients * min(budget, n_clients - 1)


def _merged(records) -> List[Tuple[object, int]]:
    """One rank's `CallRecord`s as (first record, number of calls), the
    calls of one op at one site with one size, group and region merged,
    in first-call order."""
    merged = {}
    for r in records:
        key = (r.op, r.site, r.sent_bytes, r.group_size, r.region)
        first, n = merged.get(key, (r, 0))
        merged[key] = (first, n + 1)
    return list(merged.values())


def audit_records(records: Sequence[Sequence], *, n_clients: int,
                  n_devices: int, n_params: int, compression=None,
                  graph_repr: str = "dense",
                  claimed_downloads: Optional[int] = None) -> AuditReport:
    """Classify one round's collective calls and reconcile. ``records``
    holds each rank's `collectives.CallRecord`s of the round, one list a
    rank (``n_devices`` lists).

    With a static ``claimed_downloads`` (the exact mode: `repro`'s
    ``exact`` default, the only value the port's callers give) it also
    asserts the payload structure on every rank: the part-exchange count
    (dense: one gather a part; sparse: D-1 rotation steps a part) and the
    exact wire total N x bpm x (D-1)."""
    if len(records) != n_devices:
        raise ValueError(f"{len(records)} ranks' records for "
                         f"{n_devices} devices")
    comp = _compress.normalize(compression)
    bpm = _compress.bytes_per_model(comp, n_params)
    D = n_devices
    rep = AuditReport(
        n_clients=n_clients, n_devices=D, n_params=n_params,
        codec=_codec_name(comp), graph_repr=graph_repr,
        bytes_per_model=bpm,
        expected_wire_model_bytes=n_clients * bpm * (D - 1),
        claimed_downloads=claimed_downloads,
        exact=claimed_downloads is not None)

    parts = payload_catalogue(comp, n_clients, D, n_params)
    # size -> label. Parts sharing a byte size (topk vals/idx: 4K each)
    # are indistinguishable on the wire; the accounting below counts
    # PART-EXCHANGES (one per matched call) rather than naming each part
    groups: dict = {}
    for name, b in parts:
        groups.setdefault(b, []).append(name)
    sizes = {b: "|".join(names) for b, names in groups.items()}
    weight = {b: 1 for b in groups}
    total = sum(b for _, b in parts)
    if len(parts) > 1 and total not in sizes:
        sizes[total] = "+".join(name for name, _ in parts)
        weight[total] = len(parts)
    # the refresh probes the decoded peers: under a lossy codec the
    # decoded fp32 panel is what its gather moves
    refresh_sizes = dict(sizes)
    refresh_sizes.setdefault(payload_catalogue(None, n_clients, D,
                                               n_params)[0][1], "decoded")
    raw_model = 4 * n_params

    part_exchanges = [0] * D
    for rank, calls in enumerate(records):
        for c, mult in _merged(calls):
            wb = wire_bytes(c, mult)
            path = (f"rank{rank}",) + ((c.region,) if c.region else ())
            if any(s in c.site for s in _TRAINING_SRC + _RNG_SRC):
                cls = "training" if any(s in c.site for s in
                                        _TRAINING_SRC) else "rng"
                rep.wire_training_bytes += wb
            elif c.region == REFRESH and c.op in _PAYLOAD_OPS and \
                    c.sent_bytes in refresh_sizes:
                cls = f"refresh:{refresh_sizes[c.sent_bytes]}"
                rep.wire_refresh_bytes += wb
            elif c.region != REFRESH and c.op in _PAYLOAD_OPS and \
                    c.sent_bytes in sizes:
                cls = f"payload:{sizes[c.sent_bytes]}"
                rep.wire_model_bytes += wb
                part_exchanges[rank] += weight[c.sent_bytes] * mult
            elif c.sent_bytes * mult >= raw_model:
                cls = "UNEXPLAINED"
                rep.failures.append(
                    f"unexplained model-sized collective at {c.site} "
                    f"({c.op}, {c.sent_bytes} B x{mult} at "
                    f"{'/'.join(path)}) — neither a catalogue payload "
                    f"nor control-sized")
            else:
                cls = "control"
                rep.wire_control_bytes += wb
            rep.rows.append(AuditRow(c.op, c.site, c.sent_bytes, mult,
                                     path, cls, wb))

    if D == 1:
        if rep.wire_model_bytes or rep.wire_refresh_bytes:
            rep.failures.append(
                "single-device round moved payload bytes on wire")
        return rep

    if rep.exact:
        expect_n = (1 if graph_repr == "dense" else D - 1) * len(parts)
        for rank, n in enumerate(part_exchanges):
            if n != expect_n:
                rep.failures.append(
                    f"rank {rank}: {n} payload part-exchange(s) per "
                    f"round, expected {expect_n} ({graph_repr}, "
                    f"{len(parts)} part(s))")
        if rep.wire_model_bytes != rep.expected_wire_model_bytes:
            rep.failures.append(
                f"wire model bytes {rep.wire_model_bytes} != "
                f"N*bpm*(D-1) = {rep.expected_wire_model_bytes}")
    return rep


def reconcile(rep: AuditReport, claimed_bytes_per_round: int) -> None:
    """Assert wire = claimed x N(D-1)/E cross-multiplied in exact ints
    (no float division). ``claimed_bytes_per_round`` is E x bpm — a
    `DPFLResult.comm_bytes` entry or the static derivation."""
    if rep.claimed_downloads is None:
        raise ValueError("reconcile needs a static E "
                         "(report.claimed_downloads)")
    E = rep.claimed_downloads
    if claimed_bytes_per_round != E * rep.bytes_per_model:
        raise AssertionError(
            f"claimed bytes {claimed_bytes_per_round} != E x bpm = "
            f"{E} x {rep.bytes_per_model}")
    lhs = rep.wire_model_bytes * E
    rhs = claimed_bytes_per_round * rep.n_clients * (rep.n_devices - 1)
    if lhs != rhs:
        raise AssertionError(
            f"wire x E = {lhs} != claimed x N(D-1) = {rhs} "
            f"(wire={rep.wire_model_bytes}, claimed="
            f"{claimed_bytes_per_round}, N={rep.n_clients}, "
            f"D={rep.n_devices})")


def audit_config(engine, cfg, records: Optional[list] = None
                 ) -> AuditReport:
    """Run one round of the (engine, cfg) ``round_step`` that `run_dpfl`
    dispatches, from the state `run_dpfl` starts from, and audit its
    collective calls: under a client mesh every rank calls it, each
    rank's calls are gathered, and every rank returns the same report of
    all of them. The only entry most callers need. ``records``, a list,
    gains each rank's `CallRecord`s of the round (one list a rank, in
    rank order)."""
    import torch.distributed as dist

    from ..core.dpfl import dpfl_initial_state, dpfl_round_step
    from ..sharding import collectives as _coll

    state, _ = dpfl_initial_state(engine, cfg)
    step = dpfl_round_step(engine, cfg)
    with _coll.recording() as mine:
        step(state)
    if engine.mesh is None:
        per_rank = [mine]
    else:
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, mine)
    if records is not None:
        records.extend(per_rank)
    N = engine.data.n_clients
    return audit_records(
        per_rank, n_clients=N, n_devices=len(per_rank),
        n_params=engine.n_params, compression=cfg.compression,
        graph_repr=cfg.graph_repr,
        claimed_downloads=static_downloads_per_round(cfg, N))
