"""Device-resident FL round engine (port of `repro.fl.round_engine`).

One federated round (local train -> aggregate -> eval -> best-model
tracking) is ``round_step(state) -> state`` over a `RoundState` whose
tensors stay on the device: flattened client params, best-on-validation
tracking, the collaboration graph, comm counters and history buffers.
The round counter is a host int, so per-round decisions (refresh or not,
history slot) are Python branches that never read the device.

`run_rounds` drives the rounds with no device-to-host sync: the loop
runs inside `repro_torch.analysis.guards.no_transfer`, so on CUDA a
hidden sync raises instead of serializing the rounds, as in `repro`.
Histories leave the device only in ``on_flush``.

Each round is the span ``round`` of `repro_torch.obs` (its ``t`` the
round counter), holding the spans ``local_train``, ``aggregate`` and
``eval``; the counter ``rounds`` counts the rounds a trace holds.

A donating step (``make_round_step(donate=True)``, what `run_dpfl` and
the baselines run, as in `repro`) writes the new state into the storage
of the state it was given, in place of a second (N, P) ``best_flat`` a
round; the input state is consumed.

Under a client mesh (`FLEngine.shard_clients`) a rank's state holds its
rows of the client leaves (`round_state_shardings` says which leaves
those are, `shard_round_state` cuts a whole state to a rank's rows) and
the round runs on them. The fence stays where it is: the shard-local
compute of a round runs inside it, while each collective of
`repro_torch.sharding.collectives` lifts it for its own span
(``allow_transfers``), since a gloo exchange or a host copy
synchronizes by nature.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from .. import obs as _obs
from .. import prng
from ..analysis.guards import allow_transfers, no_transfer


@dataclasses.dataclass
class RoundState:
    """Everything one federated round reads and writes.

    t:         round counter (host int; PRNG streams fold it in)
    key:       base PRNG key; round t trains with fold_in(key, t)
    flat:      (N, P) client-stacked flattened params
    best_val:  (N,) best validation accuracy seen per client
    best_flat: (N, P) params at each client's best_val
    val_hist:  (K, N) rolling validation-accuracy buffer, or None
    aux:       method-specific dict (DPFL: adjacency, candidate graph,
               graph-refresh key, comm counters, graph history)
    """
    t: int
    key: torch.Tensor
    flat: torch.Tensor
    best_val: torch.Tensor
    best_flat: torch.Tensor
    val_hist: Optional[torch.Tensor]
    aux: Any


def _map_leaves(fn, tree):
    """``tree`` rebuilt with ``fn`` applied to every tensor leaf, visiting
    a `RoundState`'s fields in order and a dict's keys in sorted order
    (`jax.tree.map`'s order; the output keeps the dict's own order)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, RoundState):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        done = {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return tree


def _storage(x: torch.Tensor) -> int:
    """The address of ``x``'s storage; 0 where it has none (a "meta" or
    empty tensor), which never counts as shared."""
    return x.untyped_storage().data_ptr()


def dealias_state(state: RoundState) -> RoundState:
    """Copy any tensor leaf whose storage an earlier leaf already holds
    (`repro.fl.round_engine.dealias_state`).

    Initial states naturally alias (``best_flat`` starts as ``flat``, aux
    side models start from the same stack, aux keys reuse ``state.key``).
    A donating ``round_step`` (`make_round_step(donate=True)`) writes each
    leaf's new value into its storage, which would overwrite the other
    leaves that share it, so it refuses such a state: every leaf must own
    its storage. Idempotent; a one-time O(state) cost per run."""
    return _map_shared(torch.clone, state)


def _map_shared(fn, state: RoundState) -> RoundState:
    """``state`` with ``fn`` applied to each tensor leaf whose storage an
    earlier leaf holds (in `_map_leaves`' order)."""
    seen = set()

    def visit(x):
        ptr = _storage(x)
        if ptr in seen:
            return fn(x)
        if ptr:
            seen.add(ptr)
        return x

    return _map_leaves(visit, state)


def init_round_state(flat, key, *, hist_len: int = 0, aux=None) -> RoundState:
    """Fresh state from client-stacked flattened params (N, P). Every
    tensor leaf, nested aux dicts' included, is a copy, so no two leaves
    share storage (see `dealias_state`) and a round that updates a buffer
    in place never writes into the caller's tensors."""
    N = flat.shape[0]
    dev = flat.device
    return _map_leaves(torch.clone, RoundState(
        t=0, key=key, flat=flat,
        best_val=torch.full((N,), float("-inf"), dtype=torch.float32,
                            device=dev),
        best_flat=flat,
        val_hist=(torch.zeros((hist_len, N), dtype=torch.float32,
                              device=dev) if hist_len else None),
        aux={} if aux is None else aux))


def _touches_exchange_site(fn, depth: int = 2) -> bool:
    """True when ``fn`` is a registered ``@exchange_site`` or (within two
    levels of globals/closure references) calls one. Runtime mirror of
    fedlint rule F1, intentionally forgiving: wrappers around registered
    mixers pass; only an aggregate that mixes through entirely
    unregistered code trips the `make_round_step` warning."""
    from ..analysis.registry import is_exchange_site
    if is_exchange_site(fn):
        return True
    if isinstance(fn, functools.partial):
        return _touches_exchange_site(fn.func, depth)
    code = getattr(fn, "__code__", None)
    if depth == 0 or code is None:
        return False
    cands = []
    glb = getattr(fn, "__globals__", {})
    for name in code.co_names:
        v = glb.get(name)
        if callable(v):
            cands.append(v)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if callable(v):
            cands.append(v)
    return any(_touches_exchange_site(c, depth - 1) for c in cands)


def _accepts(fn, name: str) -> bool:
    """True when ``fn``'s signature has a parameter called ``name``
    (aggregates optionally take ``prev``, local-train hooks optionally
    take ``aux``/``t``: arity-detected so every callable keeps its
    calling convention)."""
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _check_rows(state: RoundState, spec: RoundState, n_local: int):
    """Raise where a leaf that ``spec`` marks as client rows does not hold
    ``n_local`` rows on its client axis: a whole state given to a rank's
    step (`shard_round_state` cuts it). Reads shapes only."""
    def walk(leaf, axis, path):
        if isinstance(leaf, dict):
            sub = axis if isinstance(axis, dict) else {}
            for k, v in leaf.items():
                walk(v, sub.get(k), f"{path}[{k!r}]")
        elif isinstance(leaf, torch.Tensor) and isinstance(axis, int) \
                and leaf.shape[axis] != n_local:
            raise ValueError(
                f"round_step: {path} has {leaf.shape[axis]} clients on "
                f"axis {axis}, the engine's rows {n_local} (cut the state "
                f"with shard_round_state)")

    for f in dataclasses.fields(RoundState):
        walk(getattr(state, f.name), getattr(spec, f.name), f".{f.name}")


class _Write:
    """One donated leaf: ``src``'s values go into ``dst``'s storage."""

    def __init__(self, dst: torch.Tensor, src: Optional[torch.Tensor]):
        self.dst, self.src = dst, src


def _donate(state: RoundState, new: Dict[str, Any]) -> Dict[str, Any]:
    """``new`` (field name -> value of the round's output) with every
    tensor written into the storage of ``state``'s leaf at the same path
    where that leaf has the same shape, dtype and device (nested aux
    dicts followed); other values are returned as they are. A value that
    is a view of a storage some leaf is written into is cloned before any
    write, so no write reads a storage already overwritten."""
    writes = []

    def plan(old, val):
        if isinstance(old, dict) and isinstance(val, dict):
            return {k: plan(old.get(k), v) for k, v in val.items()}
        if isinstance(old, torch.Tensor) and isinstance(val, torch.Tensor) \
                and old.shape == val.shape and old.dtype == val.dtype \
                and old.device == val.device:
            writes.append(_Write(old, val))
            return writes[-1]
        return val

    planned = {k: plan(getattr(state, k), v) for k, v in new.items()}
    written = {_storage(w.dst) for w in writes} - {0}
    for w in writes:
        src, dst = w.src, w.dst
        if src is dst or (src.data_ptr() != 0 and
                          src.data_ptr() == dst.data_ptr() and
                          src.stride() == dst.stride()):
            w.src = None  # passed through: nothing to write
        elif _storage(src) in written:
            w.src = src.clone()
    for w in writes:
        if w.src is not None:
            w.dst.copy_(w.src)

    def done(x):
        if isinstance(x, _Write):
            return x.dst
        if isinstance(x, dict):
            return {k: done(v) for k, v in x.items()}
        return x

    return {k: done(v) for k, v in planned.items()}


def _refuse_shared(x):
    """A donating round would overwrite one leaf through another that
    shares its storage (XLA refuses to donate a buffer twice)."""
    raise ValueError("round_step(donate=True): two leaves of the state "
                     "share storage; build it with init_round_state or "
                     "pass it through dealias_state")


def make_round_step(engine, *, tau: int,
                    aggregate: Optional[Callable] = None,
                    local_train: Optional[Callable] = None,
                    post_train: Optional[Callable] = None,
                    eval_flat: Optional[Callable] = None,
                    hist_len: int = 0,
                    aux_specs: Optional[dict] = None,
                    participation_key: Optional[str] = None,
                    donate: bool = False):
    """Build ``round_step(state) -> state`` (`repro`'s signature and calling
    conventions).

    tau:         local epochs per round
    aggregate:   (flat, aux, t) -> (flat, aux), the communication step
                 (mixing, graph refresh, comm accounting). Default: no
                 communication (local-only). An aggregate whose signature
                 has a ``prev`` parameter also receives the round-start
                 panel (``prev=state.flat``), the clipped mix rule's
                 reference point. An aggregate that is not a registered
                 ``@exchange_site`` and reaches none within two levels of
                 its globals and closure cells warns, as in `repro`
    local_train: in place of ``engine.local_train(stacked, key, epochs)``.
                 A hook whose signature has an ``aux`` parameter is called
                 as ``local_train(stacked, key, epochs=tau, aux=, t=)`` (the
                 label-flip attack reads its round's schedule row from
                 ``aux``), any other as ``local_train(stacked, key,
                 epochs=tau)``
    post_train:  (flat, prev, aux, t) -> flat, applied to the trained
                 panel after the participation hold and before the
                 aggregate: model poisoning rewrites the attacker's own
                 rows, so an absent attacker still holds its round-start
                 params
    eval_flat:   (flat, aux) -> (N, P), the model that is validated and
                 kept in ``best_flat`` (APFL's mixture, Ditto's personal
                 models). Default: the aggregated ``flat`` itself
    hist_len:    > 0 writes the validation accuracy into
                 ``state.val_hist[t % hist_len]`` (in place)
    aux_specs:   which aux leaves are client rows under a client mesh, as
                 the axis their clients lie on (a dict of the aux's shape,
                 nested dicts allowed; a leaf it leaves out is whole on
                 every rank; `round_state_shardings`). The step keeps the
                 table as ``round_step.shardings`` (what callers gather
                 each leaf by) and, when the engine carries a mesh, checks
                 before each round that every leaf the table marks holds
                 the engine's rows on its axis: a whole state raises
                 ``ValueError`` (`shard_round_state` cuts it). Nothing is
                 moved: a rank's state is its rows already
    participation_key: aux key of a (rounds, N) bool availability
                 schedule. Every client trains, then the absent ones hold
                 their round-start params; an all-ones row selects the
                 trained params everywhere, bit for bit
    donate:      write the new state into the storage of the state given:
                 ``best_val`` and ``best_flat`` by ``torch.where(...,
                 out=)``, ``flat`` and every aux tensor that comes back
                 with the same shape and dtype by ``copy_`` (the mixed
                 panel passes through the aggregate's own (N, P) buffer,
                 since K1's output cannot share its input's storage),
                 ``val_hist`` in place as always; the same bits as
                 ``donate=False``. The input state is consumed (callers
                 rebind: ``state = round_step(state)``, which `run_rounds`
                 does), and a state two of whose leaves share storage
                 raises ``ValueError`` (`init_round_state` copies every
                 leaf; `dealias_state`). No write reads the device, so the
                 round stays inside `run_rounds`' fence
    """
    lt = local_train if local_train is not None else engine.local_train
    if aggregate is not None and not _touches_exchange_site(aggregate):
        warnings.warn(
            f"round_step aggregate {getattr(aggregate, '__name__', '?')!r}"
            f" is not a registered @exchange_site and references none — "
            f"its cross-client traffic is invisible to fedlint/commaudit "
            f"(declare it with "
            f"repro_torch.analysis.registry.exchange_site)",
            stacklevel=2)
    agg = aggregate if aggregate is not None else \
        (lambda flat, aux, t: (flat, aux))
    lt_takes_aux = _accepts(lt, "aux")
    agg_takes_prev = _accepts(agg, "prev")
    spec = round_state_shardings(hist_len=hist_len, aux_specs=aux_specs)
    sharded = getattr(engine, "mesh", None) is not None

    def round_step(state: RoundState) -> RoundState:
        with _obs.span("round", t=state.t):
            _obs.count("rounds")
            return step(state)

    def step(state: RoundState) -> RoundState:
        if sharded:
            _check_rows(state, spec, engine.n_local)
        if donate:
            _map_shared(_refuse_shared, state)
        t = state.t
        stacked = engine.unflatten(state.flat)
        kt = prng.fold_in(state.key, t)
        with _obs.span("local_train"):
            if lt_takes_aux:
                stacked, _ = lt(stacked, kt, epochs=tau, aux=state.aux, t=t)
            else:
                stacked, _ = lt(stacked, kt, epochs=tau)
        flat = engine.flatten(stacked)
        del stacked
        if participation_key is not None:
            m = state.aux[participation_key][t][engine.rows]
            flat = torch.where(m[:, None], flat, state.flat)
        if post_train is not None:
            flat = post_train(flat, state.flat, state.aux, t)
        with _obs.span("aggregate"):
            if agg_takes_prev:
                flat, aux = agg(flat, state.aux, t, prev=state.flat)
            else:
                flat, aux = agg(flat, state.aux, t)
        ev = eval_flat(flat, aux) if eval_flat is not None else flat
        with _obs.span("eval"):
            val_acc, _ = engine.eval_val(engine.unflatten(ev))
        improved = val_acc > state.best_val
        if hist_len:
            state.val_hist[t % hist_len] = val_acc
        if not donate:
            return RoundState(
                t=t + 1, key=state.key, flat=flat,
                best_val=torch.where(improved, val_acc, state.best_val),
                best_flat=torch.where(improved[:, None], ev,
                                      state.best_flat),
                val_hist=state.val_hist, aux=aux)
        # every read of the round-start state is done: write the new
        # state into its storage
        best_val = torch.where(improved, val_acc, state.best_val,
                               out=state.best_val)
        best_flat = torch.where(improved[:, None], ev, state.best_flat,
                                out=state.best_flat)
        out = _donate(state, {"flat": flat, "aux": aux})
        return RoundState(t=t + 1, key=state.key, flat=out["flat"],
                          best_val=best_val, best_flat=best_flat,
                          val_hist=state.val_hist, aux=out["aux"])

    round_step.shardings = spec
    return round_step


def round_state_shardings(*, hist_len: int = 0,
                          aux_specs: Optional[dict] = None) -> RoundState:
    """Which leaves of a `RoundState` are client rows under a client mesh
    (`repro.fl.round_engine.round_state_shardings`): a `RoundState` whose
    fields hold the axis their clients lie on, None where the leaf is
    replicated. flat, best_val and best_flat are rows on axis 0, val_hist
    on axis 1, t and key replicated; ``aux`` is ``aux_specs``, a dict of
    the same shape as the aux (nested dicts allowed), every leaf it
    leaves out replicated."""
    return RoundState(t=None, key=None, flat=0, best_val=0, best_flat=0,
                      val_hist=1 if hist_len else None,
                      aux={} if aux_specs is None else aux_specs)


def _take_rows(x, axis, rows: slice):
    if axis is None or not isinstance(x, torch.Tensor):
        return x
    return x.narrow(axis, rows.start, rows.stop - rows.start).clone()


def _shard_aux(aux, specs, rows):
    if not isinstance(aux, dict):
        return _take_rows(aux, specs, rows)
    specs = specs if isinstance(specs, dict) else {}
    return {k: _shard_aux(v, specs.get(k), rows) for k, v in aux.items()}


def shard_round_state(state: RoundState, rows: slice,
                      aux_specs: Optional[dict] = None) -> RoundState:
    """A whole (N, ...) state cut to a rank's client ``rows`` (copies),
    by the table of `round_state_shardings`: what a rank of a client mesh
    holds of it."""
    spec = round_state_shardings(
        hist_len=0 if state.val_hist is None else 1, aux_specs=aux_specs)
    return RoundState(
        t=state.t, key=state.key,
        flat=_take_rows(state.flat, spec.flat, rows),
        best_val=_take_rows(state.best_val, spec.best_val, rows),
        best_flat=_take_rows(state.best_flat, spec.best_flat, rows),
        val_hist=_take_rows(state.val_hist, spec.val_hist, rows),
        aux=_shard_aux(state.aux, spec.aux, rows))


def run_rounds(round_step, state: RoundState, rounds: int,
               on_flush: Optional[Callable] = None,
               flush_every: int = 0) -> RoundState:
    """Run ``rounds`` round steps with no host sync between them: the
    loop runs inside `no_transfer` on the state's device (`repro`'s
    ``guard_transfers=False`` opt-out has no caller in the port and is
    not kept). ``on_flush(state, done)`` (if given) is called every
    ``flush_every`` rounds, inside an `allow_transfers` hole since
    pulling histories off the device is its purpose, and once more at
    the end, outside the fenced region."""
    last = 0
    with no_transfer(state.flat.device):
        for t in range(rounds):
            state = round_step(state)
            if flush_every and on_flush is not None and \
                    (t + 1) % flush_every == 0 and t + 1 < rounds:
                with allow_transfers():
                    on_flush(state, t + 1 - last)
                last = t + 1
    if on_flush is not None and rounds > last:
        on_flush(state, rounds - last)
    return state
