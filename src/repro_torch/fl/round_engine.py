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
from typing import Any, Callable, Optional

import torch

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


def init_round_state(flat, key, *, hist_len: int = 0, aux=None) -> RoundState:
    """Fresh state from client-stacked flattened params (N, P). Every
    tensor is copied, so a round that updates a buffer in place never
    writes into the caller's tensors."""
    N = flat.shape[0]
    dev = flat.device

    def own(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    return RoundState(
        t=0, key=key.clone(), flat=flat.clone(),
        best_val=torch.full((N,), float("-inf"), dtype=torch.float32,
                            device=dev),
        best_flat=flat.clone(),
        val_hist=(torch.zeros((hist_len, N), dtype=torch.float32,
                              device=dev) if hist_len else None),
        aux={} if aux is None else {k: own(v) for k, v in aux.items()})


def make_round_step(engine, *, tau: int,
                    aggregate: Optional[Callable] = None,
                    local_train: Optional[Callable] = None,
                    post_train: Optional[Callable] = None,
                    eval_flat: Optional[Callable] = None,
                    participation_key: Optional[str] = None,
                    hist_len: int = 0):
    """Build ``round_step(state) -> state``.

    tau:         local epochs per round
    aggregate:   (flat, aux, t, prev) -> (flat, aux), the communication
                 step (mixing, graph refresh, comm accounting); ``prev``
                 is the round-start panel ``state.flat``, the clipped mix
                 rule's reference point. Default: no communication
                 (local-only).
    local_train: (stacked, key, epochs, *, aux, t) -> (stacked, loss) in
                 place of ``engine.local_train``: the label-flip attack
                 reads its round's schedule row from ``aux``
    post_train:  (flat, prev, aux, t) -> flat, applied to the trained
                 panel after the participation hold and before the
                 aggregate: model poisoning rewrites the attacker's own
                 rows, so an absent attacker still holds its round-start
                 params
    eval_flat:   (flat, aux) -> (N, P), the model that is validated and
                 kept in ``best_flat`` (APFL's mixture, Ditto's personal
                 models). Default: the aggregated ``flat`` itself
    participation_key: aux key of a (rounds, N) bool availability
                 schedule. Every client trains, then the absent ones hold
                 their round-start params; an all-ones row selects the
                 trained params everywhere, bit for bit
    hist_len:    > 0 writes the validation accuracy into
                 ``state.val_hist[t % hist_len]`` (in place)
    """
    agg = aggregate if aggregate is not None else \
        (lambda flat, aux, t, prev: (flat, aux))

    def round_step(state: RoundState) -> RoundState:
        t = state.t
        stacked = engine.unflatten(state.flat)
        kt = prng.fold_in(state.key, t)
        if local_train is not None:
            stacked, _ = local_train(stacked, kt, tau, aux=state.aux, t=t)
        else:
            stacked, _ = engine.local_train(stacked, kt, epochs=tau)
        flat = engine.flatten(stacked)
        if participation_key is not None:
            m = state.aux[participation_key][t][engine.rows]
            flat = torch.where(m[:, None], flat, state.flat)
        if post_train is not None:
            flat = post_train(flat, state.flat, state.aux, t)
        flat, aux = agg(flat, state.aux, t, state.flat)
        ev = eval_flat(flat, aux) if eval_flat is not None else flat
        val_acc, _ = engine.eval_val(engine.unflatten(ev))
        improved = val_acc > state.best_val
        if hist_len:
            state.val_hist[t % hist_len] = val_acc
        return RoundState(
            t=t + 1,
            key=state.key,
            flat=flat,
            best_val=torch.where(improved, val_acc, state.best_val),
            best_flat=torch.where(improved[:, None], ev, state.best_flat),
            val_hist=state.val_hist,
            aux=aux)

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
