"""The "dpfl" entry: Algorithm 1 of the port, as `run_dpfl` runs it.

Set-up runs ``dpfl_initial_state(engine, cfg)`` (the same init, tau_init
local epochs, BGGC's Omega, one Eq.-4 mix) with the recorders on; the
window drives ``dpfl_round_step(engine, cfg)`` on that state through
``run_rounds``. ``DPFLConfig`` is built from the configuration's
``dpfl`` settings and the traffic mix's, each nested group (such as
``compression``) into the dataclass its field names.

The check follows the preprocessing and one round, each stage from the
program's output of the stage before (`bench.reference`), so that the
greedy's coin flips, which turn last-bit differences of a reward into
other graphs, compare like with like:

* the preprocessing, from the program's init panel: the first gradient
  of its tau_init local train (``pre_grad``: after 90 steps from the
  init, the update's and the loss's gaps swing from seed to seed as much
  as the TF32 control's do, so they are not compared), BGGC replayed over
  every peer on the rewards it computed (``omega``; ``pre_reward`` on a
  sample of clients drawn from the seed) and the Eq.-4 mix over its Omega
  (``pre_mix``);
* the round after the window, from the program's state: the local
  train, the mix rule's exchange (the codec named by the mix, its
  residuals' gap in ``mix``), the GGC refresh over Omega (``reward``,
  ``graph``), the mix rule (``mix``), and ``eval``: clients whose
  validation accuracy lies outside what the reference allows
  (predictions within `reference.TIE` of a tie may go either way), or
  whose best model and accuracy are not the update of the program's own
  accuracy (exact).

The reference follows
every client active and no attack: a mix that sets ``participation`` or
``adversary`` needs an entry whose reference follows them.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from .. import harness, prng, reference

#: the preprocessing's rewards are compared for this many clients, drawn
#: from the seed (BGGC probes every peer of every client)
PRE_REWARD_CLIENTS = 20
#: DPFLConfig fields the reference does not follow
NOT_FOLLOWED = ("participation", "adversary", "random_graph", "graph_impl")


def dpfl_config(cell, seed: int):
    """``DPFLConfig`` from the configuration's and the mix's ``dpfl``
    settings; a nested group becomes the dataclass its field names."""
    from repro_torch.core import dpfl

    kw = {**cell.config["dpfl"], **cell.mix.get("dpfl", {})}
    bad = sorted(set(kw) & set(NOT_FOLLOWED))
    if kw.get("refresh_period", 1) != 1:
        bad.append("refresh_period")
    if bad:
        raise ValueError(f"the dpfl entry's reference does not follow "
                         f"{bad}: such a mix needs an entry of its own")
    hints = typing.get_type_hints(dpfl.DPFLConfig, vars(dpfl))
    for name, value in kw.items():
        if isinstance(value, dict):
            kw[name] = _group(hints[name], value)
    return dpfl.DPFLConfig(rounds=int(cell.config["rounds_cap"]), seed=seed,
                           track_history=False, **kw)


def _group(hint, value: dict):
    """The dataclass of a field's type hint (``Optional[X]`` gives X)."""
    for t in typing.get_args(hint) or (hint,):
        if dataclasses.is_dataclass(t):
            return t(**value)
    raise TypeError(f"{hint} names no dataclass for {value}")


def _host(x):
    """A host copy (``.cpu()`` of a CPU tensor would share its storage, and
    the donating round writes into it)."""
    return None if x is None else x.detach().to("cpu", copy=True)


@dataclass
class Pre:
    """What the check reads of the preprocessing, on the host."""
    init: torch.Tensor            # (N, P) the init panel
    trained: torch.Tensor         # (N, P) after tau_init epochs
    grad: torch.Tensor            # (N, P) their first minibatch's gradient
    rewards: List                 # BGGC's [(k_idx (K,), rewards (K, 4))]
    omega: torch.Tensor           # (N, N) bool, or (N, B) int32 lists
    mixed: torch.Tensor           # (N, P) the panel the first round gets


@dataclass
class Round:
    """What the check reads of one program round, on the host."""
    t: int
    flat: torch.Tensor            # (N, P) round-start panel
    best_val: torch.Tensor        # (N,)
    best_flat: torch.Tensor       # (N, P)
    omega: torch.Tensor           # (N, N) bool, or (N, B) int32 lists
    ef: Optional[torch.Tensor]    # (N, P) residuals, or None
    trained: torch.Tensor         # (N, P) the local train's output
    train_loss: torch.Tensor      # (N,) its loss, averaged over the steps
    grad: torch.Tensor            # (N, P) its first minibatch's gradient
    rewards: List                 # [(k_idx (K,), rewards (K, 4))] per call
    val_acc: torch.Tensor         # (N,) the round's validation accuracies
    out_flat: torch.Tensor        # (N, P) the mixed panel
    out_graph: torch.Tensor       # (N, N) bool, or (N, B) int32 lists
    out_ef: Optional[torch.Tensor]
    out_best_val: torch.Tensor
    out_best_flat: torch.Tensor


@dataclass
class Program:
    """The program a cell runs: its state, ``run(state, n)`` for n rounds,
    the model FLOPs a round counts, and what the check reads of the
    set-up."""
    state: object
    run: Callable
    flops_per_round: float
    sparse: bool
    pre: Optional[Pre] = None


def setup(fam, cell, data, engine, spans, seed: int) -> Program:
    """The preprocessing, recorded (host copies: set-up runs outside the
    no-sync fence), and the round step."""
    from repro_torch.core.dpfl import dpfl_initial_state, dpfl_round_step
    from repro_torch.fl.round_engine import run_rounds

    dcfg = dpfl_config(cell, seed)
    sparse = dcfg.graph_repr == "sparse"
    spans.record, spans.recording, spans.to_host = {}, True, True
    state, _ = dpfl_initial_state(engine, dcfg)
    spans.recording, spans.to_host = False, False
    rec, spans.record = spans.record, {}
    o_key = "omega_nbr" if sparse else "omega"
    pre = None
    if all(k in rec for k in ("start", "trained", "train_loss", "grad")):
        pre = Pre(init=rec["start"], trained=rec["trained"],
                  grad=rec["grad"],
                  rewards=rec.get("rewards", []),
                  omega=_host(state.aux[o_key]), mixed=_host(state.flat))
    step = dpfl_round_step(engine, dcfg)
    omega = state.aux[o_key].cpu()
    sizes = [len(reference.peers(omega, sparse, k))
             for k in range(omega.shape[0])]
    return Program(state=state, run=lambda st, n: run_rounds(step, st, n),
                   flops_per_round=fam.round_flops(cell.config, sizes),
                   sparse=sparse, pre=pre)


def capture(prog: Program, state, spans) -> Optional[Round]:
    """Run one more round with the recorders on; returns what the check
    reads of it, or None where the round recorded no local train or
    evaluation."""
    g_key, o_key = ("nbr", "omega_nbr") if prog.sparse else ("adj", "omega")
    start = dict(t=state.t, flat=_host(state.flat),
                 best_val=_host(state.best_val),
                 best_flat=_host(state.best_flat),
                 omega=_host(state.aux[o_key]), ef=_host(state.aux.get("ef")))
    spans.record, spans.recording = {}, True
    state = prog.run(state, 1)
    spans.recording = False
    rec, spans.record = spans.record, {}
    if any(k not in rec for k in ("trained", "train_loss", "grad",
                                  "val_acc")):
        return None
    return Round(
        **start, trained=_host(rec["trained"]),
        train_loss=_host(rec["train_loss"]), grad=_host(rec["grad"]),
        rewards=[(_host(k), _host(r)) for k, r in rec.get("rewards", [])],
        val_acc=_host(rec["val_acc"]), out_flat=_host(state.flat),
        out_graph=_host(state.aux[g_key]), out_ef=_host(state.aux.get("ef")),
        out_best_val=_host(state.best_val),
        out_best_flat=_host(state.best_flat))


def check(fam, cell, data, pre: Optional[Pre], rec: Round, seed: int,
          device):
    """The numbers that decide ``correct`` (a number the run could not
    read is left out, and the harness takes it as failed), and where the
    worst leaves of the train's gradients and updates are."""
    dcfg = dpfl_config(cell, seed)
    model = fam.RefModel(cell.config)
    run = cell.config["train"]
    N = rec.flat.shape[0]
    sparse = dcfg.graph_repr == "sparse"
    comp = dcfg.compression
    budget = dcfg.budget if dcfg.budget is not None else N - 1
    block = fam.REF_BLOCK
    p = torch.as_tensor(data.p, dtype=torch.float64, device=device)
    _, k_pre, k_graph, k_train = prng.split(prng.PRNGKey(seed), 4)
    readings, detail = {}, {}
    keep = readings.update

    # -- the preprocessing: tau_init epochs, BGGC over every peer, one mix
    if pre is not None:
        readings["pre_grad"], detail["pre grad"] = reference.grad_gap(
            model, data, run, pre.init, pre.grad, k_pre, dcfg.tau_init,
            block, device)
        every = torch.ones(N, N, dtype=torch.bool)
        order, coins = reference.orders(k_graph, N)
        paths, chosen = reference.replay(pre.rewards, every, order, coins,
                                         budget, False)
        sample = torch.randperm(
            N, generator=torch.Generator().manual_seed(seed))[
                :PRE_REWARD_CLIENTS].tolist()
        trained = pre.trained.to(device).double()
        keep({"omega": reference.graph_gap(paths, chosen, pre.omega, sparse),
              "pre_reward": reference.reward_gaps(
                  model, pre.rewards, every, False, trained, p, paths, data,
                  device, fam.REWARD_BLOCK, clients=sorted(sample)),
              "pre_mix": reference.mix_gap(
                  harness.find(cell.bench_dir, "rules", "weighted").mix,
                  trained, trained,
                  pre.omega, p, sparse, pre.mixed, block, device)})
        del trained

    # -- the round: the local train
    out, where = reference.train_gaps(
        model, data, run, rec.flat, rec.trained, rec.train_loss, rec.grad,
        prng.fold_in(k_train, rec.t), dcfg.tau_train, block, device)
    keep(out)
    detail.update(where)

    # -- the exchange: the table peers receive, by the mix's codec
    codec = harness.find(cell.bench_dir, "codecs",
                         comp.codec if comp is not None else "identity")
    recv, ef_gap = codec.exchange(
        rec.trained, rec.ef, None if comp is None else vars(comp),
        rec.out_ef)
    recv = recv.to(device).double()
    trained = rec.trained.to(device).double()

    # -- the GGC refresh over Omega
    order, coins = reference.orders(prng.fold_in(k_graph, 1000 + rec.t), N)
    paths, chosen = reference.replay(rec.rewards, rec.omega, order, coins,
                                     budget, sparse)
    keep({"graph": reference.graph_gap(paths, chosen, rec.out_graph,
                                       sparse),
          "reward": reference.reward_gaps(
              model, rec.rewards, rec.omega, sparse, recv, p, paths, data,
              device, fam.REWARD_BLOCK)})

    # -- the mix rule
    keep({"mix": max(ef_gap, reference.mix_gap(
        harness.find(cell.bench_dir, "rules", dcfg.mix_rule).mix, trained,
        recv, rec.out_graph, p,
        sparse, rec.out_flat, block, device))})
    del recv, trained

    # -- evaluation and the best-model update
    bad = torch.zeros(N, dtype=torch.bool)
    for rows in reference.rows_of(N, block):
        params = model.unflatten(rec.out_flat[rows].to(device).double())
        with torch.no_grad():
            sure, maybe = model.correct(
                params, model.inputs(data.val_x[rows], device),
                torch.as_tensor(data.val_y[rows]).long().to(device))
        n = sure.shape[1]
        lo = sure.double().mean(1).cpu()
        hi = (sure | maybe).double().mean(1).cpu()
        acc = rec.val_acc[rows].double()
        bad[rows] |= (acc < lo - 0.5 / n) | (acc > hi + 0.5 / n)
        del params
    improved = rec.val_acc > rec.best_val
    want_val = torch.where(improved, rec.val_acc, rec.best_val)
    want_flat = torch.where(improved[:, None], rec.out_flat, rec.best_flat)
    bad |= rec.out_best_val != want_val
    bad |= (rec.out_best_flat != want_flat).any(dim=1)
    keep({"eval": float(bad.sum())})
    return readings, detail
