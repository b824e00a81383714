"""The "dpfl_blocked" entry: the "dpfl" entry (`bench/entries/dpfl.py`)
for clients of a billion weights whose GGC refresh runs in client blocks
(the engine's ``client_chunk``).

The program is the same: `dpfl_initial_state` with the recorders on,
then `dpfl_round_step` through `run_rounds`. Three things differ, and
the check compares the same numbers against the same limits' kinds:

* a blocked refresh makes its reward calls client block by block (a
  dense scan: N positions for each block), where `reference.
  program_rewards` keys the calls by their index as a position of the
  order. Before the replay the calls are regrouped (`regroup`) so that
  call s holds each client's s-th call: in a dense scan, each client's
  s-th call is still position s;
* the copies the check keeps stay on the host, and fewer of them: a
  panel is 12.35 GB at the cell's size, so that the program leaves no
  room for them on the device, and the host holds 96 GiB. The
  first gradient is kept as its leaves' norms (all the check reads of
  it; taken on the device in the checked round), the init panel as one
  row where every client starts from the same, and the best models are
  checked (exactly) right after the round, against their host copy;
* the checked round runs its step outside the no-sync fence, so that
  the recorders may copy to the host; the round is the same.

Each stage of the reference is `bench.reference`'s, on one client at a
time; the panels it reads are its `Rows`: a host panel whose rows are
read as float64 on the device when indexed. The mix must have no codec
and dense graphs (the reference follows no other).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from .. import harness, prng, reference
from . import dpfl

PRE_REWARD_CLIENTS = dpfl.PRE_REWARD_CLIENTS


def regroup(calls):
    """[(k_idx (K,), rewards (K, 4))] of a blocked refresh as calls of the
    whole batch: call s holds each client's s-th call, clients
    ascending."""
    per = {}
    for k_idx, r in calls:
        for row, k in enumerate(k_idx.tolist()):
            per.setdefault(k, []).append(r[row])
    out = []
    for s in range(max((len(v) for v in per.values()), default=0)):
        ks = [k for k in sorted(per) if s < len(per[k])]
        out.append((torch.tensor(ks),
                    torch.stack([per[k][s] for k in ks])))
    return out


class Rows:
    """A host panel (N, P) whose rows, indexed as a panel's are (an int, a
    list, a slice), come back as float64 on ``device``."""

    def __init__(self, host: torch.Tensor, device):
        self.host, self.device = host, device
        self.shape = host.shape

    def __getitem__(self, idx):
        return self.host[idx].to(self.device).double()


@dataclass
class Pre:
    """What the check reads of the preprocessing, on the host."""
    init: torch.Tensor            # (1, P) every client's init, or (N, P)
    trained: torch.Tensor         # (N, P) after tau_init epochs
    grad_norms: torch.Tensor      # (N, leaves) their first gradient's
    rewards: List                 # BGGC's calls, regrouped
    omega: torch.Tensor           # (N, N) bool
    mixed: torch.Tensor           # (N, P) the panel the first round gets


@dataclass
class Round:
    """What the check reads of one program round, on the host."""
    t: int
    flat: torch.Tensor            # (N, P) round-start panel
    omega: torch.Tensor           # (N, N) bool
    trained: torch.Tensor         # (N, P) the local train's output
    train_loss: torch.Tensor      # (N,)
    grad_norms: torch.Tensor      # (N, leaves) its first gradient's
    rewards: List                 # the refresh's calls, regrouped
    val_acc: torch.Tensor         # (N,)
    out_flat: torch.Tensor        # (N, P) the mixed panel
    out_graph: torch.Tensor       # (N, N) bool
    best_bad: torch.Tensor        # (N,) bool: best model or value wrong


@dataclass
class Program(dpfl.Program):
    """`dpfl.Program` with the round step itself and the engine, which
    the checked round needs and then lets go."""
    step: Optional[Callable] = None
    engine: object = None


def _leaf_norms(engine, grads) -> torch.Tensor:
    """(N, leaves) float64 norms of each client's gradient leaves, in the
    flat layout's order, on the host."""
    return torch.stack([grads[k].reshape(grads[k].shape[0], -1).double()
                        .norm(dim=1) for k in engine._keys], dim=1).cpu()


def setup(fam, cell, data, engine, spans, seed: int) -> Program:
    """The preprocessing, recorded on the host (set-up runs outside the
    fence), and the round step."""
    from repro_torch.core.dpfl import dpfl_initial_state, dpfl_round_step
    from repro_torch.fl.round_engine import run_rounds

    dcfg = dpfl.dpfl_config(cell, seed)
    if dcfg.graph_repr != "dense" or dcfg.compression is not None:
        raise ValueError("the dpfl_blocked entry's reference follows dense "
                         "graphs without a codec")
    spans.record, spans.recording, spans.to_host = {}, True, True
    state, _ = dpfl_initial_state(engine, dcfg)
    spans.recording, spans.to_host = False, False
    rec, spans.record = spans.record, {}
    pre = None
    if all(k in rec for k in ("start", "trained", "grad")):
        model = fam.RefModel(cell.config)
        start = rec.pop("start")
        same = all(torch.equal(start[k], start[0])
                   for k in range(start.shape[0]))
        init = start[:1].clone() if same else start
        del start
        grad = rec.pop("grad")
        norms = torch.cat([model.leaf_norms(grad[k:k + 1].double())
                           for k in range(grad.shape[0])])
        del grad
        pre = Pre(init=init, trained=rec.pop("trained"), grad_norms=norms,
                  rewards=regroup(rec.get("rewards", [])),
                  omega=dpfl._host(state.aux["omega"]),
                  mixed=dpfl._host(state.flat))
    del rec
    step = dpfl_round_step(engine, dcfg)
    omega = state.aux["omega"].cpu()
    sizes = [len(reference.peers(omega, False, k))
             for k in range(omega.shape[0])]
    return Program(state=state, run=lambda st, n: run_rounds(step, st, n),
                   flops_per_round=fam.round_flops(cell.config, sizes),
                   sparse=False, pre=pre, step=step, engine=engine)


def capture(prog: Program, state, spans) -> Optional[Round]:
    """One more round with the recorders on (their host copies: the
    round-start panel once, the trained panel; the first gradient's leaf
    norms), its best models checked against the round's accuracies;
    returns what the check reads of it, or None where the round recorded
    no local train or evaluation. Lets go of the step and the engine."""
    engine, step = prog.engine, prog.step
    prog.engine = prog.step = None
    start = dict(t=state.t, flat=dpfl._host(state.flat),
                 omega=dpfl._host(state.aux["omega"]))
    best_val = dpfl._host(state.best_val)
    best_flat = dpfl._host(state.best_flat)
    opt, norms = engine.opt, []

    def update(grads, st, params):
        if not norms:
            norms.append(_leaf_norms(engine, grads))
        return opt.update(grads, st, params)

    engine.opt = opt._replace(update=update)
    # the recorders' own copies of the start panel and of the gradient
    # are not kept
    spans.record = {"start": None, "grad": None}
    spans.recording, spans.to_host = True, True
    try:
        state = step(state)
    finally:
        spans.recording, spans.to_host = False, False
        engine.opt = opt
    rec, spans.record = spans.record, {}
    if not norms or any(k not in rec for k in ("trained", "train_loss",
                                               "val_acc")):
        return None
    acc = rec["val_acc"]
    improved = acc > best_val
    bad = state.best_val.cpu() != torch.where(improved, acc, best_val)
    for k in range(acc.shape[0]):
        want = state.flat[k] if improved[k] else \
            best_flat[k].to(state.flat.device)
        if not torch.equal(state.best_flat[k], want):
            bad[k] = True
        del want
    del best_flat
    return Round(**start, trained=rec["trained"],
                 train_loss=rec["train_loss"], grad_norms=norms[0],
                 rewards=regroup(rec.get("rewards", [])), val_acc=acc,
                 out_flat=dpfl._host(state.flat),
                 out_graph=dpfl._host(state.aux["adj"]), best_bad=bad)


def _train_gaps(model, data, run: dict, rec: Round, key, epochs: int,
                device):
    """`reference.train_gaps` on one client at a time, the program's first
    gradient given by its leaves' norms."""
    N = rec.flat.shape[0]
    L = len(model.sizes)
    loss_gap = torch.zeros(N, dtype=torch.float64)
    losses = torch.zeros(N, dtype=torch.float64)
    step = torch.zeros(N, L, dtype=torch.float64)
    step_ref = torch.zeros_like(step)
    grad_ref = torch.zeros_like(step)
    for k in range(N):
        rows = slice(k, k + 1)
        s = rec.flat[rows].to(device).double()
        x_all = model.inputs(data.train_x[rows], device)
        y_all = torch.as_tensor(data.train_y[rows]).long().to(device)
        ref, g, ls = reference.local_train(model, s, x_all, y_all, key,
                                           epochs, run, rows, N)
        del x_all, y_all
        loss_gap[k] = (rec.train_loss[k].double() - ls.cpu()[0]).abs()
        losses[k] = ls.cpu()[0].abs()
        grad_ref[k] = model.leaf_norms(g).cpu()[0]
        del g
        step[k] = model.leaf_norms(rec.trained[rows].to(device).double()
                                   - s).cpu()[0]
        step_ref[k] = model.leaf_norms(ref - s).cpu()[0]
        del ref, s
    out = {"loss": float(reference.rel_gaps(loss_gap, losses).max())}
    out["grad"], where_grad = reference.leaf_gaps(rec.grad_norms, grad_ref)
    keep = grad_ref >= 1e-3 * grad_ref.median()
    out["train"], where_step = reference.leaf_gaps(step, step_ref, keep)
    names = [k for k, _ in model.layout]
    return out, {"grad": (where_grad[0], names[where_grad[1]]),
                 "train": (where_step[0], names[where_step[1]])}


def check(fam, cell, data, pre: Optional[Pre], rec: Round, seed: int,
          device):
    """The numbers that decide ``correct``, as `dpfl.check` reads them,
    and where the worst leaves of the train's gradients and updates
    are."""
    dcfg = dpfl.dpfl_config(cell, seed)
    model = fam.RefModel(cell.config)
    run = cell.config["train"]
    N = rec.flat.shape[0]
    budget = dcfg.budget if dcfg.budget is not None else N - 1
    block = fam.REF_BLOCK
    weighted = harness.find(cell.bench_dir, "rules", "weighted").mix
    p = torch.as_tensor(data.p, dtype=torch.float64, device=device)
    _, k_pre, k_graph, k_train = prng.split(prng.PRNGKey(seed), 4)
    readings, detail = {}, {}

    # -- the preprocessing: the first gradient from the init, BGGC over
    # every peer, one mix
    if pre is not None:
        grad_ref = torch.zeros_like(pre.grad_norms)
        for k in range(N):
            rows = slice(k, k + 1)
            s = pre.init[k if pre.init.shape[0] > 1 else 0][None] \
                .to(device).double()
            x_all = model.inputs(data.train_x[rows], device)
            y_all = torch.as_tensor(data.train_y[rows]).long().to(device)
            _, g, _ = reference.local_train(model, s, x_all, y_all, k_pre,
                                            dcfg.tau_init, run, rows, N,
                                            steps=1)
            grad_ref[k] = model.leaf_norms(g).cpu()[0]
            del s, g, x_all, y_all
        readings["pre_grad"], (kk, leaf) = reference.leaf_gaps(
            pre.grad_norms, grad_ref)
        detail["pre grad"] = (kk, model.layout[leaf][0])
        every = torch.ones(N, N, dtype=torch.bool)
        order, coins = reference.orders(k_graph, N)
        paths, chosen = reference.replay(pre.rewards, every, order, coins,
                                         budget, False)
        sample = torch.randperm(
            N, generator=torch.Generator().manual_seed(seed))[
                :PRE_REWARD_CLIENTS].tolist()
        trained = Rows(pre.trained, device)
        readings.update(
            omega=reference.graph_gap(paths, chosen, pre.omega, False),
            pre_reward=reference.reward_gaps(
                model, pre.rewards, every, False, trained, p, paths, data,
                device, fam.REWARD_BLOCK, clients=sorted(sample)),
            pre_mix=reference.mix_gap(weighted, trained, trained, pre.omega,
                                      p, False, pre.mixed, block, device))

    # -- the round: the local train
    out, where = _train_gaps(model, data, run, rec,
                             prng.fold_in(k_train, rec.t), dcfg.tau_train,
                             device)
    readings.update(out)
    detail.update(where)

    # -- the GGC refresh over Omega, on the trained panel (no codec)
    trained = Rows(rec.trained, device)
    order, coins = reference.orders(prng.fold_in(k_graph, 1000 + rec.t), N)
    paths, chosen = reference.replay(rec.rewards, rec.omega, order, coins,
                                     budget, False)
    readings.update(
        graph=reference.graph_gap(paths, chosen, rec.out_graph, False),
        reward=reference.reward_gaps(model, rec.rewards, rec.omega, False,
                                     trained, p, paths, data, device,
                                     fam.REWARD_BLOCK),
        mix=reference.mix_gap(
            harness.find(cell.bench_dir, "rules", dcfg.mix_rule).mix,
            trained, trained, rec.out_graph, p, False, rec.out_flat, block,
            device))

    # -- evaluation; the best-model update was checked with the round
    bad = rec.best_bad.clone()
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
    readings["eval"] = float(bad.sum())
    return readings, detail
