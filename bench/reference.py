"""The plain reference's parts: the local train, the double greedy of GGC
replayed, the rewards of its probes, and the gaps that decide
``correct``.

Plain PyTorch in float64, on the device the check runs on, client block
by client block. It imports nothing of the program: the models are the
families' own plain versions (`families.papercnn.RefModel`,
`families.lm.RefModel`), the keys come from the frozen threefry copy
(`bench.prng`), and the mix rules and codecs are modules of their own
(`bench/rules/<name>.py`, `bench/codecs/<name>.py`), which an entry
(`bench/entries/<name>.py`) finds by the names its traffic mix gives
and puts together with these parts into the check of its program.

The gaps:

* ``loss``: each client's local-train loss, averaged over its steps,
  against the reference's, relative to the larger of its own and the
  median client's;
* ``grad``: the first minibatch's gradient as the optimizer gets it, and
  ``train``: the update the local train made to the panel, each by the
  worst leaf (a leaf is one client's tensor): the gap between the norms
  of the program's and the reference's leaf over the larger of the
  reference leaf's norm and the median leaf's of the panel (``train``
  leaves out leaves whose reference gradient is under a thousandth of the
  median leaf's: they move by round-off alone);
* ``reward``: every reward the program's greedy computed at a candidate
  position against the reference's loss of the same probe model (the
  probes built in float64 from the replayed decisions), relative to the
  larger of its own size and the median reward's;
* ``graph``: clients whose selection differs from the double greedy
  replayed on the program's own rewards and the frozen coin flips
  (exact).
"""
from __future__ import annotations

import torch

from . import prng

#: a prediction whose winning logit leads the runner-up by less than this
#: share of the logits' scale may go either way in float32
TIE = 1e-4


def rows_of(n: int, block: int):
    for lo in range(0, n, block):
        yield slice(lo, min(n, lo + block))


def rel_gaps(diff_norm, base_norm):
    """Each row's gap over its base, the base floored at the median row's
    (and above zero)."""
    floor = torch.clamp_min(base_norm.median(), 1e-30)
    return diff_norm / torch.maximum(base_norm, floor)


# ---------------------------------------------------------------- train


def local_train(model, flat, x_all, y_all, key, epochs: int, run: dict,
                rows: slice, n_clients: int, steps=None):
    """Reference local train of clients ``rows`` from ``flat`` (their
    (n, P) float64 start rows), on ``x_all``/``y_all`` (their train split
    on the device): ``epochs`` epochs of minibatch SGD, the minibatches of
    client i from ``split(split(key, N)[i], epochs)``'s permutations,
    ``n // bs`` an epoch, momentum from zero, ``g += wd p``,
    ``mu = m mu + g``, ``p -= lr mu``; only the first ``steps`` steps
    where given. Returns (trained (n, P), the first minibatch's gradient
    (n, P), each client's loss averaged over the steps (n,))."""
    bs = run["batch_size"]
    n = y_all.shape[1]
    nb = n // bs
    ekeys = prng.split(prng.split(key, n_clients)[rows], epochs)
    perms = prng.permutation(ekeys, n)[..., :nb * bs].to(x_all.device)
    ar = torch.arange(perms.shape[0], device=x_all.device)[:, None]
    params = model.unflatten(flat.clone())
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, m, wd = run["lr"], run["momentum"], run["weight_decay"]
    first, losses = None, []
    schedule = [(e, b) for e in range(epochs) for b in range(nb)]
    for e, b in schedule[:steps]:
        idx = perms[:, e, b * bs:(b + 1) * bs]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = model.loss(leaves, x_all[ar, idx], y_all[ar, idx])
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        if first is None:
            first = model.flatten(dict(zip(leaves, grads)))
        losses.append(loss.detach())
        new = {}
        for (k, p), g in zip(leaves.items(), grads):
            g = g + wd * p.detach()
            mu[k] = m * mu[k] + g
            new[k] = p.detach() - lr * mu[k]
        params = new
    return model.flatten(params), first, torch.stack(losses).mean(0)


def leaf_gaps(got, ref, keep=None):
    """The worst leaf of the panel: the gap between the norms of the
    program's and the reference's leaf (``got`` and ``ref``: (N, leaves)
    norms, a leaf being one client's tensor), over the larger of the
    reference leaf's norm and the median leaf's of the whole panel.
    ``keep`` ((N, leaves) bool) leaves out leaves. Returns (the gap,
    (client, leaf) where it is)."""
    floor = ref.median()
    gap = (got - ref).abs() / torch.maximum(ref, floor).clamp_min(1e-30)
    if keep is not None:
        gap = torch.where(keep, gap, torch.zeros_like(gap))
    worst = int(gap.argmax())
    return float(gap.max()), divmod(worst, gap.shape[1])


def grad_gap(model, data, run: dict, start, grad, key, epochs: int,
             block: int, device):
    """The first minibatch's gradient of a local train of every client
    from ``start`` (the program's ``grad``, both (N, P) on the host)
    against the reference's: the worst leaf's gap, as `leaf_gaps` takes
    it, and where it is ((client, leaf name))."""
    N = start.shape[0]
    got = torch.zeros(N, len(model.sizes), dtype=torch.float64)
    ref = torch.zeros_like(got)
    for rows in rows_of(N, block):
        s = start[rows].to(device).double()
        x_all = model.inputs(data.train_x[rows], device)
        y_all = torch.as_tensor(data.train_y[rows]).long().to(device)
        _, g, _ = local_train(model, s, x_all, y_all, key, epochs, run,
                              rows, N, steps=1)
        got[rows] = model.leaf_norms(grad[rows].to(device).double()).cpu()
        ref[rows] = model.leaf_norms(g).cpu()
        del x_all, y_all, g, s
    gap, (k, leaf) = leaf_gaps(got, ref)
    return gap, (k, model.layout[leaf][0])


def train_gaps(model, data, run: dict, start, trained, loss, grad, key,
               epochs: int, block: int, device):
    """``loss``, ``grad`` and ``train`` of one local train of every client
    (the program's ``trained`` panel, mean ``loss`` and first ``grad``,
    from ``start``, all (N, ...) on the host) against the reference's from
    the same ``start`` and ``key``; and where the worst leaves of
    ``grad`` and ``train`` are ((client, leaf name) each)."""
    N = start.shape[0]
    L = len(model.sizes)
    loss_gap = torch.zeros(N, dtype=torch.float64)
    losses = torch.zeros(N, dtype=torch.float64)
    norms = {k: torch.zeros(N, L, dtype=torch.float64)
             for k in ("grad", "grad_ref", "step", "step_ref")}
    for rows in rows_of(N, block):
        s = start[rows].to(device).double()
        x_all = model.inputs(data.train_x[rows], device)
        y_all = torch.as_tensor(data.train_y[rows]).long().to(device)
        ref, g, ls = local_train(model, s, x_all, y_all, key, epochs, run,
                                 rows, N)
        del x_all, y_all
        loss_gap[rows] = (loss[rows].double() - ls.cpu()).abs()
        losses[rows] = ls.cpu().abs()
        norms["grad"][rows] = model.leaf_norms(
            grad[rows].to(device).double()).cpu()
        norms["grad_ref"][rows] = model.leaf_norms(g).cpu()
        norms["step"][rows] = model.leaf_norms(
            trained[rows].to(device).double() - s).cpu()
        norms["step_ref"][rows] = model.leaf_norms(ref - s).cpu()
        del ref, g, s
    out = {"loss": float(rel_gaps(loss_gap, losses).max())}
    out["grad"], where_grad = leaf_gaps(norms["grad"], norms["grad_ref"])
    # leaves whose gradient is nought to rounding in the reference move
    # by round-off alone: left out of the update's gap
    keep = norms["grad_ref"] >= 1e-3 * norms["grad_ref"].median()
    out["train"], where_step = leaf_gaps(norms["step"], norms["step_ref"],
                                         keep)
    names = [k for k, _ in model.layout]
    return out, {"grad": (where_grad[0], names[where_grad[1]]),
                 "train": (where_step[0], names[where_step[1]])}


# ---------------------------------------------------------------- greedy


def orders(key, n_clients: int):
    """Each client's candidate order and coin flips (N, N) under the
    graph key ``key``: client k's stream is ``fold_in(key, k)``."""
    keys = prng.fold_in(key, torch.arange(n_clients))
    order = prng.permutation(prng.fold_in(keys, 0), n_clients)
    j1 = torch.arange(1, n_clients + 1)
    coins = prng.uniform(prng.fold_in(keys[:, None, :], j1[None, :]))
    return order, coins


def peers(graph, sparse: bool, k: int) -> set:
    """Client k's peers in a graph (Omega, or a round's selection): an
    (N, N) bool adjacency or (N, B) int32 lists, k itself left out."""
    row = graph[k]
    if sparse:
        return {int(j) for j in row.tolist() if j >= 0 and j != k}
    return {int(j) for j in torch.nonzero(row).flatten().tolist() if j != k}


def program_rewards(calls):
    """(client, position) -> the program's (4,) float32 rewards: position s
    is the s-th reward call of the greedy (``calls``: [(k_idx (K,),
    rewards (K, 4))]); a dense scan calls at every position of the order,
    a sparse one at the s-th candidate visited."""
    out = {}
    for s, (k_idx, r) in enumerate(calls):
        for row, k in enumerate(k_idx.tolist()):
            out[(k, s)] = r[row]
    return out


def replay(calls, cand, order, coins, budget: int, sparse: bool):
    """The double greedy replayed on the program's own rewards (``calls``)
    over each client's candidates ``cand`` (Omega: (N, N) bool or (N, B)
    lists): each client's visited candidates with the replayed decision
    ("add", "rem", "keep", or None where the program made no call) and
    the final selection."""
    N = order.shape[0]
    rewards = program_rewards(calls)
    paths, chosen = {}, {}
    for k in range(N):
        c = peers(cand, sparse, k)
        visits, nsel, sel = [], 0, set()
        # the candidates in the order's sequence, each with its reward
        # call: its position in the order (dense) or in the sequence
        seq = [(s, j) for s, j in enumerate(order[k].tolist()) if j in c]
        for i, (pos, j) in enumerate(seq):
            s = i if sparse else pos
            r = rewards.get((k, s))
            if r is None:
                visits.append((j, s, None))
                continue
            a = torch.clamp_min(r[1] - r[0], 0.0)
            b = torch.clamp_min(r[3] - r[2], 0.0)
            prob = a / (a + b) if float(a + b) > 0 else torch.tensor(1.0)
            hit = bool(coins[k, j] < prob)
            if hit and nsel < budget:
                decision, nsel = "add", nsel + 1
                sel.add(j)
            elif not hit:
                decision = "rem"
            else:
                decision = "keep"
            visits.append((j, s, decision))
        paths[k], chosen[k] = visits, sel
    return paths, chosen


def graph_gap(paths, chosen, out_graph, out_sparse: bool) -> float:
    """Clients whose selection in ``out_graph`` differs from the replay's,
    and visits the program made no reward call for (exact: limit 0)."""
    differ = sum(chosen[k] != peers(out_graph, out_sparse, k)
                 for k in chosen)
    missing = sum(1 for k in paths for v in paths[k] if v[2] is None)
    return float(differ + missing)


def reward_gaps(model, calls, cand, sparse: bool, recv, p, paths, data,
                device, block: int, clients=None):
    """The reference's rewards at every visited candidate of the replayed
    paths of ``clients`` (all where None), against the program's: the
    largest gap, each against its reward's size or the median reward's,
    whichever is larger. ``recv`` (N, P) float64 on the device is the
    table the probes are built of."""
    rewards = program_rewards(calls)
    gaps, refs = [], []
    clients = [k for k in (range(len(paths)) if clients is None
                           else clients) if paths[k]]
    for lo in range(0, len(clients), block):
        blk = clients[lo:lo + block]
        # running sums in float64 per client of the block
        carry = {}
        for k in blk:
            Y = sorted(peers(cand, sparse, k) | {k})
            carry[k] = dict(wX=p[k] * recv[k], pX=p[k].clone(),
                            wY=(p[Y, None] * recv[Y]).sum(0), pY=p[Y].sum())
        depth = max(len(paths[k]) for k in blk)
        for i in range(depth):
            live = [k for k in blk if i < len(paths[k])
                    and paths[k][i][2] is not None]
            if not live:
                continue
            probes = []
            for k in live:
                j = paths[k][i][0]
                c = carry[k]
                pw = p[j] * recv[j]
                probes.append(torch.stack([
                    c["wX"] / c["pX"], (c["wX"] + pw) / (c["pX"] + p[j]),
                    c["wY"] / c["pY"],
                    (c["wY"] - pw) / torch.clamp_min(c["pY"] - p[j],
                                                     1e-12)]))
            probes = torch.stack(probes)            # (K, 4, P)
            K = len(live)
            params = model.unflatten(probes.reshape(K * 4, -1))
            x = model.inputs(data.val_x[live], device)
            y = torch.as_tensor(data.val_y[live]).long().to(device)
            x = x[:, None].expand((K, 4) + x.shape[1:]).reshape(
                (K * 4,) + x.shape[1:])
            y = y[:, None].expand(K, 4, y.shape[1]).reshape(K * 4, -1)
            with torch.no_grad():
                ref = -model.loss(params, x, y).reshape(K, 4).cpu()
            for row, k in enumerate(live):
                j, s, decision = paths[k][i]
                gaps.append((rewards[(k, s)].double() - ref[row]).abs())
                refs.append(ref[row].abs())
                c = carry[k]
                pw = p[j] * recv[j]
                if decision == "add":
                    c["wX"], c["pX"] = c["wX"] + pw, c["pX"] + p[j]
                elif decision == "rem":
                    c["wY"], c["pY"] = c["wY"] - pw, c["pY"] - p[j]
            del probes, params
    if not gaps:
        return 0.0
    gaps, refs = torch.stack(gaps), torch.stack(refs)
    # each reward against its own size, floored at the median reward's
    return float((gaps / torch.maximum(refs, refs.median())
                  .clamp_min(1e-30)).max())


# ------------------------------------------------------------------- mix


def mix_gap(mix_fn, trained, recv, graph, p, sparse: bool, got, block: int,
            device) -> float:
    """The program's mixed panel ``got`` (N, P, host) against the
    reference rule ``mix_fn`` over ``graph``: the gap's norm over the norm
    of the mix's change, floored at the median client's."""
    N = got.shape[0]
    gap_norm = torch.zeros(N, dtype=torch.float64)
    step_norm = torch.zeros(N, dtype=torch.float64)
    for rows in rows_of(N, block):
        ref = mix_fn(trained, recv, graph, p, sparse, rows)
        g = got[rows].to(device).double()
        gap_norm[rows] = (g - ref).norm(dim=1).cpu()
        step_norm[rows] = (ref - trained[rows]).norm(dim=1).cpu()
        del ref, g
    return float(rel_gaps(gap_norm, step_norm).max())
