"""Collaboration-graph construction: GGC (Alg. 2) and BGGC (Alg. 3), dense
(N, N) representation (port of `repro.core.graph`).

The randomized double greedy of Fourati et al. adapted to DPFL: for each
candidate j, in a seeded shuffled order, compute the marginal gains of
adding j to the grow set X and of removing j from the shrink set Y, with
rewards R(S) = -F_k^V(weighted average of the models in S); accept with
probability a/(a+b) (1 when a = b = 0), until |C_k| = B_c.

Every builder works on a batch of K clients at once: the greedy carry
holds one row per client, each step's four reward probes of all K
clients are one batched forward (K*4 models), and the loop over
candidate positions is a Python loop. Client k's stream is `repro`'s:
candidate order ``permutation(fold_in(key_k, 0), N)`` and coin flip
``uniform(fold_in(key_k, j + 1))`` for candidate j, drawn for all (k, j)
in one call. The running set sums go through `kernels.ops.graph_mix`
(one (K, N) @ (N, P) launch per greedy init, one (K, b) @ (b, P) launch
per BGGC phase-1 batch), as does the Eq.-4 mix.

Every builder exists in two graph representations: the dense entry
points emit (N, N) bool masks, the ``*_sparse`` ones (N, B) int32
neighbor lists (ascending peer ids, -1 pads, self edge implicit) whose
greedy scans probe only the <= B candidates: the same seeded decisions,
bit for bit, in O(N·B) instead of O(N²) steps. The sparse Eq.-4 mix goes
through `kernels.ops.sparse_graph_mix`.

Partial participation (``active=``, an (N,) bool availability row)
restricts the Eq.-4 weights, the download counts and the sparse greedy's
candidates to available clients; the dense refresh takes ``omega &
active[None, :]`` from its caller.

Under a client mesh (``mesh=`` / ``client_axes=``, `repro_torch.launch.
mesh`) each rank holds its block of graph rows (``row0`` its first
global row, in the functions that take a row block): the builders
gather the peer panels once and run the greedy on the rank's clients
only, with their global ids and keys, and the mixes run their row
blocks through `kernels.ops`' mesh paths. ``active``, ``p`` and keys
stay whole on every rank.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import obs as _obs
from .. import prng
from ..analysis.registry import exchange_site
from ..kernels import ops as _kops
from ..sharding import collectives as _coll
from ..sharding.rows import eye_rows, first_row, mesh_kw


# ------------------------------------------------------------------ mixing


def eq4_weights_unnormalized(adj, p, active=None, row0: int = 0):
    """The Eq.-4 member weights before row normalization: (N, N) fp32
    with entry ``p_i`` where k receives from i (diagonal forced on), 0
    elsewhere. ``active`` ((N,) bool) zeroes the rows and columns of
    absent clients before the diagonal is forced on; multiplying by 1.0
    is exact, so an all-ones mask changes no bit. The robust rules
    (`fl.robust`) take this unnormalized form. ``adj`` may be the row
    block of rows ``row0 ...`` (a rank's, under a client mesh)."""
    adj = adj.float()
    m, n = adj.shape
    if active is not None:
        act = active.float()
        adj = adj * act[row0:row0 + m, None] * act[None, :]
    adj = torch.maximum(adj, eye_rows(m, n, row0, adj.device).float())
    return adj * p[None, :]


def mixing_matrix(adj, p, active=None, row0: int = 0):
    """adj: (N, N) bool/float, adj[k, i] = 1 iff k receives from i
    (diagonal forced on). p: (N,) weights. Returns the row-stochastic A
    with A[k, i] = p_i adj[k, i] / sum_j p_j adj[k, j]. With ``active``
    an absent client's row is e_k (it holds its params) and an available
    client renormalizes over its available peers. ``adj`` may be a row
    block starting at row ``row0``."""
    w = eq4_weights_unnormalized(adj, p, active=active, row0=row0)
    return w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)


@exchange_site(charges="caller")
def mix_pytree(A, stacked_params):
    """w_k <- sum_i A[k, i] w_i on a client-stacked dict of (C, ...) leaves
    (Eq. 4): each leaf viewed as (C, P) through the Eq.-4 mixing matmul
    (`kernels.ops.graph_mix`) in fp32, cast back to its dtype."""
    A = A.float().contiguous()
    return {k: _kops.graph_mix(A, w.reshape(w.shape[0], -1).float()
                               .contiguous()).reshape(w.shape).to(w.dtype)
            for k, w in stacked_params.items()}


@exchange_site(charges="caller")
def mix_flat(A, flat_w, *, mesh=None, client_axes=None):
    """(N, P) client-stacked flattened params through the Eq.-4 mixing
    matmul (`kernels.ops.graph_mix`). Under ``mesh``, A is the rank's
    (n_loc, N) row block and ``flat_w`` its (n_loc, P) rows: each rank
    gathers the peer panels it mixes with."""
    return _kops.graph_mix(A.contiguous(), flat_w.contiguous(),
                           **mesh_kw(mesh, client_axes))


@exchange_site(charges="caller")
def weighted_sum(mask_p, flat_w):
    """Row r of the result is sum_n mask_p[r, n] * flat_w[n]: the set-sum
    numerators of the greedy for a batch of clients, (K, N) @ (N, P) in
    fp32 through the same graph_mix kernel as Eq. 4."""
    return _kops.graph_mix(mask_p.float().contiguous(),
                           flat_w.float().contiguous())


# ----------------------------------------------------------- GGC decisions


class GreedyCarry(NamedTuple):
    """Running double-greedy state, one row per client of the batch:
    grow/shrink masks, their weighted parameter sums and total weights,
    and the selection count."""
    maskX: torch.Tensor    # (K, N) bool — grow set X (incl. client k)
    maskY: torch.Tensor    # (K, N) bool — shrink set Y
    wX: torch.Tensor       # (K, P) — sum_{i in X} p_i w_i
    wY: torch.Tensor       # (K, P) — sum_{i in Y} p_i w_i
    pX: torch.Tensor       # (K,) — sum_{i in X} p_i
    pY: torch.Tensor       # (K,) — sum_{i in Y} p_i
    nsel: torch.Tensor     # (K,) int64 — |C_k| so far


def greedy_decision_step(reward_fn: Callable):
    """The single copy of the seeded double-greedy decision body.

    Returns ``step(carry, j, w_j, *, u, k_idx, is_cand, p_j, budget,
    slot=None)`` processing candidate ``j[r]`` (model ``w_j[r]``, coin
    flip ``u[r]``) for every client ``k_idx[r]`` of the batch: four reward
    probes per client in one batched forward, the a/(a+b) coin flip, and
    the running-sum accept/reject update. ``budget`` is an int or a (K,)
    tensor of per-client budgets. ``slot`` is the carry-mask column of
    the candidate: the dense scans index their (K, N) masks by the
    global id ``j`` (the default), the sparse scan its (K, B) masks by
    the neighbor-list slot; the coin flip and the probes always use the
    global id, so both layouts make the same decisions.
    """

    def step(carry: GreedyCarry, j, w_j, *, u, k_idx, is_cand, p_j,
             budget, slot=None) -> GreedyCarry:
        maskX, maskY, wX, wY, pX, pY, nsel = carry
        pos = j if slot is None else slot
        pw = p_j[:, None] * w_j
        wX_add, pX_add = wX + pw, pX + p_j
        wY_rem, pY_rem = wY - pw, pY - p_j
        probes = torch.stack([
            wX / pX[:, None],
            wX_add / pX_add[:, None],
            wY / pY[:, None],
            wY_rem / torch.clamp_min(pY_rem, 1e-12)[:, None],
        ], dim=1)
        r = reward_fn(probes, k_idx)
        a = torch.clamp_min(r[:, 1] - r[:, 0], 0.0)
        b = torch.clamp_min(r[:, 3] - r[:, 2], 0.0)
        prob = torch.where(a + b > 0, a / (a + b), 1.0)
        hit = u < prob
        add = hit & is_cand & (nsel < budget)
        rem = ~hit & is_cand
        at_j = torch.arange(maskX.shape[1], device=j.device)[None, :] \
            == pos[:, None]
        return GreedyCarry(
            maskX=maskX | (at_j & add[:, None]),
            maskY=maskY & ~(at_j & rem[:, None]),
            wX=torch.where(add[:, None], wX_add, wX),
            wY=torch.where(rem[:, None], wY_rem, wY),
            pX=torch.where(add, pX_add, pX),
            pY=torch.where(rem, pY_rem, pY),
            nsel=nsel + add.long())

    return step


def _self_mask(k_idx, N: int):
    """(K, N) bool: row r is one-hot at client k_idx[r]."""
    return torch.arange(N, device=k_idx.device)[None, :] == k_idx[:, None]


def _streams(keys, N: int):
    """Per-client candidate orders (K, N) and coin flips (K, N):
    ``permutation(fold_in(key_k, 0), N)`` and, for candidate j,
    ``uniform(fold_in(key_k, j + 1))``."""
    order = prng.permutation(prng.fold_in(keys, 0), N)
    j1 = torch.arange(1, N + 1, device=keys.device)
    coins = prng.uniform(prng.fold_in(keys[:, None, :], j1[None, :]))
    return order, coins


def _scan(step, carry, order, coins, flat_w, p, k_idx, cand_mask, budget,
          positions):
    """Feed the candidates at ``positions`` of each client's order
    through the decision step."""
    for s in positions:
        with _obs.span("ggc.position"):
            j = order[:, s]
            col = j[:, None]
            carry = step(carry, j, flat_w[j], u=coins.gather(1, col)[:, 0],
                         k_idx=k_idx, is_cand=cand_mask.gather(1, col)[:, 0],
                         p_j=p[j], budget=budget)
    return carry


def _tally_candidates(cand):
    """Tally the probe models of the decisions a scan will make at a
    candidate: the four of `greedy_decision_step` per true entry of
    ``cand``, the (client, candidate) pairs. Over the reward's count of
    every probe model (``ggc.probe_models``), the share of the scan's
    probes that can change a selection; the rest are exact no-ops."""
    if _obs.active():
        _obs.tally("ggc.candidate_probe_models", cand.sum(), n=4)


def _greedy_init(k_idx, cand_mask, flat_w, p) -> GreedyCarry:
    """Shared GGC initialization: X = {k}, Y = Omega_k ∪ {k}, running sums
    through one batched graph_mix launch."""
    with _obs.span("ggc.init"):
        maskX = _self_mask(k_idx, flat_w.shape[0])
        maskY = cand_mask | maskX
        mask_p = maskY.float() * p[None, :]
        return GreedyCarry(
            maskX=maskX, maskY=maskY,
            wX=p[k_idx][:, None] * flat_w[k_idx],
            wY=weighted_sum(mask_p, flat_w),
            pX=p[k_idx], pY=mask_p.sum(dim=1),
            nsel=torch.zeros_like(k_idx))


def make_ggc(reward_fn: Callable, budget: int):
    """GGC (Algorithm 2) for a batch of clients.

    ``reward_fn(probes (K, Q, P), k_idx (K,)) -> (K, Q)`` rewards (higher
    is better: minus the validation loss of client ``k_idx[r]``).

    Returns ``ggc(keys (K, 2), k_idx (K,), cand_mask (K, N), flat_w (N, P),
    p (N,), budget_k=None) -> (K, N) bool``: each client's selected
    collaborators, itself included. ``budget_k`` ((K,) int) overrides the
    budget per client (the heterogeneous variant).
    """
    step = greedy_decision_step(reward_fn)

    @torch.no_grad()
    def ggc(keys, k_idx, cand_mask, flat_w, p, budget_k=None):
        N = flat_w.shape[0]
        cand_mask = cand_mask & ~_self_mask(k_idx, N)
        _tally_candidates(cand_mask)
        carry = _greedy_init(k_idx, cand_mask, flat_w, p)
        order, coins = _streams(keys, N)
        carry = _scan(step, carry, order, coins, flat_w, p, k_idx,
                      cand_mask, budget if budget_k is None else budget_k,
                      range(N))
        return carry.maskX

    return ggc


@exchange_site(charges="preprocess")
def make_ggc_naive(reward_fn: Callable, budget: int):
    """Literal Algorithm 2: recompute the four set averages from scratch
    at every step (no running sums). Oracle for the Theorem-1 tests."""

    def avg(masks, flat_w, p):
        # masks (K, 4, N) -> (K, 4, P) weighted set averages
        mp = masks.float() * p
        w = torch.einsum("kqn,np->kqp", mp, flat_w)
        return w / torch.clamp_min(mp.sum(-1, keepdim=True), 1e-12)

    @torch.no_grad()
    def ggc(keys, k_idx, cand_mask, flat_w, p):
        N = flat_w.shape[0]
        cand_mask = cand_mask & ~_self_mask(k_idx, N)
        _tally_candidates(cand_mask)
        maskX = _self_mask(k_idx, N)
        maskY = cand_mask | maskX
        nsel = torch.zeros_like(k_idx)
        order, coins = _streams(keys, N)
        for s in range(N):
            j = order[:, s]
            col = j[:, None]
            at_j = _self_mask(j, N)
            is_cand = cand_mask.gather(1, col)[:, 0]
            r = reward_fn(avg(torch.stack(
                [maskX, maskX | at_j, maskY, maskY & ~at_j], dim=1),
                flat_w, p), k_idx)
            a = torch.clamp_min(r[:, 1] - r[:, 0], 0.0)
            b = torch.clamp_min(r[:, 3] - r[:, 2], 0.0)
            prob = torch.where(a + b > 0, a / (a + b), 1.0)
            hit = coins.gather(1, col)[:, 0] < prob
            add = hit & is_cand & (nsel < budget)
            rem = ~hit & is_cand
            maskX = maskX | (at_j & add[:, None])
            maskY = maskY & ~(at_j & rem[:, None])
            nsel = nsel + add.long()
        return maskX

    return ggc


def make_bggc(reward_fn: Callable, budget: int):
    """Batched GGC (Algorithm 3): the preprocessing variant that receives
    models in batches of <= budget and keeps only the streaming sums
    w^X / w^Y. Phase 1 adds the batch sums into w^Y in batch order (one
    (K, b) @ (b, P) graph_mix launch per batch); phase 2 makes the
    decisions in the same shuffled order as GGC, so the output equals
    GGC's (Theorem 1; tested). Same signature as `make_ggc`'s result.
    """
    step = greedy_decision_step(reward_fn)

    @torch.no_grad()
    def bggc(keys, k_idx, cand_mask, flat_w, p):
        N = flat_w.shape[0]
        self_k = _self_mask(k_idx, N)
        cand_mask = cand_mask & ~self_k
        _tally_candidates(cand_mask)
        # --- phase 1: stream batches to accumulate w^Y (Alg. 3 lines 2-7)
        maskY0 = cand_mask | self_k
        wY = p[k_idx][:, None] * flat_w[k_idx]
        pY = p[k_idx]
        B = max(int(budget), 1)
        for s in range(0, N, B):
            e = min(s + B, N)
            m = maskY0[:, s:e] & ~self_k[:, s:e]
            mask_p = m.float() * p[None, s:e]
            wY = wY + weighted_sum(mask_p, flat_w[s:e])
            pY = pY + mask_p.sum(dim=1)
        # --- phase 2: batched decisions in the same shuffled order; each
        # batch receives <= B_c models
        carry = GreedyCarry(maskX=self_k, maskY=maskY0,
                            wX=p[k_idx][:, None] * flat_w[k_idx], wY=wY,
                            pX=p[k_idx], pY=pY,
                            nsel=torch.zeros_like(k_idx))
        order, coins = _streams(keys, N)
        for s in range(0, N, B):
            carry = _scan(step, carry, order, coins, flat_w, p, k_idx,
                          cand_mask, budget, range(s, min(s + B, N)))
        return carry.maskX

    return bggc


def make_ggc_heterogeneous(reward_fn: Callable, max_budget: int):
    """Per-client budgets B_c^k (the paper's §Limitations): `make_ggc`
    with the budget a (K,) tensor, so one scan serves every client.
    ``max_budget`` is kept for `repro`'s signature; the per-client
    budgets are what constrain the selection.

    Returns ``ggc(keys, k_idx, cand_mask, flat_w, p, budget_k)``."""
    base = make_ggc(reward_fn, int(max_budget))

    def ggc(keys, k_idx, cand_mask, flat_w, p, budget_k):
        return base(keys, k_idx, cand_mask, flat_w, p, budget_k=budget_k)

    return ggc


@exchange_site(charges="caller")
def _graph_inputs(key, flat_w, mesh=None, client_axes=None):
    """``(keys, k_idx, peers)`` of a graph build: the clients whose rows
    it selects (global ids ``k_idx``, keys ``fold_in(key, k)``) and the
    (N, P) peer panel their greedy probes. All N clients and ``flat_w``
    itself; under ``mesh`` this rank's rows and the panel gathered once
    from every shard (`repro.core.graph._shard_clients_graph`)."""
    n, peers = flat_w.shape[0], flat_w
    if mesh is not None:
        peers = _coll.all_gather_rows(flat_w, mesh, client_axes)
    row0 = first_row(mesh, client_axes, n)
    k_idx = torch.arange(row0, row0 + n, device=flat_w.device)
    return prng.fold_in(key, k_idx), k_idx, peers


def all_clients_graph(key, flat_w, p, cand_masks, reward_fn, budget,
                      impl: str = "ggc", mesh=None, client_axes=None):
    """Graph construction for every client in one batch. cand_masks:
    (N, N) bool, row k = Omega_k. Returns the (N, N) bool adjacency,
    adj[k, i] = 1 iff i is selected for k (diagonal True). Under
    ``mesh``, ``flat_w`` and ``cand_masks`` are the rank's rows and so is
    the result."""
    if impl == "naive":
        ggc = make_ggc_naive(reward_fn, budget)
    elif impl == "ggc":
        ggc = make_ggc(reward_fn, budget)
    else:
        raise NotImplementedError(f"graph_impl {impl!r} is not ported "
                                  f"(the port has 'ggc' and 'naive')")
    keys, k_idx, peers = _graph_inputs(key, flat_w, mesh, client_axes)
    return ggc(keys, k_idx, cand_masks, peers, p)


def all_clients_bggc(key, flat_w, p, cand_masks, reward_fn, budget,
                     mesh=None, client_axes=None):
    """Batched-GGC preprocessing for every client in one batch (same
    ``fold_in(key, k)`` streams as `all_clients_graph`; ``mesh`` as
    there)."""
    bggc = make_bggc(reward_fn, budget)
    keys, k_idx, peers = _graph_inputs(key, flat_w, mesh, client_axes)
    return bggc(keys, k_idx, cand_masks, peers, p)


def all_clients_graph_heterogeneous(key, flat_w, p, cand_masks, reward_fn,
                                    budgets, reachability=None, mesh=None,
                                    client_axes=None):
    """Per-client budgets and an optional communicability restriction
    (both from the paper's §Limitations). budgets: (N,) int; reachability:
    (N, N) bool, client k may only ever talk to reachable peers. Under
    ``mesh``, ``flat_w``, ``cand_masks`` and ``reachability`` are the
    rank's rows, ``budgets`` whole."""
    if reachability is not None:
        cand_masks = cand_masks & reachability
    budgets = torch.as_tensor(budgets, device=flat_w.device).long()
    ggc = make_ggc_heterogeneous(reward_fn, int(budgets.max()))
    keys, k_idx, peers = _graph_inputs(key, flat_w, mesh, client_axes)
    return ggc(keys, k_idx, cand_masks, peers, p, budgets[k_idx])


# ------------------------------------------------- sparse neighbor lists
#
# Budget-sparse representation: the constrained greedy keeps |C_k| <= B,
# so the collaboration graph is stored as (N, B) int32 neighbor-index
# lists (ascending global client ids, -1 = empty slot, self excluded: the
# Eq.-4 self term is implicit) instead of (N, N) masks. Decisions,
# download counts and wire bytes are the same integers in both layouts;
# only the fp summation order of the mix differs.


def _lists(off, budget: int):
    """(K, n) bool off-diagonal selections -> (K, budget) int32 lists of
    the selected ids, ascending, -1 padding the unused slots."""
    n = off.shape[1]
    ar = torch.arange(n, device=off.device)
    # selected ids ascend; unselected ones sort after them as n + id
    sel = torch.sort(torch.where(off, ar, n + ar), dim=1).values
    idx = torch.where(sel < n, sel, -1)[:, :min(budget, n)].to(torch.int32)
    if budget > n:
        idx = torch.nn.functional.pad(idx, (0, budget - n), value=-1)
    return idx.contiguous()


def mask_to_neighbors(mask, k_idx, budget: int):
    """One client's (N,) bool selection mask -> its (budget,) int32
    neighbor list: the selected off-diagonal peers, ascending, -1
    padding the unused slots. Lossless for selections of <= budget
    peers, which the budget-constrained greedy guarantees."""
    off = mask.bool() & (torch.arange(mask.shape[0], device=mask.device)
                         != k_idx)
    return _lists(off[None, :], budget)[0]


def neighbors_from_adjacency(adj, budget: int, row0: int = 0):
    """(N, N) bool adjacency -> (N, budget) int32 neighbor lists, row k =
    `mask_to_neighbors` of row k. Inverse of `adjacency_from_neighbors`
    whenever every row has <= budget peers. ``adj`` may be a row block
    starting at row ``row0``."""
    m, n = adj.shape
    return _lists(adj.bool() & ~eye_rows(m, n, row0, adj.device), budget)


def adjacency_from_neighbors(idx, n: int, row0: int = 0):
    """(N, B) int32 neighbor lists -> (N, n) bool adjacency with the
    diagonal forced True (every client collaborates with itself); the
    lists of rows ``row0 ...`` give that row block."""
    m = idx.shape[0]
    valid = idx >= 0
    hits = torch.zeros((m, n), dtype=torch.int64, device=idx.device)
    hits.scatter_add_(1, idx.clamp(0, n - 1).long(), valid.long())
    return (hits > 0) | eye_rows(m, n, row0, idx.device)


def count_neighbor_downloads(idx, active=None, row0: int = 0):
    """Realized model downloads encoded by neighbor lists ``idx`` (N, B):
    one per non-sentinel slot, as a 0-d int64 tensor (no host sync). It
    equals the off-diagonal edge count of the equivalent dense adjacency,
    so dense and sparse comm accounting cannot drift. ``active`` ((N,)
    bool) counts only available downloader/peer pairs. The lists of a
    row block (rows ``row0 ...``) count that block's downloads."""
    valid = idx >= 0
    if active is not None:
        act = active.bool()
        m, N = idx.shape[0], act.shape[0]
        valid = valid & act[row0:row0 + m, None] \
            & act[idx.clamp(0, N - 1).long()]
    return valid.sum()


def sparse_eq4_unnormalized(idx, p, active=None, row0: int = 0):
    """Neighbor-list counterpart of `eq4_weights_unnormalized`: returns
    ``(p, w)``, the (N,) fp32 self weights and the (N, B) fp32 peer
    weights (``p[idx]``, 0 at empty or participation-masked slots)
    before row normalization. The lists may be a row block starting at
    row ``row0`` (``p`` and ``active`` whole)."""
    m, N = idx.shape[0], p.shape[0]
    p = p.float()
    safe = idx.clamp(0, N - 1).long()
    w = (idx >= 0).float()
    if active is not None:
        act = active.float()
        w = w * act[row0:row0 + m, None] * act[safe]
    return p[row0:row0 + m], w * p[safe]


def sparse_mixing_weights(idx, p, active=None, row0: int = 0):
    """Eq.-4 row weights in neighbor-list form: ``(self_w (N,), nbr_w
    (N, B))`` with ``self_w[k] + sum_b nbr_w[k, b] = 1``, exactly the
    nonzero entries of `mixing_matrix`'s row k (diagonal forced on,
    p-weighted, normalized; ``active`` and ``row0`` as there)."""
    p, w = sparse_eq4_unnormalized(idx, p, active=active, row0=row0)
    denom = torch.clamp_min(p + w.sum(dim=1), 1e-12)
    return p / denom, w / denom[:, None]


@exchange_site(charges="caller")
def mix_flat_sparse(self_w, nbr_w, idx, flat_w, peers=None, *, mesh=None,
                    client_axes=None):
    """Eq.-4 mix in neighbor-list form: each client gathers only its
    <= B selected peer rows (`kernels.ops.sparse_graph_mix`), never the
    dense (N, N) @ (N, P) product. ``peers`` (default ``flat_w``) is the
    peer-visible model table, the decoded payloads under compression;
    the self term always reads the exact local row of ``flat_w``. Under
    ``mesh`` every table is the rank's rows and the peer panels rotate
    shard to shard, only the requested rows kept."""
    peers = flat_w if peers is None else peers
    return _kops.sparse_graph_mix(
        self_w.float().contiguous(), nbr_w.float().contiguous(),
        idx.to(torch.int32).contiguous(), flat_w.contiguous(),
        peers.contiguous(), **mesh_kw(mesh, client_axes))


def make_ggc_sparse(reward_fn: Callable, budget: int):
    """GGC emitting neighbor lists: each client's scan visits only its
    <= B candidate slots, in the order the dense scan would reach them
    (the position of each global id in ``permutation(fold_in(key_k, 0),
    N)``). Skipped non-candidates are exact no-ops of the dense scan and
    the coin flip of candidate j is ``uniform(fold_in(key_k, j + 1))`` in
    both, so the selections equal `make_ggc`'s on the equivalent masks,
    bit for bit.

    Returns ``ggc(keys (K, 2), k_idx (K,), cand_idx (K, B), flat_w (N, P),
    p (N,), active=None) -> (K, B) int32``: each client's selected C_k,
    ascending, -1 padded. ``active`` ((N,) bool) leaves only available
    candidates of available clients (an absent client selects nobody;
    keeping its previous C_k is the caller's)."""
    step = greedy_decision_step(reward_fn)

    @torch.no_grad()
    def ggc(keys, k_idx, cand_idx, flat_w, p, active=None):
        N = flat_w.shape[0]
        K, B = cand_idx.shape
        dev = flat_w.device
        safe = cand_idx.clamp(0, N - 1).long()
        valid = (cand_idx >= 0) & (safe != k_idx[:, None])
        if active is not None:
            valid = valid & active[safe] & active[k_idx][:, None]
        _tally_candidates(valid)
        # running sums start from the same masked (K, N) @ (N, P) launch
        # as the dense scan, so the probes start bitwise aligned
        hits = torch.zeros((K, N), dtype=torch.int64, device=dev)
        cand_mask = hits.scatter_add_(1, safe, valid.long()) > 0
        full = _greedy_init(k_idx, cand_mask, flat_w, p)
        carry = full._replace(
            maskX=torch.zeros((K, B), dtype=torch.bool, device=dev),
            maskY=valid)
        # visit the slots in dense-permutation order; invalid slots
        # (no-ops) go last, in a fixed order
        order = prng.permutation(prng.fold_in(keys, 0), N)
        inv = torch.argsort(order, dim=1)
        rank = torch.where(valid, inv.gather(1, safe), N + safe)
        visit = torch.argsort(rank, dim=1, stable=True)
        coins = prng.uniform(prng.fold_in(keys[:, None, :], safe + 1))
        for s in range(B):
            with _obs.span("ggc.position"):
                slot = visit[:, s]
                col = slot[:, None]
                j = safe.gather(1, col)[:, 0]
                carry = step(carry, j, flat_w[j],
                             u=coins.gather(1, col)[:, 0], k_idx=k_idx,
                             is_cand=valid.gather(1, col)[:, 0], p_j=p[j],
                             budget=budget, slot=slot)
        # canonical output order: ascending global id, -1 slots last
        sel = torch.sort(torch.where(carry.maskX, safe, N + safe),
                         dim=1).values
        return torch.where(sel < N, sel, -1).to(torch.int32)

    return ggc


def all_clients_graph_sparse(key, flat_w, p, cand_idx, reward_fn,
                             budget: int, active=None, mesh=None,
                             client_axes=None):
    """Sparse-representation graph construction for every client in one
    batch: candidates and selections are (N, B) neighbor lists, and each
    client's greedy probes only its <= B candidates. Selects what
    `all_clients_graph` selects on the equivalent masks. ``active``
    restricts the candidates to available peers (absent clients keep
    their previous C_k: the caller's, as in the dense path). Under
    ``mesh``, ``flat_w`` and ``cand_idx`` are the rank's rows and so is
    the result."""
    ggc = make_ggc_sparse(reward_fn, budget)
    keys, k_idx, peers = _graph_inputs(key, flat_w, mesh, client_axes)
    return ggc(keys, k_idx, cand_idx, peers, p, active=active)


def all_clients_bggc_sparse(key, flat_w, p, reward_fn, budget: int,
                            mesh=None, client_axes=None):
    """Batched-GGC preprocessing emitting (N, B) Omega lists. Algorithm 3
    streams every peer (full candidacy), so this is `all_clients_bggc`
    with full candidate masks, converted to lists of width
    ``max(1, min(budget, N - 1))`` (a client selects at most that many
    peers; the round buffers use the same width). ``mesh`` as in
    `all_clients_bggc`."""
    n, N = flat_w.shape[0], p.shape[0]
    row0 = first_row(mesh, client_axes, n)
    cand = ~eye_rows(n, N, row0, flat_w.device)
    omega = all_clients_bggc(key, flat_w, p, cand, reward_fn, budget,
                             mesh=mesh, client_axes=client_axes)
    return neighbors_from_adjacency(omega, max(1, min(budget, N - 1)),
                                    row0)
