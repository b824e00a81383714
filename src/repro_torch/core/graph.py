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

Not ported yet: the ``active=`` participation mask (ROADMAP Queue 1 item
8), the sparse neighbor-list builders (item 7), the heterogeneous-budget
variant and the client-mesh paths (item 12).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import prng
from ..analysis.registry import exchange_site
from ..kernels import ops as _kops


# ------------------------------------------------------------------ mixing


def eq4_weights_unnormalized(adj, p, active=None):
    """The Eq.-4 member weights before row normalization: (N, N) fp32
    with entry ``p_i`` where k receives from i (diagonal forced on), 0
    elsewhere."""
    if active is not None:
        raise NotImplementedError(
            "participation masks are not ported yet (ROADMAP Queue 1 item 8)")
    adj = adj.float()
    n = adj.shape[0]
    adj = torch.maximum(adj, torch.eye(n, dtype=adj.dtype, device=adj.device))
    return adj * p[None, :]


def mixing_matrix(adj, p, active=None):
    """adj: (N, N) bool/float, adj[k, i] = 1 iff k receives from i
    (diagonal forced on). p: (N,) weights. Returns the row-stochastic A
    with A[k, i] = p_i adj[k, i] / sum_j p_j adj[k, j]."""
    w = eq4_weights_unnormalized(adj, p, active=active)
    return w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)


@exchange_site(charges="caller")
def mix_flat(A, flat_w):
    """(N, P) client-stacked flattened params through the Eq.-4 mixing
    matmul (`kernels.ops.graph_mix`)."""
    return _kops.graph_mix(A.contiguous(), flat_w.contiguous())


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

    Returns ``step(carry, j, w_j, *, u, k_idx, is_cand, p_j, budget)``
    processing candidate ``j[r]`` (model ``w_j[r]``, coin flip ``u[r]``)
    for every client ``k_idx[r]`` of the batch: four reward probes per
    client in one batched forward, the a/(a+b) coin flip, and the
    running-sum accept/reject update.
    """

    def step(carry: GreedyCarry, j, w_j, *, u, k_idx, is_cand, p_j,
             budget) -> GreedyCarry:
        maskX, maskY, wX, wY, pX, pY, nsel = carry
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
            == j[:, None]
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
        j = order[:, s]
        col = j[:, None]
        carry = step(carry, j, flat_w[j], u=coins.gather(1, col)[:, 0],
                     k_idx=k_idx, is_cand=cand_mask.gather(1, col)[:, 0],
                     p_j=p[j], budget=budget)
    return carry


def _greedy_init(k_idx, cand_mask, flat_w, p) -> GreedyCarry:
    """Shared GGC initialization: X = {k}, Y = Omega_k ∪ {k}, running sums
    through one batched graph_mix launch."""
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
    p (N,)) -> (K, N) bool``: each client's selected collaborators,
    itself included.
    """
    step = greedy_decision_step(reward_fn)

    @torch.no_grad()
    def ggc(keys, k_idx, cand_mask, flat_w, p):
        N = flat_w.shape[0]
        cand_mask = cand_mask & ~_self_mask(k_idx, N)
        carry = _greedy_init(k_idx, cand_mask, flat_w, p)
        order, coins = _streams(keys, N)
        carry = _scan(step, carry, order, coins, flat_w, p, k_idx,
                      cand_mask, budget, range(N))
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


def _client_keys(key, N: int):
    """Client k's graph key: ``fold_in(key, k)``, for all k at once."""
    return prng.fold_in(key, torch.arange(N, device=key.device))


def all_clients_graph(key, flat_w, p, cand_masks, reward_fn, budget,
                      impl: str = "ggc"):
    """Graph construction for every client in one batch. cand_masks:
    (N, N) bool, row k = Omega_k. Returns the (N, N) bool adjacency,
    adj[k, i] = 1 iff i is selected for k (diagonal True)."""
    N = flat_w.shape[0]
    if impl == "naive":
        ggc = make_ggc_naive(reward_fn, budget)
    elif impl == "ggc":
        ggc = make_ggc(reward_fn, budget)
    else:
        raise NotImplementedError(f"graph_impl {impl!r} is not ported "
                                  f"(the port has 'ggc' and 'naive')")
    k_idx = torch.arange(N, device=flat_w.device)
    return ggc(_client_keys(key, N), k_idx, cand_masks, flat_w, p)


def all_clients_bggc(key, flat_w, p, cand_masks, reward_fn, budget):
    """Batched-GGC preprocessing for every client in one batch (same
    ``fold_in(key, k)`` streams as `all_clients_graph`)."""
    N = flat_w.shape[0]
    bggc = make_bggc(reward_fn, budget)
    k_idx = torch.arange(N, device=flat_w.device)
    return bggc(_client_keys(key, N), k_idx, cand_masks, flat_w, p)
