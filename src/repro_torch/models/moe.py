"""Top-k Mixture-of-Experts with expert parallelism (port of
`repro.models.moe`).

The router's softmax runs in fp32 and picks each token's top k experts
(ties to the lower expert id, as ``lax.top_k``); the gates are the k
probabilities renormalised. Each of the T * k token copies goes to its
expert through a stable sort by expert id, and the experts' SwiGLU
MLPs run as batched matrix products:

* ``"capacity"`` (the default, `_moe_capacity`): the first ``cap``
  copies of each expert fill an (E, cap, d) buffer and three ``bmm``
  run over it; the copies past an expert's capacity are dropped
  (GShard's semantics, ``cap = max(int(1.25 T k / E), 8)``).
* ``"ragged"`` (`_moe_ragged`): dropless, one product per expert over
  its run of sorted copies. It reads the group sizes on the host.

Each token's k weighted outputs are summed in a fixed order, ascending
sorted position (the order `repro`'s scatter-add meets them), with no
float atomics, so a rerun gives the same bits. The capacity path makes
no device-to-host copy, so it runs under the decode loop's no-sync
fence. `repro` wrote no Pallas kernel here (XLA's einsums and
``ragged_dot``); neither does the port.

Expert parallelism (`moe_apply` with a ("data", "model") mesh,
`repro`'s ``shard_map`` branch): a rank holds E / M experts (`MoE` built
with the mesh) and its block of the batch on ``data``, the activations
whole across ``model``, so the dispatch needs no exchange of tokens. The
rank routes its own rows, runs the dispatch over its experts
``[i E / M, (i + 1) E / M)`` with the capacity of its own token count,
and one `psum` over ``model`` combines the ranks' outputs. The aux loss
is `repro`'s over the whole batch: the router's column sums, the top-k
counts and the token count are summed over ``data`` first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import prng
from ..configs.base import ArchConfig
from ..kernels.meta import RefusedValue
from ..sharding import collectives as coll
from ..sharding.rules import check_model_mesh
from .common import dense_init


def expert_block(cfg: ArchConfig, mesh=None) -> Tuple[int, int]:
    """(first expert, experts) a rank holds: all E without a mesh, else
    its block of E / M at ``axis_index("model")`` of a ("data", "model")
    mesh. Raises ``ValueError`` for another mesh or where M does not
    divide E."""
    E = cfg.n_experts
    if mesh is None:
        return 0, E
    check_model_mesh(mesh)
    M = coll.axes_size(mesh, "model")
    if E % M:
        raise RefusedValue(f"{E} experts do not split over a model axis of "
                           f"{M}")
    return coll.axis_index(mesh, "model") * (E // M), E // M


def init_moe(key: torch.Tensor, cfg: ArchConfig, dtype,
             mesh=None) -> dict:
    """`repro`'s MoE init for ``key`` on its device: the router (d, E) in
    float32 whatever ``dtype``, the experts' (E, d, f) gate and up and
    (E, f, d) down weights. `dense_init` scales by 1/sqrt(shape[0]), so
    the expert weights by 1/sqrt(E), as in `repro`. With a mesh only the
    rank's experts (`expert_block`) are drawn: those rows of the whole
    draw, bit for bit."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
    first, n = expert_block(cfg, mesh)
    rows = None if n == E else (first, first + n)
    ks = prng.split(key, 4)
    return {"router": dense_init(ks[0], (d, E), torch.float32),
            "we_gate": dense_init(ks[1], (E, d, f), dtype, rows=rows),
            "we_up": dense_init(ks[2], (E, d, f), dtype, rows=rows),
            "we_down": dense_init(ks[3], (E, f, d), dtype, rows=rows)}


class MoE(nn.Module):
    """One MoE block's weights under `repro`'s names: router (d, E)
    float32, we_gate and we_up (E_l, d, f), we_down (E_l, f, d), E_l = E,
    or E / M built with a ("data", "model") mesh of M ranks on ``model``
    (the rank's experts, `expert_block`). Calling it is `moe_apply`."""

    def __init__(self, cfg: ArchConfig, dtype, device, mesh=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
        E_l = expert_block(cfg, mesh)[1]

        def weight(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))
        self.router = weight((d, E), torch.float32)
        self.we_gate = weight((E_l, d, f))
        self.we_up = weight((E_l, d, f))
        self.we_down = weight((E_l, f, d))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                impl: str = "capacity", mesh=None, data_axes=("data",)):
        return moe_apply(self, x, cfg, mesh=mesh, impl=impl,
                         data_axes=data_axes)


def router_probs(x2d: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, E) softmax of the fp32 router logits."""
    return torch.softmax(x2d.float() @ router_w, dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values and their
    indices, equal values in ascending index order (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def load_balance_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e, f_e the share of
    routed copies at expert e (counted in integers), P_e its mean
    probability."""
    pe = probs.mean(dim=0)
    counts = _bincount(topk_idx.reshape(-1), n_experts).float()
    fe = counts / counts.sum().clamp_min(1.0)
    return n_experts * torch.sum(fe * pe)


def router_stats(probs: torch.Tensor, topk_idx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """(2E + 1,) fp32: the router probabilities' column sums, the top-k
    counts and the token count of a block of tokens. Summed over blocks,
    they give the blocks' `load_balance_loss` together
    (`load_balance_from_stats`); the counts are exact integers in fp32."""
    return torch.cat([probs.sum(0),
                      _bincount(topk_idx.reshape(-1), n_experts).float(),
                      probs.new_full((1,), float(probs.shape[0]))])


def load_balance_from_stats(stats: torch.Tensor,
                            n_experts: int) -> torch.Tensor:
    """`load_balance_loss` from `router_stats` (summed over blocks):
    E * sum_e f_e * P_e."""
    E = n_experts
    counts = stats[E:2 * E]
    return E * torch.sum(counts / counts.sum().clamp_min(1.0)
                         * stats[:E] / stats[2 * E])


def capacity(T: int, k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Slots per expert in `_moe_capacity`: max(int(factor T k / E), 8),
    a host int from static shapes."""
    return max(int(capacity_factor * (T * k) / max(n_experts, 1)), 8)


def _bincount(v: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of 0..n-1 in ``v`` (int64), by an integer scatter-add:
    ``torch.bincount`` reads its length on the host."""
    return torch.zeros(n, dtype=torch.int64, device=v.device).scatter_add_(
        0, v, torch.ones_like(v))


def _dispatch(topk_idx: torch.Tensor, first_expert: int, E_l: int):
    """The copies of experts [first, first + E_l) sorted by local expert,
    the others last (bucket E_l). Returns (order, local expert of each
    sorted copy, group sizes (E_l + 1,), position in its group)."""
    flat_e = topk_idx.reshape(-1)
    local = (flat_e >= first_expert) & (flat_e < first_expert + E_l)
    le = torch.where(local, flat_e - first_expert,
                     torch.full_like(flat_e, E_l))
    order = torch.argsort(le, stable=True)
    sorted_le = le[order]
    group_sizes = _bincount(le, E_l + 1)
    seg_start = torch.cumsum(group_sizes, 0) - group_sizes
    pos = torch.arange(le.numel(), device=le.device) - seg_start[sorted_le]
    return order, sorted_le, group_sizes, pos


def _copies(x: torch.Tensor, k: int) -> torch.Tensor:
    """(T, d) -> (T k, d), row t k + j a copy of row t: ``x[order // k]``
    is ``_copies(x, k)[order]``, a gather whose backward writes each row
    once (the k copies' gradients then summed by the expand's backward),
    where gathering ``x`` itself would accumulate k rows a token in the
    order of the card's atomics."""
    return x[:, None].expand(x.shape[0], k, x.shape[1]).reshape(-1,
                                                                x.shape[1])


def _combine(vals: torch.Tensor, order: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """``zeros((T, d)).at[order // k].add(vals)`` with each token's k
    rows of ``vals`` (in sorted order) summed in ascending sorted
    position, one plain addition after another: `repro`'s scatter-add on
    the CPU, without atomics."""
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    rows = torch.sort(inv.reshape(T, k), dim=1).values
    out = vals[rows[:, 0]]
    for j in range(1, k):
        out = out + vals[rows[:, j]]
    return out


def _moe_capacity(x: torch.Tensor, we_gate, we_up, we_down,
                  topk_idx: torch.Tensor, gates: torch.Tensor,
                  first_expert: int, n_global_experts: Optional[int] = None,
                  capacity_factor: float = 1.25) -> torch.Tensor:
    """GShard-style dispatch of the copies routed to experts [first,
    first + E_l): the first ``cap`` (`capacity`) of each expert, in sorted
    order, fill an (E_l, cap, d) buffer, gathered (each slot takes its
    copy's row, an empty slot zeros); three ``bmm``; each kept copy's
    output weighted by its gate back to its token (`_combine`), the
    dropped ones weighted 0. x: (T, d) -> (T, d)."""
    E_l = we_gate.shape[0]
    T, d = x.shape
    k = topk_idx.shape[1]
    order, sorted_le, group_sizes, pos = _dispatch(topk_idx, first_expert,
                                                   E_l)
    cap = capacity(T, k, n_global_experts or E_l, capacity_factor)
    keep = (pos < cap) & (sorted_le < E_l)
    slot = torch.where(keep, sorted_le * cap + pos,
                       torch.full_like(pos, E_l * cap))
    # the buffer's slot e * cap + j holds sorted copy seg_start[e] + j
    # when j < group_sizes[e]; the others read the zero row past the end
    seg_start = torch.cumsum(group_sizes, 0) - group_sizes
    j = torch.arange(cap, device=x.device)
    src = seg_start[:E_l, None] + j
    src = torch.where(j < group_sizes[:E_l, None], src,
                      torch.full_like(src, T * k)).reshape(-1)
    xs = torch.cat([_copies(x, k)[order], x.new_zeros((1, d))])
    xe = xs[src].reshape(E_l, cap, d)
    h = F.silu(torch.bmm(xe, we_gate)) * torch.bmm(xe, we_up)
    oe = torch.bmm(h, we_down).reshape(E_l * cap, d)
    w = gates.reshape(-1)[order] * keep.to(gates.dtype)
    vals = oe[slot.clamp_max(E_l * cap - 1)] * w[:, None].to(oe.dtype)
    return _combine(vals, order, T, k)


def _moe_ragged(x: torch.Tensor, we_gate, we_up, we_down,
                topk_idx: torch.Tensor, gates: torch.Tensor,
                first_expert: int,
                n_global_experts: Optional[int] = None) -> torch.Tensor:
    """Dropless: each local expert's run of sorted copies through its
    MLP (``ragged_dot`` in `repro`), the copies of other experts zeros;
    weighted and summed back as in `_moe_capacity`. The group sizes are
    read on the host (one device-to-host copy a call)."""
    E_l = we_gate.shape[0]
    T, d = x.shape
    k = topk_idx.shape[1]
    order, sorted_le, group_sizes, _ = _dispatch(topk_idx, first_expert,
                                                 E_l)
    xs = _copies(x, k)[order]
    parts, start = [], 0
    for e, n in enumerate(group_sizes[:E_l].tolist()):
        seg = xs[start:start + n]
        h = F.silu(seg @ we_gate[e]) * (seg @ we_up[e])
        parts.append(h @ we_down[e])
        start += n
    parts.append(x.new_zeros((T * k - start, d)))
    out = torch.cat(parts)
    w = gates.reshape(-1)[order] * (sorted_le < E_l).to(gates.dtype)
    return _combine(out * w[:, None].to(out.dtype), order, T, k)


MOE_IMPLS = {"ragged": _moe_ragged, "capacity": _moe_capacity}


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, mesh=None,
              impl: str = "capacity", data_axes=("data",)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), the fp32 aux loss), ``p`` a `MoE`
    (or any object with its four weights as attributes): the fp32
    router's top k with the gates renormalised and cast to x's dtype,
    then the ``impl`` dispatch, "capacity" or "ragged".

    With a ("data", "model") ``mesh`` (`repro`'s ``shard_map`` branch):
    ``x`` is this rank's block of the batch on ``data``, ``p`` holds the
    rank's experts (`expert_block`); the dispatch runs over them with the
    capacity of the block's own token count, a `psum` over ``model``
    combines the ranks' outputs, and the aux loss is the whole batch's
    (the router's column sums, the top-k counts and the token count
    summed over ``data`` in one `psum`; with ``data_axes`` () the batch
    is whole on every rank, and the statistics are its own, as `repro`'s
    ``moe_data_axes`` ()). Its gradient is `repro`'s: the
    two sums pass their cotangents through (`collectives.psum_replicated`:
    the output and the aux loss are whole on every rank of their groups),
    and the tokens and gates entering the rank's experts sum theirs over
    ``model`` (`collectives.pvary`), so a rank's weights get the gradient
    of its block of the batch; the step sums those over ``data``
    (`repro_torch.launch.steps.make_train_step`)."""
    kernel = MOE_IMPLS[impl]
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    probs = router_probs(x2, p.router)
    gates, topk_idx = top_k(probs, cfg.topk)
    gates = (gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)
    if mesh is None:
        aux = load_balance_loss(probs, topk_idx, cfg.n_experts)
        out = kernel(x2, p.we_gate, p.we_up, p.we_down, topk_idx, gates, 0,
                     cfg.n_experts)
        return out.reshape(B, S, d), aux
    E = cfg.n_experts
    first, E_l = expert_block(cfg, mesh)
    if p.we_gate.shape[0] != E_l:
        raise ValueError(f"moe_apply: the weights hold "
                         f"{p.we_gate.shape[0]} experts, the rank's block "
                         f"is {E_l} (build the MoE with the mesh)")
    stats = router_stats(probs, topk_idx, E)
    if data_axes:
        stats = coll.psum_replicated(stats, mesh, tuple(data_axes))
    aux = load_balance_from_stats(stats, E)
    out = kernel(coll.pvary(x2, mesh, "model"), p.we_gate, p.we_up,
                 p.we_down, topk_idx, coll.pvary(gates, mesh, "model"),
                 first, E)
    return coll.psum_replicated(out, mesh, "model").reshape(B, S, d), aux


def router_gap(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The smallest gap, over the tokens, between the k-th and the
    (k+1)-th largest router probability: how near the top-k choice
    came to a tie (inf with k experts or fewer)."""
    if probs.shape[-1] <= k:
        return torch.full((), float("inf"), device=probs.device)
    top = torch.topk(probs, k + 1, dim=-1).values
    return (top[..., k - 1] - top[..., k]).min()


def dropped_copies(topk_idx: torch.Tensor, n_experts: int,
                   capacity_factor: float = 1.25, first_expert: int = 0,
                   n_local: Optional[int] = None) -> torch.Tensor:
    """How many of the T k routed copies to experts [first_expert,
    first_expert + n_local) (default: all of them) `_moe_capacity` drops
    (a device int64 scalar): those past their expert's capacity, which
    ``n_experts`` (the global count) and T size."""
    T, k = topk_idx.shape
    n_local = n_experts if n_local is None else n_local
    counts = _bincount(topk_idx.reshape(-1), n_experts)
    cap = capacity(T, k, n_experts, capacity_factor)
    return (counts[first_expert:first_expert + n_local] - cap).clamp_min(
        0).sum()

