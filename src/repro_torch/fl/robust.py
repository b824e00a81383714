"""Robust Eq.-4 mixing rules: trimmed mean and update-norm clipping
(port of `repro.fl.robust`).

Eq. 4's weighted average is linear: one poisoned peer row moves every
client that selected it by an unbounded amount. These rules bound that
influence:

* ``trimmed``: coordinate-wise trimmed mean over the peer panel. Per row
  and coordinate, drop the ``floor(trim_frac * m)`` smallest and largest
  member values (m = members, self included, capped so one survives),
  then renormalize the surviving Eq.-4 weights. ``trim_frac=0`` gives
  the `mixing_matrix` / `sparse_mixing_weights` rows bit for bit.
* ``clipped``: peer i's weight in row k is scaled by
  ``gamma = min(1, tau_k / ||recv_i - flat_k||)``, with
  ``tau_k = clip_mult * ||flat_k - prev_k||``; the freed mass moves to
  the diagonal, so rows stay on the simplex; ``gamma == 1`` keeps every
  off-diagonal weight bit for bit, and a second pass changes no bit.

``clipped`` only reweights, so it reuses every mix kernel (K1, K2, K3).
``trimmed`` is an order statistic, not a matmul: it mixes through plain
reductions over an explicit (N, M, P) value panel (dense M = N, sparse
M = B + 1 with self in slot 0). The dense panel is `repro`'s moderate-N
path: at N 32 and P 62,006 it is 254 MB, and its two int64 rank tensors
508 MB each.

Both read the peer-visible table (decoded payloads under a codec, the
wire table under free riding) while the self term reads the exact local
row, the contract of `mix_flat_sparse` and `compress.mix_compressed`.
Everything here stays on the device: no host sync inside a round.

Under a client mesh a rank mixes its own rows: the dense functions take
its (n_loc, N) weight rows with ``row0``, its first global row, against
the all-gathered (N, P) peer table; the neighbor-list ones take the
(n_loc, B, P) panel of the peer rows its lists name (``nbr_rows``, from
the rotation of `kernels.ops.rotate`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis.registry import exchange_site
from ..sharding.rows import eye_rows

__all__ = ["MIX_RULES", "update_norms", "clip_factors", "clipped_matrix",
           "clip_factors_sparse", "clipped_sparse_weights",
           "trimmed_weights", "trimmed_weights_sparse",
           "trimmed_panel_dense", "trimmed_panel_sparse",
           "trimmed_mix_dense", "trimmed_mix_sparse"]

MIX_RULES = ("weighted", "trimmed", "clipped")


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python scalar: a float32 tensor
    times it multiplies by ``jnp.float32(x)``, with no host-to-device
    copy."""
    return float(np.float32(x))


# ------------------------------------------------------------- clipping
def update_norms(flat, prev):
    """(N,) L2 norms of this round's local updates ``flat - prev``."""
    d = flat - prev
    return torch.sqrt((d * d).sum(dim=1))


def _clip(d, flat, prev, clip_mult):
    tau = _f32(clip_mult) * update_norms(flat, prev)
    return torch.where(d <= tau[:, None], 1.0,
                       tau[:, None] / torch.clamp_min(d, 1e-30))


def clip_factors(recv, flat, prev, clip_mult):
    """(N, N) clip factors gamma[k, i] in (0, 1] for the dense panel: 1.0
    where peer i's received model lies within ``tau_k = clip_mult *
    ||flat_k - prev_k||`` of client k's own, ``tau_k / ||recv_i - flat_k||``
    beyond. ``tau_k = 0`` (no local update) clips every non-equal peer to
    0: the row falls back to self alone. Distances by the Gram expansion
    ``|f|^2 + |r|^2 - 2 f r^T``, as `repro` takes them, since ``d <= tau``
    decides; the product is a plain ``torch.matmul`` (TF32 off, as the
    engine sets it)."""
    d2 = ((flat * flat).sum(dim=1)[:, None]
          + (recv * recv).sum(dim=1)[None, :]
          - 2.0 * (flat @ recv.T))
    return _clip(torch.sqrt(torch.clamp_min(d2, 0.0)), flat, prev,
                 clip_mult)


def clipped_matrix(A, gamma, row0: int = 0):
    """Scale the off-diagonal entries of a row-stochastic Eq.-4 matrix by
    ``gamma`` and move the freed mass onto the diagonal. ``gamma == 1``
    keeps every off-diagonal entry bit for bit, so a second pass changes
    no bit (idempotence). ``A`` may be the row block from row ``row0``."""
    eye = eye_rows(A.shape[0], A.shape[1], row0, A.device).to(A.dtype)
    off = A * (1.0 - eye) * gamma
    return off + (1.0 - off.sum(dim=1, keepdim=True)) * eye


def clip_factors_sparse(recv_nbr, flat, prev, clip_mult):
    """(N, B) clip factors for a gathered neighbor panel ``recv_nbr``
    ((N, B, P), row k's B peer models); the rule of `clip_factors`.
    Factors at empty (-1) slots are finite junk that zero weights
    cancel."""
    diff = recv_nbr - flat[:, None, :]
    return _clip(torch.sqrt((diff * diff).sum(dim=-1)), flat, prev,
                 clip_mult)


def clipped_sparse_weights(self_w, nbr_w, gamma):
    """Neighbor-list `clipped_matrix`: scale the normalized neighbor
    weights by ``gamma`` and move the freed mass to the self weight."""
    nw = nbr_w * gamma
    return 1.0 - nw.sum(dim=1), nw


# ------------------------------------------------------------- trimming
def _trim_keep(w, vals, trim_frac):
    """(N, M, P) bool keep-mask of the coordinate-wise trimmed mean: per
    row, ``q = min(floor(float32(trim_frac) * m), (m - 1) // 2)`` members
    drop from each tail (m = members, ``w > 0``). Ranks are a double
    stable argsort of the member values with non-members at +inf, so
    members hold ranks 0..m-1 and equal values rank by slot, as jax's
    stable sort ranks them."""
    member = w > 0.0
    m = member.sum(dim=1)
    q = torch.minimum(torch.floor(_f32(trim_frac) * m.float()).long(),
                      (m - 1) // 2)
    ranked = torch.where(member[:, :, None], vals, float("inf"))
    rank = torch.argsort(torch.argsort(ranked, dim=1, stable=True), dim=1,
                         stable=True)
    return (member[:, :, None] & (rank >= q[:, None, None])
            & (rank < (m - q)[:, None, None]))


def _member_sum(wk):
    """(N, P) sums of (N, M, P) weights over the members, each
    coordinate's M weights summed as one contiguous row: the order of the
    row sum in `mixing_matrix` and `sparse_mixing_weights`, so that an
    untrimmed panel normalizes to their bits (on the CPU; a strided sum
    over axis 1 adds in another order)."""
    return wk.transpose(1, 2).contiguous().sum(dim=-1)


def trimmed_weights(w, vals, trim_frac):
    """(N, M, P) per-coordinate weights of the trimmed mean over a dense
    member panel: ``w`` (N, M) unnormalized Eq.-4 weights
    (`eq4_weights_unnormalized`), ``vals`` (N, M, P) member values."""
    wk = w[:, :, None] * _trim_keep(w, vals, trim_frac)
    return wk / torch.clamp_min(_member_sum(wk), 1e-12)[:, None, :]


def trimmed_weights_sparse(p_self, w_nbr, vals, trim_frac):
    """(N, B+1, P) trimmed-mean weights over the sparse panel (self in
    slot 0, then the B neighbor slots); ``p_self``, ``w_nbr`` from
    `sparse_eq4_unnormalized`. The normalizer keeps
    `sparse_mixing_weights`' operand order (self + sum over slots)."""
    w = torch.cat([p_self[:, None], w_nbr], dim=1)
    wk = w[:, :, None] * _trim_keep(w, vals, trim_frac)
    denom = torch.clamp_min(wk[:, 0] + _member_sum(wk[:, 1:]), 1e-12)
    return wk / denom[:, None, :]


def trimmed_panel_dense(flat, recv, row0: int = 0):
    """(N, N, P) member values: row k sees peer i's received model at slot
    i and its own exact row on the diagonal (``flat`` may be the rows
    from ``row0`` of the whole ``recv``)."""
    eye = eye_rows(flat.shape[0], recv.shape[0], row0, flat.device)
    return torch.where(eye[:, :, None], flat[:, None, :], recv[None, :, :])


def trimmed_panel_sparse(idx, flat, peers, nbr_rows=None):
    """(N, B+1, P) member values in neighbor-list form: the exact self row
    in slot 0, then the gathered peer rows (junk at -1 slots, which zero
    weights keep out of the members). ``nbr_rows`` ((N, B, P)) are the
    peer rows already fetched (under a mesh), in place of ``peers[idx]``."""
    if nbr_rows is None:
        nbr_rows = peers[idx.clamp(0, flat.shape[0] - 1).long()]
    return torch.cat([flat[:, None, :], nbr_rows], dim=1)


@exchange_site(charges="caller")
def trimmed_mix_dense(w, flat, recv, trim_frac, row0: int = 0):
    """Trimmed-mean Eq.-4 mix over the dense panel: ``w`` (N, N)
    unnormalized weights, ``recv`` the peer-visible (N, P) table (``w``
    and ``flat`` may be the rows from ``row0``)."""
    vals = trimmed_panel_dense(flat, recv, row0)
    return (trimmed_weights(w, vals, trim_frac) * vals).sum(dim=1)


@exchange_site(charges="caller")
def trimmed_mix_sparse(p_self, w_nbr, idx, flat, peers, trim_frac,
                       nbr_rows=None):
    """Trimmed-mean Eq.-4 mix in neighbor-list form over the <= B selected
    peer rows ((N, B+1, P) panel; ``nbr_rows`` as in
    `trimmed_panel_sparse`)."""
    vals = trimmed_panel_sparse(idx, flat, peers, nbr_rows)
    return (trimmed_weights_sparse(p_self, w_nbr, vals, trim_frac)
            * vals).sum(dim=1)
