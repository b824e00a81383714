"""The port's robust Eq.-4 rules (`repro_torch.fl.robust`) against
`repro.fl.robust`, on the same numpy inputs.

Every function is held to `repro`'s: clip factors, clipped matrices and
weights, trimmed keep-masks, weights, panels and mixes (values within
rtol 1e-5, atol 1e-6: torch and XLA sum in different orders; the
trimmed keep-masks exactly, which the weights carry). Panels with tied
values (two peers sending the same row, a quantized grid of values) rank
ties by slot as jax's stable sort does. The port's own contracts, as
`repro` asserts of itself (tests/test_robust_mixing.py): ``trim_frac=0``
gives the `mixing_matrix` / `sparse_mixing_weights` rows bit for bit,
and clipping is idempotent bit for bit where every gamma is 1."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.fl import robust as jrob  # noqa: E402

from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.fl import robust as trob  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def T(a):
    """numpy -> torch, copied (JAX's arrays come back read-only)."""
    return torch.from_numpy(np.array(a))


def _setting(seed, n, with_active, p_dim=5, ties=None):
    """tests/test_robust_mixing.py's inputs. ``ties``: "rows" makes peers
    send copies of the same rows, "grid" draws every value from {-1, 0,
    1}."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 0.5
    p = (rng.random(n) + 0.1).astype(np.float32)
    p = p / p.sum()
    active = (rng.random(n) < 0.7) if with_active else None
    flat = rng.normal(size=(n, p_dim)).astype(np.float32)
    recv = rng.normal(size=(n, p_dim)).astype(np.float32)
    prev = rng.normal(size=(n, p_dim)).astype(np.float32)
    if ties == "rows":
        recv[1::2] = recv[0]
        flat[0] = recv[0]
    elif ties == "grid":
        recv = rng.integers(-1, 2, (n, p_dim)).astype(np.float32)
        flat = rng.integers(-1, 2, (n, p_dim)).astype(np.float32)
    return adj, p, active, flat, recv, prev


def _nbr_lists(rng, n, b):
    """(N, B) ascending neighbor lists, -1 pads, self excluded."""
    idx = np.full((n, b), -1, np.int32)
    for k in range(n):
        others = np.setdiff1d(np.arange(n), [k])
        m = rng.integers(0, min(b, n - 1), endpoint=True)
        if m:
            idx[k, :m] = np.sort(rng.choice(others, size=m, replace=False))
    return idx


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _act(active, lib):
    if active is None:
        return None
    return jnp.asarray(active) if lib == "jax" else T(active)


CASES = [(seed, n, act, ties) for seed, n, act, ties in [
    (0, 2, False, None), (1, 5, True, None), (2, 8, False, None),
    (3, 8, True, None), (4, 6, False, "rows"), (5, 7, True, "rows"),
    (6, 8, False, "grid"), (7, 5, True, "grid")]]
IDS = [f"s{s}-n{n}-{'act' if a else 'full'}-{t or 'plain'}"
       for s, n, a, t in CASES]


# ------------------------------------------------------------- clipping


@pytest.mark.parametrize("clip_mult", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_clip_factors_and_clipped_matrix_match_repro(case, clip_mult):
    seed, n, with_active, ties = case
    adj, p, active, flat, recv, prev = _setting(seed, n, with_active,
                                                ties=ties)
    _close(trob.update_norms(T(flat), T(prev)),
           jrob.update_norms(jnp.asarray(flat), jnp.asarray(prev)))
    jg = jrob.clip_factors(jnp.asarray(recv), jnp.asarray(flat),
                           jnp.asarray(prev), clip_mult)
    tg = trob.clip_factors(T(recv), T(flat), T(prev), clip_mult)
    _close(tg, jg)
    A = jgraph.mixing_matrix(jnp.asarray(adj), jnp.asarray(p),
                             active=_act(active, "jax"))
    _close(trob.clipped_matrix(T(np.asarray(A)), T(np.asarray(jg))),
           jrob.clipped_matrix(A, jg))
    A2 = trob.clipped_matrix(T(np.asarray(A)), tg).numpy()
    np.testing.assert_allclose(A2.sum(1), 1.0, atol=1e-5)
    assert np.all(A2 >= -1e-7)


@pytest.mark.parametrize("clip_mult", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sparse_clipping_matches_repro(case, clip_mult):
    seed, n, with_active, ties = case
    _, p, active, flat, recv, prev = _setting(seed, n, with_active,
                                              ties=ties)
    idx = _nbr_lists(np.random.default_rng(seed), n, 3)
    safe = np.clip(idx, 0, n - 1)
    jg = jrob.clip_factors_sparse(jnp.asarray(recv)[safe], jnp.asarray(flat),
                                  jnp.asarray(prev), clip_mult)
    tg = trob.clip_factors_sparse(T(recv)[T(safe).long()], T(flat), T(prev),
                                  clip_mult)
    _close(tg, jg)
    jsw, jnw = jgraph.sparse_mixing_weights(jnp.asarray(idx), jnp.asarray(p),
                                            active=_act(active, "jax"))
    for got, want in zip(
            trob.clipped_sparse_weights(T(np.asarray(jsw)),
                                        T(np.asarray(jnw)), tg),
            jrob.clipped_sparse_weights(jsw, jnw, jg)):
        _close(got, want)


@pytest.mark.parametrize("n", [2, 5, 8])
@pytest.mark.parametrize("seed", [0, 9])
def test_clipping_idempotent_on_small_updates(seed, n):
    """recv == flat and prev far away: every gamma is 1.0 exactly, a
    second pass changes no bit and the off-diagonal weights keep theirs
    (tests/test_robust_mixing.py's property, in the port)."""
    adj, p, _, flat, _, _ = _setting(seed, n, False)
    prev = flat - 10.0
    A = tgraph.mixing_matrix(T(adj), T(p))
    gamma = trob.clip_factors(T(flat), T(flat), T(prev), 1.0)
    np.testing.assert_array_equal(gamma.numpy(), np.ones((n, n), np.float32))
    A2 = trob.clipped_matrix(A, gamma)
    A3 = trob.clipped_matrix(A2, gamma)
    np.testing.assert_array_equal(A2.numpy(), A3.numpy())
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(A2.numpy()[off], A.numpy()[off])
    idx = tgraph.neighbors_from_adjacency(T(adj), n)
    sw, nw = tgraph.sparse_mixing_weights(idx, T(p))
    g1 = torch.ones(nw.shape)
    sw2, nw2 = trob.clipped_sparse_weights(sw, nw, g1)
    sw3, nw3 = trob.clipped_sparse_weights(sw2, nw2, g1)
    np.testing.assert_array_equal(nw2.numpy(), nw.numpy())
    np.testing.assert_array_equal(sw3.numpy(), sw2.numpy())


def test_zero_update_clips_row_to_self():
    """tau = 0 (the held row of an absent client): every peer at a
    positive distance gets gamma 0, the row is e_k."""
    flat = np.eye(3, 4, dtype=np.float32)
    A = tgraph.mixing_matrix(torch.ones((3, 3), dtype=torch.bool),
                             torch.ones(3))
    gamma = trob.clip_factors(T(flat), T(flat), T(flat), 1.0)
    np.testing.assert_array_equal(gamma.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(trob.clipped_matrix(A, gamma).numpy(),
                                  np.eye(3, dtype=np.float32))


# ------------------------------------------------------------- trimming


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.34, 0.49])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_trimming_matches_repro(case, trim):
    seed, n, with_active, ties = case
    adj, p, active, flat, recv, _ = _setting(seed, n, with_active, ties=ties)
    jw = jgraph.eq4_weights_unnormalized(jnp.asarray(adj), jnp.asarray(p),
                                         active=_act(active, "jax"))
    tw = tgraph.eq4_weights_unnormalized(T(adj), T(p),
                                         active=_act(active, "torch"))
    _close(tw, jw)
    jvals = jrob.trimmed_panel_dense(jnp.asarray(flat), jnp.asarray(recv))
    tvals = trob.trimmed_panel_dense(T(flat), T(recv))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(
        trob._trim_keep(T(np.asarray(jw)), tvals, trim).numpy(),
        np.asarray(jrob._trim_keep(jw, jvals, trim)))
    _close(trob.trimmed_weights(T(np.asarray(jw)), tvals, trim),
           jrob.trimmed_weights(jw, jvals, trim))
    _close(trob.trimmed_mix_dense(T(np.asarray(jw)), T(flat), T(recv), trim),
           jrob.trimmed_mix_dense(jw, jnp.asarray(flat), jnp.asarray(recv),
                                  trim))
    if trim == 0.0:
        A = tgraph.mixing_matrix(T(adj), T(p), active=_act(active, "torch"))
        got = trob.trimmed_weights(tw, tvals, 0.0)
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(A.numpy()[:, :, None], got.shape))


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.34, 0.49])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sparse_trimming_matches_repro(case, trim):
    seed, n, with_active, ties = case
    _, p, active, flat, recv, _ = _setting(seed, n, with_active, ties=ties)
    idx = _nbr_lists(np.random.default_rng(seed + 1), n, 4)
    jp, jw = jgraph.sparse_eq4_unnormalized(jnp.asarray(idx), jnp.asarray(p),
                                            active=_act(active, "jax"))
    tp, tw = tgraph.sparse_eq4_unnormalized(T(idx), T(p),
                                            active=_act(active, "torch"))
    _close(tp, jp)
    _close(tw, jw)
    jvals = jrob.trimmed_panel_sparse(jnp.asarray(idx), jnp.asarray(flat),
                                      jnp.asarray(recv))
    tvals = trob.trimmed_panel_sparse(T(idx), T(flat), T(recv))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    jcat = jnp.concatenate([jp[:, None], jw], axis=1)
    np.testing.assert_array_equal(
        trob._trim_keep(T(np.asarray(jcat)), tvals, trim).numpy(),
        np.asarray(jrob._trim_keep(jcat, jvals, trim)))
    got = trob.trimmed_weights_sparse(tp, tw, tvals, trim)
    _close(got, jrob.trimmed_weights_sparse(jp, jw, jvals, trim))
    np.testing.assert_array_equal(got.numpy()[:, 1:][idx < 0], 0.0)
    _close(trob.trimmed_mix_sparse(tp, tw, T(idx), T(flat), T(recv), trim),
           jrob.trimmed_mix_sparse(jp, jw, jnp.asarray(idx),
                                   jnp.asarray(flat), jnp.asarray(recv),
                                   trim))
    if trim == 0.0:
        sw, nw = tgraph.sparse_mixing_weights(T(idx), T(p),
                                              active=_act(active, "torch"))
        np.testing.assert_array_equal(
            got.numpy()[:, 0],
            np.broadcast_to(sw.numpy()[:, None], got[:, 0].shape))
        np.testing.assert_array_equal(
            got.numpy()[:, 1:],
            np.broadcast_to(nw.numpy()[:, :, None], got[:, 1:].shape))


@pytest.mark.parametrize("n", [7, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_ties_rank_by_slot(seed, n):
    """Equal member values rank by slot (a stable sort): with every value
    equal, the lowest q slots drop from the bottom and the highest q from
    the top, exactly as `repro` drops them. At 33 members the CPU's
    unstable sort already reorders ties."""
    P = 3
    w = np.random.default_rng(seed).random((n, n)).astype(np.float32) + 0.1
    vals = np.zeros((n, n, P), np.float32)
    keep = trob._trim_keep(T(w), T(vals), 0.3).numpy()
    np.testing.assert_array_equal(
        keep, np.asarray(jrob._trim_keep(jnp.asarray(w), jnp.asarray(vals),
                                         0.3)))
    q = int(np.floor(np.float32(0.3) * np.float32(n)))
    want = np.zeros(n, bool)
    want[q:n - q] = True
    np.testing.assert_array_equal(keep, np.broadcast_to(
        want[None, :, None], keep.shape))


def test_trim_count_is_float32_arithmetic():
    """q = floor(float32(trim_frac) * m): at trim_frac 0.3 - 1e-12 and m
    10, float32(trim_frac) rounds up to 0.3 and the product is 3.0, while
    the float64 product 2.99999999999 floors to 2."""
    frac, n = 0.3 - 1e-12, 10
    assert np.floor(frac * n) == 2.0
    w = np.ones((1, n), np.float32)
    vals = np.arange(n, dtype=np.float32)[None, :, None]
    keep = trob._trim_keep(T(w), T(vals), frac).numpy()[0, :, 0]
    np.testing.assert_array_equal(keep, np.asarray(jrob._trim_keep(
        jnp.asarray(w), jnp.asarray(vals), frac))[0, :, 0])
    assert keep.sum() == n - 2 * 3


def test_trimmed_mix_drops_a_poisoned_peer():
    """tests/test_robust_mixing.py's anchor: one peer uploads 1e6; every
    benign row's trimmed mean excludes it, the weighted mean does not."""
    n = 5
    flat = np.zeros((n, 3), np.float32)
    recv = np.zeros((n, 3), np.float32)
    recv[0] = 1e6
    w = tgraph.eq4_weights_unnormalized(torch.ones((n, n), dtype=torch.bool),
                                        torch.full((n,), 1.0 / n))
    mixed = trob.trimmed_mix_dense(w, T(flat), T(recv), 0.25).numpy()
    assert np.all(np.abs(mixed[1:]) < 1e-3)
    assert trob.MIX_RULES == jrob.MIX_RULES
