"""`repro_torch.prng` is bitwise equal to ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``) over seeds, shapes, batches of keys
and permutation sizes, including n >= 2000 where ``_shuffle`` takes two
sort rounds."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (1, 2, 4, 7):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    for data in (0, 1, 1000, 1003, 2 ** 31 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_keys_match_per_key(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed), 5)
    tk = common.key_to_torch(jk)
    data = torch.arange(5) * 3 + 1
    want = np.stack([_np(jax.random.fold_in(jk[i], int(data[i])))
                     for i in range(5)])
    np.testing.assert_array_equal(want, prng.fold_in(tk, data).numpy())
    want = np.stack([_np(jax.random.split(jk[i], 3)) for i in range(5)])
    np.testing.assert_array_equal(want, prng.split(tk, 3).numpy())
    want = np.stack([np.asarray(jax.random.uniform(jk[i], (4,)))
                     for i in range(5)])
    np.testing.assert_array_equal(want, prng.uniform(tk, (4,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (2, 3, 5)])
def test_bits_and_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, shape)),
                                  prng.random_bits(tk, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(tk, shape).numpy())
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=1.0)),
        prng.uniform(tk, shape, lo, 1.0).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 6, 32, 128, 1625, 1626, 2000, 4099])
def test_permutation(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(jk, n)),
                                  prng.permutation(tk, n).numpy())


def test_permutation_rounds_follow_jax_criterion():
    assert prng._shuffle_rounds(1625) == 1
    assert prng._shuffle_rounds(2000) == 2


def test_batched_permutation():
    jk = jax.random.split(jax.random.PRNGKey(9), 6).reshape(2, 3, 2)
    tk = common.key_to_torch(jk)
    got = prng.permutation(tk, 40).numpy()
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                np.asarray(jax.random.permutation(jk[i, j], 40)), got[i, j])


def test_normal_within_ulps():
    """normal goes through erfinv, whose torch and XLA polynomials differ:
    the values agree to float32 noise, not bitwise."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    np.testing.assert_allclose(np.asarray(jax.random.normal(jk, (4096,))),
                               prng.normal(tk, (4096,)).numpy(),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [(), (2, 8), (4, 512)])
@pytest.mark.parametrize("minval,maxval", [
    (0, 151_936), (0, 50_280), (0, 256_000),   # qwen3, mamba2, gemma vocabs
    (0, 10), (-5, 7), (0, 1 << 16), (0, (1 << 16) + 1), (3, 3), (10, 2),
    (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_is_bitwise_jax(seed, shape, minval, maxval):
    """jax 0.9's ``_randint``: two draws from a split key, combined modulo
    the span with every uint32 product and sum wrapping (above a span of
    2**16 the multiplier wraps to 0)."""
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, minval, maxval)
    got = prng.randint(prng.PRNGKey(seed), shape, minval, maxval)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(want), got.numpy())


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 32)


@pytest.mark.parametrize("block", [1, 7, 64])
def test_blocked_draw_is_the_same_bits(monkeypatch, block):
    """A draw longer than `prng.BLOCK` counters is hashed block by block
    over the flat counter range; an element's counter is its flat index,
    so the bits, uniforms and normals are those of one whole draw (and
    jax's), for one key and for a batch of keys."""
    jk = jax.random.PRNGKey(4)
    tk = prng.PRNGKey(4)
    whole = (prng.random_bits(tk, (9, 33)), prng.uniform(tk, (9, 33)),
             prng.normal(tk, (9, 33)))
    keys = common.key_to_torch(jax.random.split(jk, 3))
    batched = prng.uniform(keys, (5, 13))
    monkeypatch.setattr(prng, "BLOCK", block)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, (9, 33))),
                                  prng.random_bits(tk, (9, 33)).numpy())
    for got, want in zip((prng.random_bits(tk, (9, 33)),
                          prng.uniform(tk, (9, 33)),
                          prng.normal(tk, (9, 33))), whole):
        assert torch.equal(got, want)
    assert torch.equal(prng.uniform(keys, (5, 13)), batched)
    assert torch.equal(prng.uniform(keys, ()), prng.uniform(keys))
