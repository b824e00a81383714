"""`repro_torch.prng` is bitwise equal to ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``) over seeds, shapes, batches of keys
and permutation sizes, including n >= 2000 where ``_shuffle`` takes two
sort rounds; ``normal`` and ``erf_inv`` too, at the edges of XLA's
branches, and so the models' inits."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
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
    """normal is jax.random.normal bit for bit (zero ulps): XLA:CPU's
    erf_inv on XLA's own log1p and log, every fused multiply-add rounded
    once, on 2**20 draws."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    want = np.asarray(jax.random.normal(jk, (1 << 20,)))
    got = prng.normal(tk, (1 << 20,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 4)])
def test_normal_is_bitwise_jax_over_seeds_and_shapes(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _walk(x, toward, n):
    """n float32 values from ``x`` one ulp at a time toward ``toward``."""
    out = []
    x, toward = np.float32(x), np.float32(toward)
    for _ in range(n):
        x = np.nextafter(x, toward)
        out.append(x)
    return out


def test_erf_inv_is_bitwise_jax_at_its_edges():
    """``prng.erf_inv`` against ``jax.lax.erf_inv`` where its branches
    meet: u next to +-1 (w far past 5, +-1 itself -> +-inf), x^2 at
    sqrt(2)/2 (where XLA's log splits its mantissa) and at sqrt(2) - 1
    (where its log1p leaves the rational form), w at 5 (Giles' two
    polynomials), tiny and zero u; both signs, and 2**20 uniform u."""
    f32 = np.float32
    edges = _walk(1, 0, 20000) + [f32(0), f32(1), f32(1e-20), f32(0.5)]
    for centre in (np.sqrt(np.sqrt(0.5)), np.sqrt(np.sqrt(2) - 1),
                   np.sqrt(1 - np.exp(-5.0))):
        edges += _walk(centre, 0, 2000) + _walk(centre, 1, 2000)
    x = np.array(edges, np.float32)
    rng = np.random.default_rng(0)
    x = np.concatenate([x, -x, rng.uniform(-1, 1, 1 << 20).astype(
        np.float32)])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isposinf(got[x == 1]).all() and np.isneginf(got[x == -1]).all()


def test_sqrt_and_fma_round_once():
    """The two helpers under erf_inv: a correctly rounded float32 sqrt
    (numpy's) and a fused multiply-add rounded once (float64 sums that
    round to float32 twice would miss on halfway cases, built here)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 100, 1 << 18).astype(np.float32)
    np.testing.assert_array_equal(prng._sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    # a*b = 1 + 2**-11 + 2**-24 (exact in float64) lies halfway between
    # two float32 values; c = +-2**-60 is lost in the float64 sum but
    # decides the float32 rounding, and without it the tie goes to even
    a = np.float32(1 + 2.0 ** -12)
    c_up, c_dn = np.float32(2.0 ** -60), np.float32(-(2.0 ** -60))
    ta = torch.tensor([a, a, a])
    tc = torch.tensor([c_up, np.float32(0), c_dn])
    got = prng._fma(ta, ta, tc).numpy()
    one = np.float32(1 + 2.0 ** -11)
    assert got[0] == np.nextafter(one, np.float32(2))
    assert got[1] == one          # the tie goes to even
    assert got[2] == one
    assert (np.float64(a) * np.float64(a) + np.float64(c_up)).astype(
        np.float32) == one        # the double rounding this avoids


@pytest.mark.parametrize("kind", ["mlp", "paper_cnn"])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_clients_is_bitwise_repro(kind, seed):
    """The port draws its own init: `init_clients(prng.PRNGKey(s))` is
    `repro`'s bit for bit, for the small MLP and PaperCNN at its
    published width (62,006 parameters)."""
    from repro.configs.paper_cnn import CNNConfig as JCNNConfig
    from repro.models.classifier import MLP as JMLP
    from repro.models.classifier import PaperCNN as JCNN

    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.models.classifier import MLP, PaperCNN

    if kind == "mlp":
        jm, tm = JMLP(*common.SMALL_MLP), MLP(*common.SMALL_MLP)
    else:
        jm, tm = JCNN(JCNNConfig()), PaperCNN(CNNConfig())
    want = jm.init(jax.random.PRNGKey(seed))
    got = tm.init(prng.PRNGKey(seed))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


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
