"""The port's MoE block (`repro_torch.models.moe`) against `repro.models.moe`
on the CPU, within TOL = 1e-5 (fp32 sums in other orders than XLA's):

* `router_probs`, `top_k` (ties to the lower index, as ``lax.top_k``)
  and `load_balance_loss`, values and gradients;
* `_moe_capacity` at capacity factors 1.25 (which drops copies) and 8.0
  (which drops none) and `_moe_ragged`, at tests/test_models.py's shapes
  (T 64, d 16, f 32, E 8, k 2, some rows routed twice to one expert),
  outputs and the gradients of x, the three expert weights and the
  gates (``jax.vjp``);
* the two-shard identity through ``first_expert`` (the mesh branch's
  psum), and the same bits on a repeat;
* `moe_apply` (both impls) with the router, its aux loss and every
  gradient; `init_moe` within `prng.normal`'s ulps, the router float32.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5
T, D, F, E, K = 64, 16, 32, 8, 2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def inputs():
    """tests/test_models.py's inputs: x (T, d), expert weights scaled by
    0.1, random expert ids (some rows name one expert twice) and softmax
    gates, all from PRNGKey(0)."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (T, D))
    wg = jax.random.normal(key, (E, D, F)) * 0.1
    wu = jax.random.normal(jax.random.fold_in(key, 1), (E, D, F)) * 0.1
    wd = jax.random.normal(jax.random.fold_in(key, 2), (E, F, D)) * 0.1
    idx = jax.random.randint(jax.random.fold_in(key, 3), (T, K), 0, E)
    g = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 4), (T, K)))
    idx_np = np.asarray(idx)
    assert (idx_np[:, 0] == idx_np[:, 1]).any()   # duplicate experts
    return dict(x=x, wg=wg, wu=wu, wd=wd, idx=idx, g=g)


def _dispatch_pair(name, factor):
    """(repro's function, the port's) of dispatch ``name`` at ``factor``."""
    if name == "ragged":
        return jmoe._moe_ragged, tmoe._moe_ragged
    return (lambda *a: jmoe._moe_capacity(*a, capacity_factor=factor),
            lambda *a: tmoe._moe_capacity(*a, capacity_factor=factor))


def _counts(idx):
    return np.bincount(np.asarray(idx).reshape(-1), minlength=E)


@pytest.mark.parametrize("name,factor", [("capacity", 1.25),
                                         ("capacity", 8.0),
                                         ("ragged", None)])
def test_dispatch_and_gradients_match_repro(inputs, name, factor):
    jfn, tfn = _dispatch_pair(name, factor)
    cap = tmoe.capacity(T, K, E, factor or 1.25)
    dropped = int(np.maximum(_counts(inputs["idx"]) - cap, 0).sum())
    if factor == 1.25:
        assert dropped > 0      # the capacity drops copies here
        assert int(tmoe.dropped_copies(_t(inputs["idx"], torch.long), E)) \
            == dropped
    elif factor == 8.0:
        assert dropped == 0

    def jf(x, wg, wu, wd, g):
        return jfn(x, wg, wu, wd, inputs["idx"], g, 0, E)
    args = [inputs[n] for n in ("x", "wg", "wu", "wd", "g")]
    want, vjp = jax.vjp(jf, *args)
    cot = jax.random.normal(jax.random.PRNGKey(9), want.shape)
    jgrads = vjp(cot)
    targs = [_t(a).requires_grad_() for a in args]
    got = tfn(*targs[:4], _t(inputs["idx"], torch.long), targs[4], 0, E)
    _close(got.detach(), want)
    tgrads = torch.autograd.grad(got, targs, _t(cot))
    for n, a, b in zip(("x", "we_gate", "we_up", "we_down", "gates"),
                       tgrads, jgrads):
        _close(a, b, msg=n)


def test_capacity_and_ragged_agree_without_drops(inputs):
    """tests/test_models.py's identity on the port: no copy dropped at
    capacity factor 8, so the two dispatches agree."""
    args = [_t(inputs[n]) for n in ("x", "wg", "wu", "wd")]
    idx, g = _t(inputs["idx"], torch.long), _t(inputs["g"])
    _close(tmoe._moe_ragged(*args, idx, g, 0, E),
           tmoe._moe_capacity(*args, idx, g, 0, E, capacity_factor=8.0))


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_two_expert_shards_sum_to_the_whole(inputs, factor):
    """Experts [0, 4) and [4, 8) through ``first_expert``, each counting
    its capacity from the 8 global experts, sum to `repro`'s two shards
    (and, with no drop, to the unsharded dispatch)."""
    x, wg, wu, wd = (_t(inputs[n]) for n in ("x", "wg", "wu", "wd"))
    idx, g = _t(inputs["idx"], torch.long), _t(inputs["g"])
    parts, jparts = [], []
    for first in (0, 4):
        sl = slice(first, first + 4)
        parts.append(tmoe._moe_capacity(x, wg[sl], wu[sl], wd[sl], idx, g,
                                        first, E, capacity_factor=factor))
        jparts.append(jmoe._moe_capacity(
            inputs["x"], inputs["wg"][sl], inputs["wu"][sl],
            inputs["wd"][sl], inputs["idx"], inputs["g"], first, E,
            capacity_factor=factor))
        _close(parts[-1], jparts[-1])
    whole = tmoe._moe_capacity(x, wg, wu, wd, idx, g, 0, E,
                               capacity_factor=factor)
    if factor == 8.0:
        _close(parts[0] + parts[1], whole)
    _close(parts[0] + parts[1], np.asarray(jparts[0] + jparts[1]))


@pytest.mark.parametrize("name", ["capacity", "ragged"])
def test_dispatch_gives_the_same_bits_on_a_repeat(inputs, name):
    fn = tmoe.MOE_IMPLS[name]
    args = [_t(inputs[n]) for n in ("x", "wg", "wu", "wd")]
    idx, g = _t(inputs["idx"], torch.long), _t(inputs["g"])
    a, b = fn(*args, idx, g, 0, E), fn(*args, idx, g, 0, E)
    assert torch.equal(a, b)


def test_router_probs_and_load_balance_loss_match_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / 4).astype(np.float32)

    def jf(x, w):
        probs = jmoe.router_probs(x, w)
        _, idx = jax.lax.top_k(probs, K)
        return probs, jmoe.load_balance_loss(probs, idx, E)
    (jprobs, jaux), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    cot = rng.standard_normal(jprobs.shape).astype(np.float32)
    jgx, jgw = vjp((jnp.asarray(cot), jnp.float32(1.5)))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    probs = tmoe.router_probs(tx, tw)
    _, idx = tmoe.top_k(probs, K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        jax.lax.top_k(jprobs, K)[1]))
    aux = tmoe.load_balance_loss(probs, idx, E)
    _close(probs.detach(), jprobs)
    _close(aux.detach(), jaux)
    gx, gw = torch.autograd.grad((probs, aux), (tx, tw),
                                 (_t(cot), torch.tensor(1.5)))
    _close(gx, jgx, msg="x")
    _close(gw, jgw, msg="router")


def test_top_k_breaks_ties_toward_the_lower_index():
    """``lax.top_k``'s order among equal values, which ``torch.topk``
    does not promise: rows of repeated values."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                     [0.5, 0.0, 0.5, 0.0], [0.0, 0.0, 0.0, 1.0]],
                    np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tmoe.top_k(_t(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_apply_and_its_gradients_match_repro(impl):
    """`moe_apply` on (B 4, S 16, d 16) with `init_moe`'s weights of
    PRNGKey(5) carried across: the output, the aux loss and every
    gradient, through the router's top-k and renormalised gates."""
    cfg = types.SimpleNamespace(d_model=D, n_experts=E, d_expert_ff=F,
                                topk=K)
    jp = jmoe.init_moe(jax.random.PRNGKey(5), cfg, jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, D)).astype(np.float32)

    def jf(p, x):
        return jmoe.moe_apply(p, x, cfg, impl=impl)
    (jout, jaux), vjp = jax.vjp(jf, jp, jnp.asarray(x))
    cot = rng.standard_normal(jout.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(cot), jnp.float32(0.7)))
    probs = np.asarray(jmoe.router_probs(jnp.asarray(x.reshape(-1, D)),
                                         jp["router"]))
    gap = float(tmoe.router_gap(_t(probs), K))
    assert gap > 1e-6, f"a near-tie ({gap}) in the router: not the port's"
    p = types.SimpleNamespace(**{n: _t(a).requires_grad_()
                                 for n, a in jp.items()})
    tx = _t(x).requires_grad_()
    out, aux = tmoe.moe_apply(p, tx, cfg, impl=impl)
    _close(out.detach(), jout)
    _close(aux.detach(), jaux)
    names = ["router", "we_gate", "we_up", "we_down"]
    grads = torch.autograd.grad((out, aux), [getattr(p, n) for n in names]
                                + [tx], (_t(cot), torch.tensor(0.7)))
    for n, g in zip(names + ["x"], grads):
        _close(g, jgx if n == "x" else jgp[n], msg=n)


def test_moe_apply_under_a_grad_refuses_a_mesh():
    """The expert-parallel path trains (its gradient on the model meshes:
    tests/test_torch_dryrun.py), on a ("data", "model") mesh only: under
    grad mode as without it, another mesh is refused."""
    from repro_torch.sharding.collectives import ShapeMesh

    cfg = types.SimpleNamespace(d_model=D, n_experts=E, d_expert_ff=F,
                                topk=K)
    p = types.SimpleNamespace(router=torch.zeros((D, E)))
    with torch.enable_grad(), pytest.raises(ValueError,
                                            match="a model is built on"):
        tmoe.moe_apply(p, torch.zeros((1, 2, D)), cfg,
                       mesh=ShapeMesh((1, 2), ("pod", "data")))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_init_moe_matches_repro_within_ulps(arch):
    """`init_moe` draws `repro`'s key tree (split(key, 4)); the router is
    float32 whatever the dtype, and the expert weights are scaled by
    1/sqrt(E) (fan_in = shape[0]), as in `repro`."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    key = jax.random.PRNGKey(3)
    want = jmoe.init_moe(key, jcfg, jnp.bfloat16)
    got = tmoe.init_moe(common.key_to_torch(key), tcfg, torch.bfloat16)
    assert got["router"].dtype == torch.float32
    assert got["we_gate"].dtype == torch.bfloat16
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].float().numpy()
        assert g.shape == w.shape, name
        tol = 1e-5 * np.abs(w).max() if name == "router" \
            else 2 ** -7 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    E_ = tcfg.n_experts
    std = float(got["we_gate"].float().std())
    assert abs(std * np.sqrt(E_) - 1.0) < 0.1


def test_router_gap_and_dropped_copies():
    probs = _t([[0.5, 0.3, 0.2], [0.4, 0.35, 0.25]])
    assert float(tmoe.router_gap(probs, 1)) == pytest.approx(0.05)
    assert float(tmoe.router_gap(probs, 2)) == pytest.approx(0.1)
    assert float(tmoe.router_gap(probs, 3)) == float("inf")
    idx = torch.zeros((40, 2), dtype=torch.long)   # every copy expert 0
    cap = tmoe.capacity(40, 2, 4)
    assert cap == 25
    assert int(tmoe.dropped_copies(idx, 4)) == 80 - cap
