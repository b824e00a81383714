"""The LM's ``model`` mesh axis on the CPU: expert-parallel MoE,
flash-decoding over a sequence-sharded cache, and the sharding rules,
against `repro`'s own ``shard_map`` runs and the port's single-device
runs.

`repro`'s runs are real: a subprocess forces 4 host devices
(``--xla_force_host_platform_device_count=4``), applies
tests/test_torch_common.py's jax 0.9 patch before `repro` is imported,
and runs `repro.models.moe.moe_apply` and `DecoderLM.decode_step` on
``make_mesh(shape, ("data", "model"))`` meshes (1, 2), (2, 2) and
(1, 4); it writes their outputs to an ``.npz`` under the test's
temporary directory, once a test run. The port's ranks are gloo
processes (`repro_torch.launch.mesh.run_on_mesh`), one launch per mesh
running everything that mesh is held to
(`torch_mesh_workers.model_mesh_runs`).

* `moe_apply` on reduced qwen3-moe-30b-a3b (4 experts, top 2, d 256) at
  (B 4, S 16), the tokens biased toward some experts so the capacity
  drops copies in each data block: both impls within 1e-5 of `repro`'s
  mesh run, the aux loss within 1e-6, the kept copies of each (data
  block, expert shard) equal to those `repro`'s ``_moe_capacity`` keeps
  (read through probe weights), and within 1e-5 of the port's
  single-device run on each data block alone (the capacity is the
  block's).
* The seqshard decode of reduced qwen3-0.6b (a ring of 16 over 24
  steps) and reduced h2o-danube-1.8b (window 32, 40 steps) from empty
  rings: the ring wraps. Logits within 1e-5 of `repro`'s seqshard run
  and of its plain decode, greedy tokens equal, the gathered caches
  `repro`'s (pos exactly, k and v within 1e-5). A prefill of 8 tokens,
  then 12 steps, within 1e-5 of the port's single-device run.
* The port's ``param_specs`` / ``cache_specs`` / ``batch_specs`` /
  ``add_client_axis`` equal `repro`'s for every arch (the stacked layer
  axis dropped), and divide the production sizes (data 16, model 16,
  pod 2) as tests/test_sharding.py asserts.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import lm_params_from_jax  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import hybrid_layout  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
AXES = ("data", "model")
MOE_ARCH = "qwen3-moe-30b-a3b"
# the down projection scaled by 2^-10 (exactly): `repro`'s init scales
# the experts by 1/sqrt(E) = 0.5, so unit inputs of width 256 give
# outputs in the hundreds, where fp32's spacing is 6e-5; scaled, they are
# of order 1 and the 1e-5 tolerance means what it says
MOE_X = dict(batch=4, seq=16, seed=0, bias=1.5, down_scale=2.0 ** -10)
IMPLS = ("capacity", "ragged")
# name -> (arch, cache_len, tokens in all, prompt length): `repro` runs
# the decodes from empty rings, as its tests/test_seqshard.py does; the
# prefill case (the ring built whole, then cut) is held against the
# port's single-device run
DECODES = {"qwen3": ("qwen3-0.6b", 16, 24, 0),
           "h2o-danube": ("h2o-danube-1.8b", 40, 40, 0),
           "qwen3-prefill": ("qwen3-0.6b", 16, 20, 8)}
REPRO_DECODES = {k: v for k, v in DECODES.items() if not v[3]}
DECODE_BATCH = 4
PRODUCTION = {"data": 16, "model": 16, "pod": 2}

REF_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
tests, out_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tests)
sys.path.insert(0, os.path.join(os.path.dirname(tests), "src"))
import test_torch_common  # the jax 0.9 patch, before repro
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import build_model
from repro.models.moe import init_moe, moe_apply, router_probs, _moe_capacity
from repro.sharding.compat import make_mesh

MESHES = %(meshes)r
MOE_ARCH, MOE_X, IMPLS = %(moe_arch)r, %(moe_x)r, %(impls)r
DECODES, B = %(decodes)r, %(batch)r
out = {}

def mesh_of(shape):
    n = shape[0] * shape[1]
    return make_mesh(shape, ("data", "model"), devices=jax.devices()[:n])

def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            out[f"{prefix}{k}"] = np.asarray(v)

# --- moe_apply
cfg = get_config(MOE_ARCH).reduced()
p = init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
p["we_down"] = p["we_down"] * MOE_X["down_scale"]
flat(p, "moe/params/")
rng = np.random.default_rng(MOE_X["seed"])
x = rng.standard_normal((MOE_X["batch"], MOE_X["seq"], cfg.d_model))
x = (x + MOE_X["bias"] * rng.standard_normal(cfg.d_model)).astype(np.float32)
out["moe/x"] = x
probs = router_probs(jnp.asarray(x).reshape(-1, cfg.d_model), p["router"])
idx = np.asarray(jax.lax.top_k(probs, cfg.topk)[1])
E, k, d, f = cfg.n_experts, cfg.topk, cfg.d_model, cfg.d_expert_ff
for impl in IMPLS:
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg, impl=impl))(
        p, jnp.asarray(x))
    out[f"moe/single/{impl}/y"], out[f"moe/single/{impl}/aux"] = y, aux
    for name, shape in MESHES.items():
        y, aux = jax.jit(lambda p, x: moe_apply(
            p, x, cfg, mesh=mesh_of(shape), impl=impl))(p, jnp.asarray(x))
        out[f"moe/{name}/{impl}/y"] = y
        out[f"moe/{name}/{impl}/aux"] = aux
# the copies repro's _moe_capacity keeps in each (data block, expert
# shard), read through probe weights: ones in, each local expert's
# output on its own column, so column e of token t is nonzero iff the
# copy of t to that expert was kept
probe = jax.jit(_moe_capacity, static_argnums=(6, 7))
for name, (D, M) in MESHES.items():
    T, El = MOE_X["batch"] * MOE_X["seq"] // D, E // M
    wg = jnp.full((El, d, f), 1.0 / d)
    wd = jnp.zeros((El, f, d)).at[jnp.arange(El), :, jnp.arange(El)].set(1.0)
    kept = []
    for b in range(D):
        ib = idx[b * T:(b + 1) * T]
        for i in range(M):
            o = np.asarray(probe(
                jnp.ones((T, d)), wg, wg, wd, jnp.asarray(ib),
                jnp.ones(ib.shape), i * El, E))
            le = ib - i * El
            local = (le >= 0) & (le < El)
            kept.append(local & (np.take_along_axis(
                o, np.clip(le, 0, El - 1), axis=1) > 0))
    out[f"moe/{name}/kept"] = np.stack(kept)

# --- seqshard decodes
for case, (arch, cache_len, T, P) in DECODES.items():
    cfg = get_config(arch).reduced()
    m_ref = build_model(cfg)
    params = jax.jit(m_ref.init)(jax.random.PRNGKey(0))
    if not any(key.startswith(f"decode/{arch}/") for key in out):
        flat(params, f"decode/{arch}/params/")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, T), 0,
                                         cfg.vocab_size))

    def run(model, step):
        logits, c = [], model.init_cache(B, cache_len)
        for t in range(T):
            lg, c = step(params, c, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
            logits.append(lg)
        return np.stack([np.asarray(l) for l in logits], 1), c
    lg, _ = run(m_ref, jax.jit(m_ref.decode_step))
    out[f"decode/{case}/plain"] = lg
    for name, shape in MESHES.items():
        m_ss = build_model(cfg, mesh=mesh_of(shape),
                           decode_cache_seqshard=True)
        lg, c = run(m_ss, jax.jit(m_ss.decode_step))
        out[f"decode/{case}/{name}/logits"] = lg
        for leaf in ("k", "v", "pos"):
            out[f"decode/{case}/{name}/{leaf}"] = np.asarray(c[leaf])
np.savez(out_path, **out)
print("OK")
"""


def _nest(flat, prefix):
    """{"a/b": x} under ``prefix`` -> {"a": {"b": x}}."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, last = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """`repro`'s runs on forced host devices, read back from the .npz."""
    path = tmp_path_factory.mktemp("repro_model_mesh") / "ref.npz"
    code = REF_CODE % dict(
        meshes=MESHES, moe_arch=MOE_ARCH, moe_x=MOE_X, impls=IMPLS,
        decodes=REPRO_DECODES, batch=DECODE_BATCH)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, str(common.ROOT /
                                                         "tests"), str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return dict(z)


def _moe_case(ref, impl):
    p = _nest(ref, "moe/params/")
    cfg = get_config(MOE_ARCH).reduced()
    return dict(p, x=ref["moe/x"], impl=impl, cfg=dict(
        n_experts=cfg.n_experts, topk=cfg.topk, d_model=cfg.d_model,
        d_expert_ff=cfg.d_expert_ff))


def _tokens(case):
    """A case's (B, T) tokens: `repro`'s draw, randint(PRNGKey(2))."""
    arch, _, T, _ = DECODES[case]
    return prng.randint(prng.PRNGKey(2), (DECODE_BATCH, T), 0,
                        get_config(arch).reduced().vocab_size).numpy()


def _decode_cases(ref):
    return [(arch, _nest(ref, f"decode/{arch}/params/"), _tokens(case),
             cache_len, P)
            for case, (arch, cache_len, _, P) in DECODES.items()]


def _repro_moe_lm():
    """`repro`'s init of the whole reduced moe LM, as numpy leaves."""
    import jax

    from repro.configs import REGISTRY
    from repro.models import build_model as jbuild

    params = jax.jit(jbuild(REGISTRY[MOE_ARCH].reduced()).init)(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


class _Runs:
    def __init__(self, tmp, ref):
        self.tmp, self.ref, self.meshes = tmp, ref, {}

    def mesh(self, name):
        if name not in self.meshes:
            store = self.tmp.mktemp(f"store-{name}") / "store"
            self.meshes[name] = run_on_mesh(
                workers.model_mesh_runs, MESHES[name], AXES, device="cpu",
                init_file=str(store), timeout=600, args=(
                    [_moe_case(self.ref, impl) for impl in IMPLS],
                    _decode_cases(self.ref),
                    ("qwen3-0.6b", _nest(self.ref,
                                         "decode/qwen3-0.6b/params/")),
                    (MOE_ARCH, _repro_moe_lm())))
        return self.meshes[name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ref):
    return _Runs(tmp_path_factory, ref)


# ------------------------------------------------------------- moe_apply


def _single_moe(ref, impl, rows=slice(None)):
    """The port's single-device `moe_apply` on ``rows`` of the batch."""
    c = _moe_case(ref, impl)
    p = type("P", (), {k: torch.from_numpy(c[k]) for k in (
        "router", "we_gate", "we_up", "we_down")})
    cfg = get_config(MOE_ARCH).reduced()
    x = torch.from_numpy(c["x"])[rows]
    with torch.no_grad():
        y, aux = tmoe.moe_apply(p, x, cfg, impl=impl)
    idx = tmoe.top_k(tmoe.router_probs(x.reshape(-1, cfg.d_model),
                                       p.router), cfg.topk)[1]
    return y.numpy(), float(aux), idx


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_apply_on_a_mesh_matches_repro(runs, ref, mesh, impl):
    got = runs.mesh(mesh)["moe"][IMPLS.index(impl)]
    np.testing.assert_allclose(got["y"], ref[f"moe/{mesh}/{impl}/y"],
                               rtol=0, atol=1e-5)
    # every rank's aux loss is the whole batch's
    np.testing.assert_allclose(got["aux"], np.full(
        got["aux"].shape, ref[f"moe/{mesh}/{impl}/aux"]), rtol=0,
        atol=1e-6)
    D, M = MESHES[mesh]
    E_l = get_config(MOE_ARCH).reduced().n_experts // M
    kept = ref[f"moe/{mesh}/kept"]     # (D * M, T_l, k), rank order
    if impl == "capacity":
        np.testing.assert_array_equal(got["kept"], kept)
        # a rank drops the copies to its experts that repro does not keep
        np.testing.assert_array_equal(got["dropped"], [
            ((idx >= i * E_l) & (idx < (i + 1) * E_l)).sum() - kb.sum()
            for (idx, i), kb in zip(_blocks(ref, D, M), kept)])
    # the ranks combine with one psum over model a call, and sum the
    # aux statistics over data when the data axis is above 1
    calls = got["counts"]["psum"][0]
    assert calls == (M > 1) + (D > 1)


def _blocks(ref, D, M):
    """(top-k indices of data block b, expert shard i) in rank order."""
    _, _, idx = _single_moe(ref, "capacity")
    T = idx.shape[0] // D
    return [(idx[b * T:(b + 1) * T].numpy(), i)
            for b in range(D) for i in range(M)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_apply_on_a_mesh_matches_single_device_blocks(runs, ref, mesh,
                                                           impl):
    """Each data block's rows within 1e-5 of the port's single-device run
    on that block alone (the capacity is the block's); the kept copies
    of a block, over its expert shards, are the single-device block
    run's; the aux loss within 1e-6 of the whole batch's."""
    got = runs.mesh(mesh)["moe"][IMPLS.index(impl)]
    D, M = MESHES[mesh]
    B = MOE_X["batch"]
    E = get_config(MOE_ARCH).reduced().n_experts
    for b in range(D):
        rows = slice(b * B // D, (b + 1) * B // D)
        y, _, idx = _single_moe(ref, impl, rows)
        np.testing.assert_allclose(got["y"][rows], y, rtol=0, atol=1e-5)
        if impl == "capacity":
            kept = got["kept"][b * M:(b + 1) * M].any(axis=0)
            np.testing.assert_array_equal(
                kept, workers.kept_copies(idx, E).numpy())
            assert got["dropped"][b * M:(b + 1) * M].sum() == int(
                tmoe.dropped_copies(idx, E))
    _, aux, _ = _single_moe(ref, impl)
    np.testing.assert_allclose(got["aux"], aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_rank_holds_its_experts_carried_or_drawn(runs, mesh):
    """`lm_params_from_jax(mesh=)` cuts `repro`'s whole experts to the
    rank's E / M rows, and `DecoderLM.init` on the mesh draws those very
    rows of the whole init; every other leaf whole."""
    got = runs.mesh(mesh)["experts"]
    cfg = get_config(MOE_ARCH).reduced()
    assert got["carried"] and got["drawn"]
    assert got["shape"] == (cfg.n_experts // MESHES[mesh][1], cfg.d_model,
                            cfg.d_expert_ff)


def test_the_capacity_drops_copies_in_every_data_block(runs):
    """The case is one where the capacity binds: each data block of the
    2x2 mesh drops copies (on one expert shard or both), so its output
    depends on its block."""
    got = runs.mesh("2x2")["moe"][IMPLS.index("capacity")]
    assert (got["dropped"].reshape(2, 2).sum(axis=1) > 0).all(), \
        got["dropped"]


# -------------------------------------------------------- seqshard decode


def _plain_port_decode(ref, case):
    """The port's single-device decode of a case (no mesh)."""
    arch, cache_len, T, P = DECODES[case]
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="meta")
    model.load_state_dict(lm_params_from_jax(
        _nest(ref, f"decode/{arch}/params/"), cfg, "cpu"), assign=True)
    toks = torch.from_numpy(_tokens(case)).long()
    logits = []
    with torch.inference_mode():
        if P:
            lg, caches = model.prefill(toks[:, :P], cache_len=cache_len)
            logits.append(lg)
        else:
            caches = model.init_cache(toks.shape[0], cache_len)
        for t in range(P, T):
            lg, caches = model.decode_step(caches, toks[:, t:t + 1], t)
            logits.append(lg)
    return torch.stack(logits, 1).numpy()


@pytest.mark.parametrize("case", list(REPRO_DECODES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_seqshard_decode_matches_repro(runs, ref, mesh, case):
    got = runs.mesh(mesh)["decode"][list(DECODES).index(case)]
    want = ref[f"decode/{case}/{mesh}/logits"]
    np.testing.assert_allclose(got["logits"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["logits"], ref[f"decode/{case}/plain"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["logits"].argmax(-1),
                                  want.argmax(-1))
    # k and v within tests/test_torch_lm.py's 1e-5 for caches: keys and
    # values of up to 4.4 are width-256 products that XLA and torch sum
    # in other orders, 1.8e-6 apart in the first layer and 4.3e-6 in the
    # second (a CPU run of this case)
    for layer, c in enumerate(got["caches"]):
        np.testing.assert_array_equal(
            c["pos"], ref[f"decode/{case}/{mesh}/pos"][layer])
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                c[leaf], ref[f"decode/{case}/{mesh}/{leaf}"][layer],
                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(DECODES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_seqshard_decode_matches_the_single_device_port(runs, ref, mesh,
                                                        case):
    """Within 1e-5 of the port's plain decode, each rank holding its
    (B / D, C / M) block of every ring, and a decode step's collectives
    one pmax and two psums a layer over model."""
    got = runs.mesh(mesh)["decode"][list(DECODES).index(case)]
    np.testing.assert_allclose(got["logits"], _plain_port_decode(ref, case),
                               rtol=0, atol=1e-5)
    arch, cache_len, _, _ = DECODES[case]
    cfg = get_config(arch).reduced()
    C = min(cache_len, cfg.attn_window or cache_len)
    D, M = MESHES[mesh]
    assert got["block"] == (DECODE_BATCH // D, C // M, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
    L = cfg.n_layers
    assert got["counts"]["pmax"][0] == L
    assert got["counts"]["psum"][0] == 2 * L


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_model_mesh_refuses_a_batch_or_ring_that_does_not_split(runs, mesh):
    batch_msg, ring_msg = runs.mesh(mesh)["refusal"]
    D, M = MESHES[mesh]
    if D > 1:
        assert "batch 3 does not split" in batch_msg
    else:
        assert batch_msg is None
    assert "ring of 17 slots does not split" in ring_msg


def _want_reductions(shape, axes_names, axes, x):
    """Every rank's psum and pmax over ``axes``: ``x`` (world, ...) in
    rank order, reduced over the mesh dimensions of ``axes``."""
    grid = x.reshape(tuple(shape) + x.shape[1:])
    dims = tuple(axes_names.index(a) for a in axes)
    return tuple(np.broadcast_to(f(grid, axis=dims, keepdims=True),
                                 grid.shape).reshape(x.shape)
                 for f in (np.sum, np.max))


def _rank_inputs(world):
    return np.stack([torch.randn((3, 5), generator=torch.Generator(
    ).manual_seed(r)).numpy() for r in range(world)])


def _check_reductions(got, shape, names):
    out, calls = got
    x = _rank_inputs(int(np.prod(shape)))
    for axes, (psum, pmax) in out.items():
        want_sum, want_max = _want_reductions(shape, names, axes, x)
        np.testing.assert_allclose(psum, want_sum, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pmax, want_max)
        # every rank of a group holds the same bits
        for r in range(len(x)):
            peers = [q for q in range(len(x)) if all(
                np.unravel_index(q, shape)[i] == np.unravel_index(r, shape)[i]
                for i, a in enumerate(names) if a not in axes)]
            for q in peers:
                assert np.array_equal(psum[q], psum[r])
    # a collective only where the axes are longer than 1
    n = sum(int(np.prod([dict(zip(names, shape))[a] for a in axes])) > 1
            for axes in out)
    assert calls == {"psum": n, "pmax": n}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_psum_and_pmax_over_the_mesh_axes(runs, mesh):
    _check_reductions(runs.mesh(mesh)["reductions"], MESHES[mesh], AXES)


def test_psum_and_pmax_over_two_of_three_axes(tmp_path):
    """A ("pod", "data", "model") mesh: the reductions over two of its
    axes run on subgroups every rank makes once."""
    shape, names = (2, 1, 2), ("pod", "data", "model")
    got = run_on_mesh(workers.reductions, shape, names, device="cpu",
                      init_file=str(tmp_path / "store"), timeout=300)
    _check_reductions(got, shape, names)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", MOE_ARCH])
def test_seqshard_needs_a_model_axis(arch):
    """A model is built on a ("data", "model") mesh alone: the client
    mesh, with no ``model`` axis to shard the rings and experts on, is
    refused."""
    client_mesh = type("Mesh", (), {"mesh_dim_names": ("pod", "data")})()
    with pytest.raises(ValueError, match=r"\('data', 'model'\)"):
        build_model(get_config(arch).reduced(), device="meta",
                    mesh=client_mesh)


# -------------------------------------------------------------- the rules


def _repro_key(name, cfg):
    """(`repro`'s "/"-joined path, whether it is stacked) of a port
    state-dict or cache name: `repro_torch.interop`'s key map."""
    head, _, rest = name.partition(".")
    if head not in ("layers", "enc_layers", "dec_layers"):
        return name.replace(".", "/"), False
    i, leaf = rest.split(".", 1)
    if cfg.family == "hybrid" and head == "layers":
        si, _, bi, _ = hybrid_layout(cfg)[int(i)]
        return f"segments/{si}/b{bi}/{leaf.replace('.', '/')}", True
    return f"{head}/{leaf.replace('.', '/')}", True


def _repro_specs(tree):
    from jax.sharding import PartitionSpec as P
    from jax.tree_util import tree_flatten_with_path

    from repro.sharding.rules import _path_str

    leaves, _ = tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, P))
    return {_path_str(path): tuple(spec) for path, spec in leaves}


def _stand_in(sizes):
    """What `repro`'s mesh_axis_sizes reads of a mesh."""
    return type("Mesh", (), {"axis_names": tuple(sizes),
                             "axis_sizes": tuple(sizes.values())})()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_repro(arch):
    from repro.configs import REGISTRY
    from repro.models import build_model as jbuild
    from repro.sharding.rules import param_specs as jspecs

    jcfg, cfg = REGISTRY[arch], get_config(arch)
    want = _repro_specs(jspecs(jbuild(jcfg, vocab_pad_multiple=2048), jcfg,
                               _stand_in(PRODUCTION)))
    model = build_model(cfg, device="meta", vocab_pad_multiple=2048)
    got = rules.param_specs(model, cfg, PRODUCTION)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == len(shapes)
    for name, spec in got.items():
        path, stacked = _repro_key(name, cfg)
        assert spec == (want[path][1:] if stacked else want[path]), name
        _assert_divides(spec, shapes[name], name)
        _assert_divides(rules.add_client_axis(spec), (2,) + shapes[name],
                        name)


def _assert_divides(spec, shape, what):
    assert len(spec) <= len(shape), (what, spec, shape)
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        n = int(np.prod([PRODUCTION[a] for a in (
            (axes,) if isinstance(axes, str) else axes)]))
        assert dim % n == 0, (what, spec, shape)


@pytest.mark.parametrize("batch, seq", [(128, 32768), (1, 524288)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_repro(arch, batch, seq):
    import jax

    from repro.configs import REGISTRY
    from repro.models import build_model as jbuild
    from repro.sharding.rules import cache_specs as jcache

    jcfg, cfg = REGISTRY[arch], get_config(arch)
    if seq == 524288 and not cfg.supports_long_context:
        jcfg, cfg = jcfg.with_window(4096), cfg.with_window(4096)
    jmodel = jbuild(jcfg, vocab_pad_multiple=2048)
    model = build_model(cfg, device="meta", vocab_pad_multiple=2048)
    caches = model.init_cache(batch, seq)
    for seq_model in (False, True):
        want = _repro_specs(jcache(jmodel, jcfg, batch, seq,
                                   shard_seq=(batch == 1),
                                   shard_seq_model=seq_model))
        got = rules.cache_specs(model, cfg, batch, seq,
                                shard_seq=(batch == 1),
                                shard_seq_model=seq_model)
        assert len(got) == len(caches)
        for i, (specs, cache) in enumerate(zip(got, caches)):
            for leaf, spec in specs.items():
                if cfg.family == "hybrid":
                    si, _, bi, _ = hybrid_layout(cfg)[i]
                    path = f"{si}/b{bi}/{leaf}"
                else:
                    path = leaf
                assert spec == want[path][1:], (i, leaf)
                _assert_divides(spec, tuple(cache[leaf].shape), leaf)
    # repro's tree of shapes, stacked, has the port's per-layer shapes
    shapes = jax.eval_shape(lambda: jmodel.init_cache(batch, seq))
    assert sum(x.shape[0] for x in jax.tree.leaves(shapes)) == sum(
        len(c) for c in caches)


@pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b",
                                  "whisper-medium"])
def test_batch_specs_match_repro(arch, data_axes):
    from repro.configs import REGISTRY
    from repro.sharding.rules import batch_specs as jbatch

    for B in (1, 64):
        want = {k: tuple(v) for k, v in jbatch(
            REGISTRY[arch], "train", B, data_axes).items()}
        assert rules.batch_specs(get_config(arch), "train", B,
                                 data_axes) == want
