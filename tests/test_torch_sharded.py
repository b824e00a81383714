"""The client mesh on the CPU: the port's sharded DPFL paths against its
own single-device runs and against `repro`'s.

Ranks are gloo processes started by `repro_torch.launch.mesh.
run_on_client_mesh` from a ``file://`` store under the test's temporary
directory (so concurrent test workers never share a port): meshes
``(1, 2)``, ``(1, 4)`` and ``(2, 2)``, the last crossing the pod axis.
One launch per mesh runs everything that mesh is held to
(`torch_mesh_workers.all_runs`); the tests read its results.

`repro`'s own sharded tests (tests/test_sharded_engine.py) cannot run
here: their subprocesses import `repro.sharding.compat` without
tests/test_torch_common.py's patch for jax 0.9. So the expectations are
the ones they assert, held against single-device runs:

* the three Eq.-4 ops against `repro.kernels.ref` within 1e-5 (the
  neighbor-list rotation sums in visit order), and the rotation plan
  equal to `repro.kernels.ops._rotation_schedule`;
* whole runs on the small MLP setting with N = 8 from `repro`'s init:
  the dense paths bit for bit against the port's single-device run
  (K1 sums each row in the same order whatever its row count), the
  neighbor-list paths within 1e-6 on the parameters with every integer,
  graph and accuracy equal; against `repro`, the tolerances of
  tests/test_torch_dpfl.py (integers and graphs exact, accuracies 1e-6,
  best_flat rtol 1e-4 and atol 1e-5);
* the eleven baselines' accuracies within 1e-6 of the single-device
  run's, and `shard_clients`' refusal of an N that does not divide.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.dpfl import DPFLConfig, _dpfl_aux_specs  # noqa: E402
from repro_torch.core.dpfl import run_dpfl  # noqa: E402
from repro_torch.data import ParticipationConfig  # noqa: E402
from repro_torch.fl.adversary import AdversaryConfig  # noqa: E402
from repro_torch.fl.baselines import BASELINES  # noqa: E402
from repro_torch.fl.compress import CompressionConfig  # noqa: E402
from repro_torch.fl.round_engine import (init_round_state,  # noqa: E402
                                         round_state_shardings,
                                         shard_round_state)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import (make_client_mesh,  # noqa: E402
                                     run_on_client_mesh)

MESHES = {"1x2": (2, 1), "1x4": (4, 1), "2x2": (4, 2)}
DATA = dict(common.SMALL_DATA, n_clients=8)
# 6 clients do not split over 4 shards
BAD_DATA = dict(common.SMALL_DATA, n_clients=6)
BASE = dict(tau_init=2, tau_train=1, budget=3, seed=0)
_ADV = dict(attack="grad_scale", fraction=0.25, seed=7, scale=3.0)
_FREE = dict(attack="free_rider", fraction=0.25, seed=0, noise_scale=1.0)
# name -> (DPFLConfig keywords; config objects as (kind, keywords)),
# whether the path is dense (bit for bit against the port's own run)
SETTINGS = {
    "dense-random": (dict(BASE, rounds=4, random_graph=True), True),
    "dense-ggc": (dict(BASE, rounds=3), True),
    "dense-ggc-refresh2": (dict(BASE, rounds=4, refresh_period=2), True),
    "sparse-ggc": (dict(BASE, rounds=3, graph_repr="sparse"), False),
    "sparse-random": (dict(BASE, rounds=4, random_graph=True,
                           graph_repr="sparse"), False),
    "participation-random": (dict(
        BASE, rounds=4, random_graph=True,
        participation=("part", dict(rate=0.5, model="bernoulli",
                                    seed=2))), True),
    "participation-ggc": (dict(
        BASE, rounds=3,
        participation=("part", dict(rate=0.6, model="markov",
                                    seed=3))), True),
    "trimmed-dense": (dict(BASE, rounds=3, random_graph=True,
                           adversary=("adv", _ADV), mix_rule="trimmed",
                           trim_frac=0.25), True),
    "trimmed-sparse": (dict(BASE, rounds=3, random_graph=True,
                            graph_repr="sparse", adversary=("adv", _ADV),
                            mix_rule="trimmed", trim_frac=0.25), False),
    "topk-dense": (dict(BASE, rounds=3, compression=(
        "codec", dict(codec="topk", topk_frac=0.3))), True),
    "topk-sparse": (dict(BASE, rounds=3, graph_repr="sparse", compression=(
        "codec", dict(codec="topk", topk_frac=0.3))), False),
    "int8-dense": (dict(BASE, rounds=3, random_graph=True, compression=(
        "codec", dict(codec="int8"))), True),
    "int8-sparse": (dict(BASE, rounds=3, graph_repr="sparse", compression=(
        "codec", dict(codec="int8"))), False),
    "freerider-clipped-dense": (dict(BASE, rounds=3, adversary=(
        "adv", _FREE), mix_rule="clipped", clip_mult=1.5), True),
    "freerider-clipped-sparse": (dict(
        BASE, rounds=3, graph_repr="sparse", adversary=("adv", _FREE),
        mix_rule="clipped", clip_mult=1.5), False),
}
# the settings also run through `repro` (the randomness of the free-rider
# noise is the port's prng.normal, a few ulps off jax's: not compared)
REPRO_SETTINGS = [n for n in SETTINGS if not n.startswith("freerider")]
BASELINE_KW = dict(rounds=2, tau=1, seed=0)
OPS = ("graph_mix", "compressed_graph_mix", "sparse_graph_mix",
       "sparse_graph_mix_int8", "peer_rows")


def _port_kw(kw):
    kinds = {"part": ParticipationConfig, "adv": AdversaryConfig,
             "codec": CompressionConfig}
    return {k: kinds[v[0]](**v[1]) if isinstance(v, tuple) else v
            for k, v in kw.items()}


def _repro_kw(kw):
    from repro.core import AdversaryConfig as JAdv
    from repro.core import CompressionConfig as JCodec
    from repro.core import ParticipationConfig as JPart

    kinds = {"part": JPart, "adv": JAdv, "codec": JCodec}
    return {k: kinds[v[0]](**v[1]) if isinstance(v, tuple) else v
            for k, v in kw.items()}


def _op_case():
    """Inputs of the op-level checks: N 8, P 37 (odd: one column a
    thread), lists of width 3 with -1 slots, top-k of 5, int8 parts."""
    return workers.op_case(8, 37, 3, 5)


def _repro_init():
    """`repro`'s init of the clients of every run (seed 0's k_init),
    as numpy leaves."""
    import jax

    from repro.fl.engine import FLEngine as JEngine
    from repro.data import make_federated_classification as jmake
    from repro.models.classifier import MLP as JMLP

    je = JEngine(JMLP(*common.SMALL_MLP), jmake(**DATA),
                 **common.SMALL_ENGINE)
    k_init = jax.random.split(jax.random.PRNGKey(BASE["seed"]), 4)[0]
    return je, common.np_tree(je.init_clients(k_init))


class _Runs:
    """Every mesh's launch and every single-device run, made once."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.meshes = {}
        self.single = None
        self.repro = {}
        self.je, self.init = _repro_init()

    def mesh(self, name):
        if name not in self.meshes:
            world, pods = MESHES[name]
            store = self.tmp.mktemp(f"store-{name}") / "store"
            self.meshes[name] = run_on_client_mesh(
                workers.all_runs, world, pods=pods, device="cpu",
                init_file=str(store), timeout=600, args=(
                    [_op_case()], DATA, common.SMALL_MLP,
                    common.SMALL_ENGINE, self.init,
                    [(n, _port_kw(kw)) for n, (kw, _) in SETTINGS.items()],
                    list(BASELINES), BASELINE_KW, BAD_DATA))
        return self.meshes[name]

    def single_device(self):
        if self.single is None:
            engine = workers._engine("cpu", DATA, common.SMALL_MLP,
                                     common.SMALL_ENGINE, None)
            workers._carry(engine, self.init)
            runs = {n: workers.result_dict(run_dpfl(
                engine, DPFLConfig(**_port_kw(kw))))
                for n, (kw, _) in SETTINGS.items()}
            engine = workers._engine("cpu", DATA, common.SMALL_MLP,
                                     common.SMALL_ENGINE, None)
            base = {n: fn(engine, **BASELINE_KW)["test_acc"]
                    for n, fn in BASELINES.items()}
            self.single = (runs, base)
        return self.single

    def repro_run(self, name):
        if name not in self.repro:
            from repro.core import DPFLConfig as JConfig
            from repro.core import run_dpfl as jrun

            self.repro[name] = jrun(self.je, JConfig(**_repro_kw(
                SETTINGS[name][0])))
        return self.repro[name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory)


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_rotation_schedule_matches_repro(shape):
    from repro.kernels.ops import _rotation_schedule as jschedule

    class StandIn:   # what repro's mesh_axis_sizes reads of a mesh
        axis_names = ("pod", "data")
        axis_sizes = shape

    axes = ("pod", "data")
    want = jschedule(StandIn(), axes)
    got = ops._rotation_schedule(dict(zip(axes, shape)), axes)
    assert got == want
    # every non-zero offset of the torus is visited once
    assert sorted(off for _, off in got[1]) == sorted(
        (a, b) for a in range(shape[0]) for b in range(shape[1])
        if (a, b) != (0, 0))


def test_make_client_mesh_refuses_pods_that_do_not_divide():
    with pytest.raises(ValueError, match="not divisible into 2 pods"):
        make_client_mesh(3, pods=2)


@pytest.mark.parametrize("build", ["make_mesh", "make_client_mesh"])
def test_mesh_defaults_to_the_card_without_probing(monkeypatch, build):
    """No silent CPU fallback: `make_mesh` and `make_client_mesh` build a
    "cuda" mesh unless the caller asks for "cpu", with no card present
    too (`torch.cuda.is_available` is not asked). The mesh itself is not
    built: a stand-in records what `DeviceMesh` would be given."""
    import inspect

    import torch.distributed.device_mesh as device_mesh

    from repro_torch.launch import mesh as tmesh

    made = []

    def stand_in(device_type, ranks, mesh_dim_names):
        made.append((device_type, ranks.tolist(), mesh_dim_names))
        return made[-1]

    def no_probe():
        raise AssertionError("make_mesh asked torch.cuda.is_available")

    monkeypatch.setattr(device_mesh, "DeviceMesh", stand_in)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", no_probe)
    fn = getattr(tmesh, build)
    assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    if build == "make_mesh":
        fn((1, 2), ("data", "model"))
        fn((1, 2), ("data", "model"), device_type="cpu")
        assert made == [("cuda", [[0, 1]], ("data", "model")),
                        ("cpu", [[0, 1]], ("data", "model"))]
    else:
        fn(2)
        fn(2, device_type="cpu")
        assert made == [("cuda", [[0, 1]], ("pod", "data")),
                        ("cpu", [[0, 1]], ("pod", "data"))]


def test_launcher_raises_a_rank_failure(tmp_path):
    with pytest.raises(RuntimeError, match="deliberate failure on rank 1"):
        run_on_client_mesh(workers.fail_on_rank, 2, device="cpu",
                           init_file=str(tmp_path / "store"), timeout=120,
                           args=(1,))


def test_shard_round_state_cuts_client_rows():
    """`shard_round_state` with `_dpfl_aux_specs` takes a rank's rows of
    the client leaves and leaves the rest whole."""
    N, P, rows = 8, 5, slice(2, 4)
    flat = torch.arange(N * P, dtype=torch.float32).reshape(N, P)
    aux = {"adj": torch.eye(N, dtype=torch.bool),
           "omega": torch.ones((N, N), dtype=torch.bool),
           "k_graph": prng.PRNGKey(1), "comm": torch.zeros(3),
           "graph_hist": torch.zeros((3, N, N), dtype=torch.bool),
           "part": torch.ones((3, N), dtype=torch.bool)}
    state = init_round_state(flat, prng.PRNGKey(0), hist_len=3, aux=aux)
    specs = _dpfl_aux_specs(3, participation=True)
    cut = shard_round_state(state, rows, specs)
    assert torch.equal(cut.flat, flat[rows])
    assert torch.equal(cut.best_flat, flat[rows])
    assert cut.best_val.shape == (2,) and cut.val_hist.shape == (3, 2)
    assert torch.equal(cut.aux["adj"], aux["adj"][rows])
    assert cut.aux["graph_hist"].shape == (3, 2, N)
    assert torch.equal(cut.aux["part"], aux["part"])
    assert torch.equal(cut.aux["k_graph"], aux["k_graph"])
    spec = round_state_shardings(hist_len=3, aux_specs=specs)
    assert (spec.flat, spec.val_hist, spec.key) == (0, 1, None)


# ------------------------------------------------------------ the ops


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_ops_match_ref(runs, mesh, op):
    """Each rank's row block, gathered, against the whole plain version:
    the dense mixes bit for bit, the rotation within 1e-5. The dense ops
    gather (1 call each, 2 for top-k's parts); the rotation moves one
    panel a step (D - 1 steps, a step's shifts along several axes
    composed into one exchange)."""
    c = _op_case()
    T = torch.from_numpy
    got, counts = runs.mesh(mesh)["ops"][0]
    dec8 = T(c["q"]).float() * T(c["scale"])[:, None]
    want = {
        "graph_mix": ref.graph_mix_ref(T(c["A"]), T(c["W"])),
        "compressed_graph_mix": ref.compressed_graph_mix_ref(
            T(c["A"]), T(c["vals"]), T(c["idx"]), c["p_dim"]),
        "sparse_graph_mix": ref.sparse_graph_mix_ref(
            T(c["sw"]), T(c["nw"]), T(c["nbr"]), T(c["W"]), T(c["W"])),
        "sparse_graph_mix_int8": ref.sparse_graph_mix_ref(
            T(c["sw"]), T(c["nw"]), T(c["nbr"]), T(c["W"]), dec8),
        "peer_rows": T(c["W"])[T(c["nbr"]).clamp(0, 7).long()]
        * (T(c["nbr"]) >= 0)[..., None]}[op].numpy()
    if op in ("graph_mix", "compressed_graph_mix", "peer_rows"):
        np.testing.assert_array_equal(got[op], want)
    else:
        np.testing.assert_allclose(got[op], want, rtol=0, atol=1e-5)
    assert counts["gathers_of_dense_ops"] == 3
    world, pods = MESHES[mesh]
    sizes = {"pod": pods, "data": world // pods}
    # the rotations move 4 parts: the plain mix's panel, int8's q and
    # scale, the peer rows' panel; each of the D - 1 steps is one shift,
    # also where it moves both axes (at a pod boundary)
    steps = ops._rotation_schedule(sizes, ("pod", "data"))[1]
    assert len(steps) == world - 1
    assert counts["ppermute"][0] == 4 * len(steps)


# ------------------------------------------------------- whole DPFL runs


def _assert_same_ints(a, b, label):
    for k in ("comm_downloads", "comm_preprocess", "comm_bytes",
              "comm_bytes_preprocess"):
        assert a[k] == b[k], f"{label}: {k}"


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_dpfl_matches_single_device(runs, mesh, setting):
    kw, dense = SETTINGS[setting]
    got, counts = runs.mesh(mesh)["dpfl"][setting]
    want = runs.single_device()[0][setting]
    label = f"{setting} on {mesh}"
    _assert_same_ints(want, got, label)
    for k in ("omega", "graph_history", "test_acc", "val_acc_history"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=label + k)
    for k in ("participation", "malicious"):
        if want[k] is None:
            assert got[k] is None, label
        else:
            np.testing.assert_array_equal(want[k], got[k], err_msg=label)
    if dense:
        np.testing.assert_array_equal(want["best_flat"], got["best_flat"],
                                      err_msg=label)
    else:
        np.testing.assert_allclose(want["best_flat"], got["best_flat"],
                                   rtol=0, atol=1e-6, err_msg=label)
    N = DATA["n_clients"]
    if kw.get("random_graph"):
        assert got["comm_preprocess"] == N * kw["budget"]
    else:
        assert got["comm_preprocess"] == 2 * N * (N - 1)
    # the peers' rows crossed ranks, and only through the collectives
    assert counts["all_gather"][0] > 0


@pytest.mark.parametrize("setting", REPRO_SETTINGS)
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_sharded_dpfl_matches_repro(runs, mesh, setting):
    """The sharded run against `repro`'s single-device run from the same
    init, to tests/test_torch_dpfl.py's tolerances."""
    got = runs.mesh(mesh)["dpfl"][setting][0]
    want = runs.repro_run(setting)
    label = f"{setting} on {mesh} vs repro"
    assert got["comm_downloads"] == want.comm_downloads, label
    assert got["comm_preprocess"] == want.comm_preprocess, label
    assert got["comm_bytes"] == want.comm_bytes, label
    np.testing.assert_array_equal(np.asarray(want.omega), got["omega"],
                                  err_msg=label)
    np.testing.assert_array_equal(np.asarray(want.graph_history),
                                  got["graph_history"], err_msg=label)
    if want.participation is not None:
        np.testing.assert_array_equal(want.participation,
                                      got["participation"])
    if want.malicious is not None:
        np.testing.assert_array_equal(want.malicious, got["malicious"])
    np.testing.assert_allclose(want.test_acc, got["test_acc"], atol=1e-6,
                               err_msg=label)
    np.testing.assert_allclose(want.best_flat, got["best_flat"], rtol=1e-4,
                               atol=1e-5, err_msg=label)


# ------------------------------------------------------------ baselines


@pytest.mark.parametrize("name", list(BASELINES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_baselines_match_single_device(runs, mesh, name):
    got = runs.mesh(mesh)["baselines"][name]
    want = runs.single_device()[1][name]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_shard_clients_refuses_n_that_does_not_divide(runs, mesh):
    msg = runs.mesh(mesh)["refusal"]
    assert msg is not None and "not divisible by the 4 client shards" in msg


@pytest.mark.parametrize("setting", ["dense-random", "dense-ggc",
                                     "sparse-ggc"])
def test_client_chunk_changes_no_bit_on_the_cpu(runs, setting):
    """`FLEngine._client_chunk` (the bitwise twins' hook: local training,
    evaluation and the greedy's reward probes on that many clients at a
    time) gives the
    unchunked run's bits: on the CPU a client's values do not depend on
    the chunk (the card compares chunked runs with sharded ones)."""
    engine = workers._engine("cpu", DATA, common.SMALL_MLP,
                             common.SMALL_ENGINE, None, client_chunk=3)
    workers._carry(engine, runs.init)
    got = workers.result_dict(run_dpfl(
        engine, DPFLConfig(**_port_kw(SETTINGS[setting][0]))))
    want = runs.single_device()[0][setting]
    for k in ("best_flat", "test_acc", "omega", "graph_history",
              "val_acc_history"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    _assert_same_ints(want, got, setting)
