"""The shape-and-memory dry run against `repro`'s and against real runs
(`repro_torch.configs.shapes`, `launch.specs`, `launch.dryrun`,
`launch.fl_dryrun`, `core.dpfl.abstract_round_state`, the `ShapeMesh`,
and training under the model axis).

* `resolve_arch_for_shape`, `input_specs` (shapes, int dtypes) and
  `batch_spec_tree` equal `repro`'s for all 39 (arch, shape) combos (and
  the whisper skip's text), `model_flops_estimate` `repro`'s for every
  combo;
* every rank-local weight is the `local_block` of its whole weight,
  but for the documented reads;
* `abstract_round_state` has the real state's leaves (names, shapes,
  dtypes), on one device and, rank by rank, on the gloo client meshes;
* a `ShapeMesh` round's `CallRecord`s equal the gloo meshes' op by op
  on every rank (dense, sparse and top-k rounds, on the random graph
  and the greedy's, on (1, 2) and (2, 2)),
  and so do one seqshard decode step's of reduced qwen3 on the (1, 2)
  model mesh;
* `fl_dryrun --random-graph --audit-bytes` reconciles at 512 clients on
  (2, 256);
* the model axis trains: the gradients of reduced qwen3-moe and qwen3 on
  the (1, 2) and (2, 2) model meshes equal the single-device gradients
  of the same weights within GRAD_TOL of each leaf's largest element.
"""
from __future__ import annotations

import dataclasses
import os

import test_torch_common as common  # noqa: F401  (the jax patch; first)
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro_torch.analysis.guards import _leaves
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.core.dpfl import (DPFLConfig, abstract_round_state,
                                   dpfl_initial_state, dpfl_round_step)
from repro_torch.fl.compress import CompressionConfig
from repro_torch.launch import dryrun, fl_dryrun, specs
from repro_torch.launch.mesh import (AXES, make_production_mesh,
                                     run_on_client_mesh, run_on_mesh)
from repro_torch.models import build_model
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.rules import param_specs

COMBOS = [(a, s) for a in ARCH_IDS for s in SHAPES]
#: the model-axis gradients against the single-device ones: the forward
#: met 1e-5 (tests/test_torch_model_mesh.py); each leaf's max abs error
#: over its largest element
GRAD_TOL = 1e-5


def _repro_specs():
    from repro.launch import specs as jspecs
    return jspecs


# ------------------------------------------------------------ the specs


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_specs_equal_repros(arch, shape):
    """The config, the inputs' shapes and integer dtypes (per client 1
    and 2) and the specs (one pod's data axis, both pods', a client
    axis) of each combo equal `repro`'s; whisper x long_500k raises the
    same NotImplementedError in both."""
    import jax.numpy as jnp

    js = _repro_specs()
    if arch == "whisper-medium" and shape == "long_500k":
        with pytest.raises(NotImplementedError) as want:
            js.resolve_arch_for_shape(arch, shape)
        with pytest.raises(NotImplementedError) as got:
            specs.resolve_arch_for_shape(arch, shape)
        assert str(got.value) == str(want.value)
        return
    jcfg = js.resolve_arch_for_shape(arch, shape)
    cfg = specs.resolve_arch_for_shape(arch, shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    from repro.configs.shapes import get_shape as jget_shape
    for per_client in (1, 2):
        want = js.input_specs(jcfg, jget_shape(shape), per_client=per_client,
                              dtype=jnp.float32)
        got = specs.input_specs(cfg, get_shape(shape),
                                per_client=per_client)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).replace("torch.", "") == \
                str(want[k].dtype), k
    for axes in (("data",), ("pod", "data")):
        for client in (None, "pod"):
            want = js.batch_spec_tree(jcfg, jget_shape(shape), axes, client)
            got = specs.batch_spec_tree(cfg, get_shape(shape), axes, client)
            assert got == {k: tuple(v) for k, v in want.items()}


_JFLOPS = {}


def _repro_model_flops(arch, shape):
    """`repro`'s ``model_flops_estimate`` of the combo, from its model's
    abstract init (its dry-run module sets XLA_FLAGS at import: jax is
    initialised first, and the flags are put back)."""
    import jax

    if not _JFLOPS:
        jax.devices()
        flags = os.environ.get("XLA_FLAGS")
        from repro.launch import dryrun as jdry
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
        _JFLOPS["module"] = jdry
    from repro.configs.shapes import get_shape as jget_shape
    from repro.models import build_model as jbuild

    jdry = _JFLOPS["module"]
    js = _repro_specs()
    if arch not in _JFLOPS:
        cfg = js.resolve_arch_for_shape(arch, "train_4k")
        model = jbuild(cfg, vocab_pad_multiple=2048)
        _JFLOPS[arch] = (cfg, jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    cfg, params = _JFLOPS[arch]
    return jdry.model_flops_estimate(params, cfg, jget_shape(shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_repros(arch):
    """6 N D (train) or 2 N D, N active for MoE, over the weights of the
    model built with vocab_pad_multiple 2048: `repro`'s number for every
    shape of the arch."""
    cfg = specs.resolve_arch_for_shape(arch, "train_4k")
    model = build_model(cfg, device="meta", vocab_pad_multiple=2048)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for shape in SHAPES:
        assert dryrun.model_flops_estimate(shapes, cfg, get_shape(shape)) \
            == _repro_model_flops(arch, shape), shape


def test_shape_mesh_answers_for_a_production_mesh():
    """`make_production_mesh` is `repro`'s two meshes as `ShapeMesh`es
    of rank 0: axis sizes, coordinates, shard indices and groups without
    torch.distributed (rank 300 of the two pods' mesh), and only "meta"
    tensors."""
    single = make_production_mesh()
    assert coll.mesh_axis_sizes(single) == {"data": 16, "model": 16}
    assert coll.mesh_axis_sizes(make_production_mesh(multi_pod=True)) == {
        "pod": 2, "data": 16, "model": 16}
    assert single.rank == make_production_mesh(multi_pod=True).rank == 0
    multi = coll.ShapeMesh((2, 16, 16), ("pod", "data", "model"), 300)
    assert [coll.axis_index(multi, a) for a in ("pod", "data", "model")] \
        == [1, 2, 12]
    assert coll.shard_index(multi, ("pod", "data")) == 18
    assert coll._group(multi, ("model",))[1] == list(range(288, 304))
    assert coll._group(multi, ("pod", "data"))[1] == list(range(12, 512, 16))
    x = torch.empty(3, 5, device="meta")
    assert coll.psum(x, multi, ("pod", "data")).shape == (3, 5)
    assert coll.all_gather_rows(x, multi).shape == (96, 5)
    assert coll.ppermute_next(x, multi, "data").shape == (3, 5)
    with pytest.raises(ValueError, match="'meta' tensors only"):
        coll.psum(torch.zeros(3), multi, "model")


# ------------------------------------------------- the rank-local model


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_rank_local_weight_is_its_local_block(arch):
    """The rank-local model of each arch on (16, 16): every weight the
    `local_block` of its whole weight under `param_specs`, but the
    documented reads (the whole KV projections' heads where they do not
    divide M, the recurrent gates' diagonal block); a weight of any
    other shape fails the check."""
    M = 16
    cfg = specs.resolve_arch_for_shape(arch, "train_4k").replace(
        dtype="float32")
    whole = build_model(cfg, device="meta", vocab_pad_multiple=2048)
    sizes = {"data": 16, "model": M}
    pspecs = param_specs(whole, cfg, sizes)
    lcfg, kv_read = dryrun.local_config(cfg, M)
    lcfg = lcfg.replace(vocab_size=cfg.padded_vocab(2048) // M)
    local = build_model(lcfg, device="meta",
                        mesh=coll.ShapeMesh((16, M), ("data", "model")))
    mesh = make_production_mesh()
    notes = dryrun.check_local_leaves(local.state_dict(),
                                      whole.state_dict(), pspecs, mesh,
                                      kv_read, cfg.family)
    kinds = {n.split(" ")[0].rsplit(".", 1)[-1] for n in notes}
    assert kinds <= ({"wk", "wv"} if kv_read else set()) | (
        {"wa", "wx"} if cfg.family == "hybrid" else set())
    assert bool(kv_read) == (cfg.n_heads > 0 and cfg.n_kv_heads % M != 0)
    bad = dict(local.state_dict())
    name = next(k for k in bad if k.endswith("tok_embed"))
    bad[name] = torch.empty((3, 3), device="meta")
    with pytest.raises(AssertionError, match="local_block"):
        dryrun.check_local_leaves(bad, whole.state_dict(), pspecs, mesh,
                                  kv_read, cfg.family)


# ------------------------------------------------ the round's state


ROUND_DATA = dict(common.SMALL_DATA, n_clients=8)
ROUND_BASE = dict(tau_init=1, tau_train=1, budget=3, seed=0, rounds=2)
TOPK = dict(codec="topk", topk_frac=0.3)
ROUNDS = {"dense-random": dict(ROUND_BASE, random_graph=True),
          "sparse-random": dict(ROUND_BASE, random_graph=True,
                                graph_repr="sparse"),
          "topk-random": dict(ROUND_BASE, random_graph=True,
                              compression=TOPK),
          "dense": dict(ROUND_BASE),
          "sparse": dict(ROUND_BASE, graph_repr="sparse"),
          "topk": dict(ROUND_BASE, compression=TOPK)}


def _kw(kw):
    kw = dict(kw)
    if "compression" in kw:
        kw["compression"] = CompressionConfig(**kw["compression"])
    return kw


def _cfg(kw):
    return DPFLConfig(**_kw(kw))


@pytest.mark.parametrize("kw", [
    dict(ROUND_BASE), dict(ROUND_BASE, graph_repr="sparse"),
    dict(ROUND_BASE, compression=dict(codec="int8")),
    dict(ROUND_BASE, compression=TOPK, graph_repr="sparse",
         track_history=True),
    dict(ROUND_BASE, participation=dict(rate=0.5)),
    dict(ROUND_BASE, adversary=dict(attack="free_rider", fraction=0.25))],
    ids=["dense", "sparse", "int8", "topk-sparse-history", "participation",
         "adversary"])
def test_abstract_round_state_has_the_real_states_leaves(kw):
    """`abstract_round_state` on "meta": the leaves of
    `dpfl_initial_state`'s state (path, shape, dtype), with no
    preprocessing run."""
    from repro_torch.data import ParticipationConfig
    from repro_torch.fl.adversary import AdversaryConfig

    kw = dict(kw)
    if "participation" in kw:
        kw["participation"] = ParticipationConfig(**kw["participation"])
    if "adversary" in kw:
        kw["adversary"] = AdversaryConfig(**kw["adversary"])
    cfg = _cfg(kw)
    engine = workers._engine("cpu", ROUND_DATA, common.SMALL_MLP,
                             common.SMALL_ENGINE, None)
    real, _ = dpfl_initial_state(engine, cfg)
    abstract = abstract_round_state(engine, cfg)
    assert workers.state_leaves(abstract) == workers.state_leaves(real)
    assert all(t.device.type == "meta"
               for t in _leaves(abstract).values())


# ------------------------------------------- against the gloo meshes

CLIENT_MESHES = {"1x2": (2, 1), "2x2": (4, 2)}
_RUNS = {}


def _client_runs(name, tmp_path_factory):
    if name not in _RUNS:
        world, pods = CLIENT_MESHES[name]
        store = tmp_path_factory.mktemp(f"dryrun-{name}") / "store"
        _RUNS[name] = run_on_client_mesh(
            workers.dryrun_mesh_runs, world, pods=pods, device="cpu",
            init_file=str(store), timeout=600, args=((), (
                ROUND_DATA, common.SMALL_MLP, common.SMALL_ENGINE,
                [(n, _kw(kw)) for n, kw in ROUNDS.items()])))
    return _RUNS[name]["rounds"]


@pytest.mark.parametrize("run", list(ROUNDS))
@pytest.mark.parametrize("mesh", list(CLIENT_MESHES))
def test_shape_mesh_round_records_equal_the_gloo_meshes(mesh, run,
                                                         tmp_path_factory):
    """On every rank, a `ShapeMesh` round on "meta" from
    `abstract_round_state` makes the real round's collective calls op
    by op (op, shape, dtype, bytes, group size, site, region), and its
    state has the real rank's leaves."""
    records, leaves = _client_runs(mesh, tmp_path_factory)[run]
    world, pods = CLIENT_MESHES[mesh]
    cfg = _cfg(ROUNDS[run])
    engine = workers._engine("meta", ROUND_DATA, common.SMALL_MLP,
                             common.SMALL_ENGINE, None)
    for rank in range(world):
        engine.shard_clients(coll.ShapeMesh((pods, world // pods), AXES,
                                            rank))
        state = abstract_round_state(engine, cfg)
        assert workers.state_leaves(state) == leaves[rank]
        with coll.recording() as recs:
            dpfl_round_step(engine, cfg)(state)
        assert [dataclasses.astuple(c) for c in recs] == \
            [dataclasses.astuple(c) for c in records[rank]], rank
        assert recs, "a sharded round makes collective calls"


def test_fl_dryrun_reconciles_at_512_clients_on_512_devices(capsys):
    """`fl_dryrun --random-graph --audit-bytes` at its defaults (512
    PaperCNN clients, (2, 256)): the wire bytes reconcile exactly."""
    assert fl_dryrun.main(["--random-graph", "--audit-bytes",
                           "--no-out"]) == 0
    out = capsys.readouterr().out
    assert "on 512 devices (2 pods)" in out
    assert "wire x E == claimed x N(D-1) — reconciled" in out
    assert "wire model/round = 64891015168" in out


# ------------------------------------------------ the model axis

GRAD_ARCHS = ("qwen3-moe-30b-a3b", "qwen3-0.6b")
MODEL_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
_MODEL_RUNS = {}


def _tokens(arch):
    from repro_torch.configs import get_config

    V = get_config(arch).reduced().vocab_size
    return np.random.default_rng(0).integers(0, V, (4, 17)).astype(np.int32)


def _model_runs(name, tmp_path_factory):
    if name not in _MODEL_RUNS:
        store = tmp_path_factory.mktemp(f"dryrun-model-{name}") / "store"
        decode = ("qwen3-0.6b", 0, 2, 16, 9) if name == "1x2" else None
        _MODEL_RUNS[name] = run_on_mesh(
            workers.dryrun_mesh_runs, MODEL_MESHES[name], ("data", "model"),
            device="cpu", init_file=str(store), timeout=600, args=(
                [(a, 0, _tokens(a)) for a in GRAD_ARCHS], None, decode))
    return _MODEL_RUNS[name]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
@pytest.mark.parametrize("mesh", list(MODEL_MESHES))
def test_model_axis_gradients_equal_one_devices(mesh, arch,
                                                tmp_path_factory):
    """`launch.steps.make_train_step` on the model mesh (the rank's
    experts, its rows of the batch, dropless dispatch): the loss and
    every gradient (the experts gathered over ``model``) equal the
    single-device loss and gradients of the same weights within GRAD_TOL
    of each leaf's largest element, and every rank holds the same
    non-expert gradients. A replicated cotangent summed once a rank would
    double them on (1, 2)."""
    got = _model_runs(mesh, tmp_path_factory)["grads"][
        GRAD_ARCHS.index(arch)]
    cfg, whole = workers._whole_params(arch, 0)
    model = build_model(cfg, device="meta", **workers.GRAD_KW)
    model.load_state_dict(whole, assign=True)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss({"tokens": torch.from_numpy(_tokens(arch)).long()})
    grads = torch.autograd.grad(loss, list(params.values()))
    loss = loss.item()
    assert got["same"]
    assert abs(got["loss"] - loss) <= GRAD_TOL * abs(loss)
    for (name, _), g in zip(params.items(), grads):
        want = g.numpy()
        err = np.abs(got["grads"][name] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)


def test_shape_mesh_decode_records_equal_the_gloo_meshes(tmp_path_factory):
    """One seqshard decode step of reduced qwen3 on the (1, 2) model mesh
    (the rings on ``model``): on "meta" on a `ShapeMesh` it makes each
    rank's calls op by op."""
    real = _model_runs("1x2", tmp_path_factory)["decode"]
    arch, seed, batch, cache_len, pos = ("qwen3-0.6b", 0, 2, 16, 9)
    cfg, _ = workers._whole_params(arch, seed)
    for rank in range(2):
        mesh = coll.ShapeMesh((1, 2), ("data", "model"), rank)
        model = build_model(cfg, device="meta", mesh=mesh,
                            decode_cache_seqshard=True)
        with torch.inference_mode(), coll.recording() as recs:
            caches = model.init_cache(batch, cache_len)
            model.decode_step(caches, torch.zeros(
                (batch, 1), dtype=torch.int64, device="meta"), pos)
        assert [dataclasses.astuple(c) for c in recs] == \
            [dataclasses.astuple(c) for c in real[rank]]
        assert {r.op for r in recs} == {"psum", "pmax"}
