"""The port's round engine (`repro_torch.fl.round_engine`) against
`repro.fl.round_engine`, on the small MLP setting of
tests/test_round_engine.py (6 clients).

* `repro`'s own cases (tests/test_round_engine.py): the local-only step,
  the donating step bit for bit against the plain one over 4 rounds with
  the donation report, `dealias_state` / `init_round_state` on an
  aliased aux.
* `repro`'s calling conventions: a three-argument aggregate
  ``agg(flat, aux, t)`` and a local-train hook ``lt(stacked, key,
  epochs)`` run through both packages from the same numpy inputs; the
  states agree within 1e-6 (absolute, every leaf).
* The exchange-site warning: an unregistered aggregate warns in both
  packages; no aggregate that `run_dpfl` or a baseline builds warns in
  either (under ``warnings.simplefilter("error")``).
* Donation on every DPFL setting the DPFL tests run, and on the LM
  example's clients (their functions vmapped over the clients, the state
  leaves not): bit for bit what ``donate=False`` gives, every donatable
  leaf in place.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import functools  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.fl import baselines as jbaselines  # noqa: E402
from repro.fl.baselines import _global_avg as _jglobal_avg  # noqa: E402
from repro.fl.round_engine import init_round_state as jinit  # noqa: E402
from repro.fl.round_engine import make_round_step as jmake  # noqa: E402
from repro.fl.round_engine import run_rounds as jrun  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.analysis import guards  # noqa: E402
from repro_torch.analysis.guards import donation_report  # noqa: E402
from repro_torch.core import dpfl  # noqa: E402
from repro_torch.data import ParticipationConfig  # noqa: E402
from repro_torch.fl import baselines  # noqa: E402
from repro_torch.fl.baselines import _global_avg  # noqa: E402
from repro_torch.fl.adversary import AdversaryConfig  # noqa: E402
from repro_torch.fl.compress import CompressionConfig  # noqa: E402
from repro_torch.fl.round_engine import (RoundState,  # noqa: E402
                                         dealias_state, init_round_state,
                                         make_round_step, run_rounds)

_ENGINES = {}


def _engines():
    """(repro engine, port engine on the CPU) of the small MLP setting,
    the port's init carried over from `repro`'s."""
    if "mlp" not in _ENGINES:
        je, te = common.make_engines("mlp")
        common.carry_init(je, te)
        _ENGINES["mlp"] = (je, te)
    return _ENGINES["mlp"]


def _port_init(te, seed):
    key = prng.PRNGKey(seed)
    return te.flatten(te.init_clients(key)), key


def _same_bits(a, b):
    """Every tensor leaf of two states equal bit for bit, at the same
    paths; the host round counters equal."""
    la, lb = guards._leaves(a), guards._leaves(b)
    assert list(la) == list(lb)
    for path in la:
        assert la[path].dtype == lb[path].dtype, path
        assert torch.equal(la[path], lb[path]), path
    assert a.t == b.t


def _storages(state):
    return [x.untyped_storage().data_ptr()
            for x in guards._leaves(state).values()]


# ---- repro's own cases ------------------------------------------------------


def test_generic_round_engine_local_only():
    """The baselines' engine path: a local-only round_step tracks the
    best-on-validation model and advances the round counter; its best
    accuracies are `repro`'s (fractions of counts: within 1e-6)."""
    je, te = _engines()
    flat0, key = _port_init(te, 0)
    step = make_round_step(te, tau=1)
    state = run_rounds(step, init_round_state(flat0, key), 3)
    assert state.t == 3
    assert state.flat.shape == flat0.shape
    assert bool(torch.isfinite(state.best_val).all())
    # best_val is the running max of the (recorded) evaluations
    acc, _ = te.eval_val(te.unflatten(state.best_flat))
    assert bool((acc <= state.best_val + 1e-6).all())
    jkey = jax.random.PRNGKey(0)
    jflat0 = je.flatten(je.init_clients(jkey))
    jstate = jrun(jmake(je, tau=1), jinit(jflat0, jkey), 3)
    np.testing.assert_allclose(state.best_val.numpy(),
                               np.asarray(jstate.best_val), atol=1e-6)


def _avg_agg(te):
    def agg(flat, aux, t):
        return _global_avg(flat, te.p), aux
    return agg


def test_donating_round_step_bitwise_equals_nondonating():
    """`make_round_step(donate=True)` is a memory optimization only: bit
    for bit the plain step's state over 4 rounds; every leaf donatable
    and, for the donating step, every one in place; the donated input
    is consumed (its storage holds the round's output), the plain step's
    input left as it was."""
    _, te = _engines()
    agg = _avg_agg(te)
    flat0, key = _port_init(te, 11)
    step_n = make_round_step(te, tau=1, aggregate=agg)
    step_d = make_round_step(te, tau=1, aggregate=agg, donate=True)

    rep = donation_report(step_n, init_round_state(flat0, key))
    assert rep["blocked"] == []
    assert rep["donatable_bytes"] > 0
    assert ".flat" not in rep["in_place"]
    rep_d = donation_report(step_d, init_round_state(flat0, key))
    assert rep_d["blocked"] == []
    assert rep_d["in_place"] == rep_d["donatable"] == rep["donatable"]

    out_n = run_rounds(step_n, init_round_state(flat0, key), 4)
    out_d = run_rounds(step_d, init_round_state(flat0, key), 4)
    _same_bits(out_n, out_d)

    s_in = init_round_state(flat0, key)
    before = s_in.flat.clone()
    out = step_d(s_in)
    assert out.flat.data_ptr() == s_in.flat.data_ptr()
    assert not torch.equal(s_in.flat, before)     # consumed
    s_in = init_round_state(flat0, key)
    out = step_n(s_in)
    assert out.flat.data_ptr() != s_in.flat.data_ptr()
    assert torch.equal(s_in.flat, before)


def test_donation_keeps_an_aux_leaf_that_views_the_round_start_panel():
    """An aggregate may keep the round-start panel in its aux (a server
    momentum would): ``aux["last"]`` comes back as a view of the storage
    that ``flat`` is donated into. The donating step copies it out before
    any write, so it still holds the round-start models: the plain
    step's bits."""
    _, te = _engines()
    flat0, key = _port_init(te, 5)

    def agg(flat, aux, t, prev):
        return _global_avg(flat, te.p), dict(aux, last=prev)

    def run(donate):
        step = make_round_step(te, tau=1, aggregate=agg, donate=donate)
        return run_rounds(step, init_round_state(
            flat0, key, aux={"last": torch.zeros_like(flat0)}), 3)

    plain, donated = run(False), run(True)
    _same_bits(plain, donated)
    assert not torch.equal(donated.aux["last"], donated.flat)


def test_init_round_state_dealiases_aliased_leaves():
    """Initial states naturally alias (best_flat starts as flat; aux side
    models and keys reuse the same tensors). `init_round_state` gives
    every leaf its own storage, nested aux dicts' too; `dealias_state`
    copies a leaf whose storage an earlier leaf holds and keeps the rest;
    a donating step refuses an aliased state and runs on either."""
    _, te = _engines()
    flat0, key = _port_init(te, 0)
    st = init_round_state(flat0, key, aux={"side": flat0, "gkey": key,
                                           "adv": {"key": key}})
    ptrs = _storages(st)
    assert len(set(ptrs)) == len(ptrs)
    step = make_round_step(te, tau=1, donate=True)
    assert step(st).t == 1

    aliased = RoundState(t=0, key=key, flat=flat0,
                         best_val=torch.full((6,), float("-inf")),
                         best_flat=flat0, val_hist=None,
                         aux={"side": flat0, "gkey": key})
    with pytest.raises(ValueError, match="share storage"):
        step(aliased)
    clean = dealias_state(aliased)
    ptrs = _storages(clean)
    assert len(set(ptrs)) == len(ptrs)
    assert clean.key is key and clean.flat is flat0   # first holders kept
    assert torch.equal(clean.best_flat, flat0)
    assert torch.equal(clean.aux["gkey"], key)
    assert dealias_state(clean).aux["side"] is clean.aux["side"]
    assert step(clean).t == 1


# ---- repro's calling conventions ------------------------------------------


def test_three_argument_hooks_run_and_match_repro():
    """`repro`'s three-argument FedAvg aggregate ``agg(flat, aux, t)`` and
    a local-train hook ``lt(stacked, key, epochs)`` (neither takes
    ``prev`` nor ``aux``) through both packages' `make_round_step`, from
    `repro`'s init and key as numpy: no TypeError, and every leaf of the
    two states within 1e-6 after 3 rounds (absolute)."""
    je, te = _engines()
    jkey = jax.random.PRNGKey(11)
    jflat0 = je.flatten(je.init_clients(jkey))

    def jagg(flat, aux, t):
        return _jglobal_avg(flat, je.p), aux

    def jlt(stacked, key, epochs):
        return je.train_fn(stacked, key, epochs)

    seen = []

    def lt(stacked, key, epochs):
        seen.append(epochs)
        return te.local_train(stacked, key, epochs)

    jout = jrun(jmake(je, tau=2, aggregate=jagg, local_train=jlt,
                      hist_len=3), jinit(jflat0, jkey, hist_len=3), 3)
    flat0 = torch.from_numpy(np.array(jflat0))
    out = run_rounds(make_round_step(te, tau=2, aggregate=_avg_agg(te),
                                     local_train=lt, hist_len=3),
                     init_round_state(flat0, common.key_to_torch(jkey),
                                      hist_len=3), 3)
    assert seen == [2, 2, 2]
    assert out.t == int(jout.t) == 3
    for name in ("flat", "best_val", "best_flat", "val_hist"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_hooks_that_take_prev_and_aux_get_them():
    """An aggregate with a ``prev`` parameter gets the round-start panel,
    a local-train hook with an ``aux`` parameter gets ``aux`` and ``t``
    (and ``epochs`` by keyword), as `repro` calls them."""
    _, te = _engines()
    flat0, key = _port_init(te, 2)
    got = {}

    def agg(flat, aux, t, prev):
        got.setdefault("prev", []).append(prev.clone())
        return flat, aux

    def lt(stacked, key, *, epochs, aux, t):
        got.setdefault("lt", []).append((epochs, aux["tag"], t))
        return te.local_train(stacked, key, epochs)

    state = init_round_state(flat0, key, aux={"tag": torch.ones(1)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # agg is not a registered site
        step = make_round_step(te, tau=1, aggregate=agg, local_train=lt)
    mid = step(state)
    step(mid)
    assert [(e, t) for e, _, t in got["lt"]] == [(1, 0), (1, 1)]
    assert torch.equal(got["prev"][0], flat0)
    assert torch.equal(got["prev"][1], mid.flat)


# ---- the exchange-site warning ----------------------------------------------


def test_unregistered_aggregate_warns_in_both_packages():
    """An aggregate that mixes through no registered ``@exchange_site``
    warns at `make_round_step` in `repro` and in the port (which names its
    own decorator); a registered one, or one that calls one, does not."""
    je, te = _engines()

    def mean_mix(flat, aux, t):
        return flat.mean(0, keepdims=True) + 0 * flat, aux

    with pytest.warns(UserWarning, match="not a registered @exchange_site"):
        jmake(je, tau=1, aggregate=mean_mix)
    with pytest.warns(UserWarning, match="repro_torch.analysis.registry."
                                         "exchange_site"):
        make_round_step(te, tau=1, aggregate=mean_mix)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_round_step(te, tau=1, aggregate=_avg_agg(te))
        make_round_step(te, tau=1,
                        aggregate=baselines._fedavg_agg(te))
        make_round_step(te, tau=1)


class _Stop(Exception):
    pass


def _capture(monkeypatch, module, name="make_round_step"):
    """Patch ``module.make_round_step`` to record its aggregate, build
    the step under ``simplefilter("error")`` (a warning raises) and stop
    the run."""
    real = getattr(module, name)
    built = []

    def capturing(engine, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            real(engine, **kw)
        built.append(kw.get("aggregate"))
        raise _Stop

    monkeypatch.setattr(module, name, capturing)
    return built


_BASELINE_KW = {
    "fedavg-markov-topk": ("fedavg", dict(rate=0.7, model="markov",
                                          mean_burst=3.0, seed=0), "topk"),
    "apfl-bernoulli": ("apfl", dict(rate=0.7, seed=1), None),
    "ditto-bernoulli": ("ditto", dict(rate=0.7, seed=1), None),
}


@pytest.mark.parametrize("run", sorted(jbaselines.BASELINES)
                         + sorted(_BASELINE_KW))
def test_no_baseline_aggregate_warns(monkeypatch, run):
    """Every aggregate a baseline builds (each method, FedAvg with a codec
    under outages, APFL and Ditto under outages) is registered or
    reaches a registered function, in both packages."""
    from repro.data import ParticipationConfig as JPart
    from repro.fl.compress import CompressionConfig as JComp

    je, te = _engines()
    name, part, codec = _BASELINE_KW.get(run, (run, None, None))
    for mod, eng, P, C in ((jbaselines, je, JPart, JComp),
                           (baselines, te, ParticipationConfig,
                            CompressionConfig)):
        if hasattr(eng, "_baseline_step_cache"):
            del eng._baseline_step_cache
        built = _capture(monkeypatch, mod)
        kw = dict(rounds=2, tau=1, seed=0)
        if part is not None:
            kw["participation"] = P(**part)
        if codec is not None:
            kw["compression"] = C(codec)
        with pytest.raises(_Stop):
            mod.run_baseline(name, eng, **kw)
        assert len(built) == 1


_DPFL = dict(rounds=3, tau_init=1, tau_train=1, budget=3, seed=0)
_DPFL_SETTINGS = {
    "dense": {}, "dense-refresh2": dict(refresh_period=2),
    "random-graph": dict(random_graph=True),
    "sparse": dict(graph_repr="sparse"),
    "topk": dict(codec="topk"), "int8": dict(codec="int8"),
    "sparse-topk": dict(graph_repr="sparse", codec="topk"),
    "participation": dict(participation=dict(rate=0.7, seed=3)),
    "sparse-participation": dict(graph_repr="sparse",
                                 participation=dict(rate=0.7, seed=3)),
    "signflip-clipped": dict(
        participation=dict(rate=0.7, seed=3),
        adversary=dict(attack="sign_flip", fraction=0.34, seed=1),
        mix_rule="clipped"),
    "labelflip-trimmed": dict(
        adversary=dict(attack="label_flip", fraction=0.34, seed=1),
        mix_rule="trimmed"),
    "sparse-freerider-clipped": dict(
        graph_repr="sparse",
        adversary=dict(attack="free_rider", fraction=0.5, seed=3,
                       noise_scale=1.0), mix_rule="clipped"),
    "sparse-labelflip-trimmed": dict(
        graph_repr="sparse",
        adversary=dict(attack="label_flip", fraction=0.34, seed=1),
        mix_rule="trimmed"),
    "topk-signflip-clipped": dict(
        codec="topk", participation=dict(rate=0.75, seed=2),
        adversary=dict(attack="sign_flip", fraction=0.34, seed=0),
        mix_rule="clipped"),
}


def _dpfl_config(setting, pkg):
    """The setting as a `DPFLConfig` of ``pkg`` ("repro" or the port)."""
    if pkg == "repro":
        from repro.core import DPFLConfig
        from repro.data import ParticipationConfig as Part
        from repro.fl.adversary import AdversaryConfig as Adv
        from repro.fl.compress import CompressionConfig as Comp
    else:
        from repro_torch.core import DPFLConfig
        Part, Adv, Comp = (ParticipationConfig, AdversaryConfig,
                           CompressionConfig)
    spec = dict(_DPFL_SETTINGS[setting])
    codec = spec.pop("codec", None)
    if codec:
        spec["compression"] = Comp(codec)
    if "participation" in spec:
        spec["participation"] = Part(**spec["participation"])
    if "adversary" in spec:
        spec["adversary"] = Adv(**spec["adversary"])
    return DPFLConfig(**_DPFL, **spec)


@pytest.mark.parametrize("setting", list(_DPFL_SETTINGS))
def test_no_dpfl_aggregate_warns(setting):
    """The DPFL round step of each setting builds with no warning in
    either package (`repro`'s step cache cleared, so it is built)."""
    from repro.core import dpfl as jdpfl

    je, te = _engines()
    if hasattr(je, "_dpfl_round_step_cache"):
        del je._dpfl_round_step_cache
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jdpfl.dpfl_round_step(je, _dpfl_config(setting, "repro"))
        dpfl.dpfl_round_step(te, _dpfl_config(setting, "port"))


# ---- donation on every DPFL setting ---------------------------------------


@pytest.mark.parametrize("setting", list(_DPFL_SETTINGS))
def test_dpfl_donation_is_bitwise(setting):
    """`dpfl_round_step` donates by default; from one initial state, 3
    rounds of it give every leaf of the plain step's state bit for bit,
    and its donation report finds every donatable leaf in place, nothing
    blocked."""
    _, te = _engines()
    cfg = _dpfl_config(setting, "port")
    state, _ = dpfl.dpfl_initial_state(te, cfg)
    rep = donation_report(dpfl.dpfl_round_step(te, cfg), state)
    assert rep["blocked"] == []
    assert rep["in_place"] == rep["donatable"]
    plain = run_rounds(dpfl.dpfl_round_step(te, cfg, donate=False),
                       guards._copy(state), cfg.rounds)
    donated = run_rounds(dpfl.dpfl_round_step(te, cfg),
                         guards._copy(state), cfg.rounds)
    _same_bits(plain, donated)


def test_run_dpfl_donates_and_matches_the_plain_step(monkeypatch):
    """`run_dpfl` runs the donating step; its counters, graphs,
    accuracies and best models are those of a run whose step does not
    donate, bit for bit."""
    _, te = _engines()
    cfg = _dpfl_config("participation", "port")
    kinds = []
    real = dpfl.make_round_step

    def spy(engine, **kw):
        kinds.append(kw["donate"])
        return real(engine, **kw)

    monkeypatch.setattr(dpfl, "make_round_step", spy)
    a = dpfl.run_dpfl(te, cfg)
    monkeypatch.setattr(dpfl, "dpfl_round_step", functools.partial(
        dpfl.dpfl_round_step, donate=False))
    b = dpfl.run_dpfl(te, cfg)
    assert kinds == [True, False]
    assert a.comm_downloads == b.comm_downloads
    for x, y in zip(a.graph_history, b.graph_history):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.val_acc_history, b.val_acc_history):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.test_acc, b.test_acc)
    np.testing.assert_array_equal(a.best_flat, b.best_flat)


def test_lm_example_clients_donate_bitwise():
    """The LM example's engine (`examples/lm_dpfl_torch.py`: its loss and
    accuracy vmapped over the clients by `torch.func.vmap`): the round
    state's leaves are plain tensors outside the vmap, so the donating
    step writes them in place and gives the plain step's bits."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "lm_dpfl_torch", common.ROOT / "examples" / "lm_dpfl_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    engine, _ = ex.lm_engine(ex.example_config(), ex.CLIENTS, common.CPU)
    cfg = dpfl.DPFLConfig(**dict(ex.RUN, rounds=2))
    state, _ = dpfl.dpfl_initial_state(engine, cfg)
    for leaf in guards._leaves(state).values():
        assert not torch._C._functorch.is_batchedtensor(leaf)
    rep = donation_report(dpfl.dpfl_round_step(engine, cfg), state)
    assert rep["blocked"] == [] and rep["in_place"] == rep["donatable"]
    plain = run_rounds(dpfl.dpfl_round_step(engine, cfg, donate=False),
                       guards._copy(state), cfg.rounds)
    donated = run_rounds(dpfl.dpfl_round_step(engine, cfg),
                         guards._copy(state), cfg.rounds)
    _same_bits(plain, donated)


def test_sharded_step_refuses_a_whole_state():
    """Under a client mesh the step reads ``aux_specs``' table: a leaf it
    marks as client rows that holds every client (a state not cut by
    `shard_round_state`) raises before any work (on "meta" tensors of a
    (1, 2) `ShapeMesh` rank, as the dry run builds them)."""
    from repro_torch.launch import fl_dryrun

    step, state, _, engine, _ = fl_dryrun.build_engine_step(
        8, 4, 2, 1, 2, 1, 2)
    assert engine.n_local == 4
    assert step.shardings.aux["adj"] == 0
    whole = dict(state.aux, adj=torch.empty((8, 8), dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(ValueError, match=r"\['adj'\] has 8 clients"):
        step(RoundState(**dict(state.__dict__, aux=whole)))
    with pytest.raises(ValueError, match=r"\.flat has 8 clients"):
        step(RoundState(**dict(state.__dict__, flat=torch.empty(
            (8, engine.n_params), device="meta"))))
