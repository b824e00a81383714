"""The port's spans and counters (`repro_torch.obs`) on tiny CPU rounds.

* Off: no records, counts or tallies, no profiler range opened, and the
  round's outputs bit for bit those of a round traced with `obs` on.
* Under a CPU ``torch.profiler`` profile, a dense round and a sparse
  round give the layer spans nested as the round nests them, every
  record carrying the round's ``t``; each record starts where its
  ``repro::`` range starts in the same trace (one clock).
* The greedy's counters at their hand counts: 4·N·N probe models a
  dense refresh, 4·N·B a sparse one, and 4·Σ|Ω_k∖{k}| at a candidate,
  from the state's Omega.
* A collective's region is the refresh's wherever the refresh span is
  open on the stack, and no other span tags it.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import commaudit
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import dpfl
from repro_torch.data import make_federated_classification
from repro_torch.fl.engine import FLEngine
from repro_torch.fl.round_engine import _map_leaves
from repro_torch.models.classifier import PaperCNN
from repro_torch.sharding import collectives as coll

N, BUDGET, TRAIN, BATCH = 6, 3, 20, 10
REPRS = ("dense", "sparse")

_SETUPS = {}


def _setup(graph_repr):
    """(engine, cfg, round-start state) of a tiny PaperCNN DPFL run."""
    if graph_repr not in _SETUPS:
        data = make_federated_classification(
            seed=3, n_clients=N, n_clusters=2, partition="pathological",
            n_train=TRAIN, n_val=8, n_test=8, image_shape=(16, 16, 3))
        engine = FLEngine(PaperCNN(CNNConfig(image_size=16)), data,
                          lr=0.01, batch_size=BATCH, device="cpu")
        cfg = dpfl.DPFLConfig(rounds=3, tau_init=1, tau_train=1,
                              budget=BUDGET, graph_repr=graph_repr)
        state, _ = dpfl.dpfl_initial_state(engine, cfg)
        _SETUPS[graph_repr] = engine, cfg, state
    engine, cfg, state = _SETUPS[graph_repr]
    # the round donates its input: each caller gets a copy of its own
    return engine, cfg, _map_leaves(torch.clone, state)


def _round(graph_repr, rounds=1):
    engine, cfg, state = _setup(graph_repr)
    step = dpfl.dpfl_round_step(engine, cfg)
    for _ in range(rounds):
        state = step(state)
    return state


def _profiled_round(graph_repr):
    """One round under a CPU profile: (snapshot, the profile, the
    round-start state)."""
    start = _setup(graph_repr)[2]
    obs.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert obs.active()
        _round(graph_repr)
    assert not obs.active()
    snap = obs.snapshot()
    obs.reset()
    return snap, prof, start


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    obs.disable()
    yield
    obs.reset()
    obs.disable()


def _same(a, b):
    la, lb = [], []
    _map_leaves(la.append, a)
    _map_leaves(lb.append, b)
    assert len(la) == len(lb) and a.t == b.t
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("graph_repr", REPRS)
def test_off_keeps_nothing_and_on_changes_no_bit(graph_repr, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} with obs off")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", no_range)
        off = _round(graph_repr, rounds=2)
    assert obs.snapshot() == {"records": [], "counts": {}, "tallies": {}}
    assert obs.stack() == ()
    with obs.tracing():
        on = _round(graph_repr, rounds=2)
    assert not obs.active()
    snap = obs.snapshot()
    assert snap["counts"]["rounds"] == 2 and snap["records"]
    _same(off, on)


def _ancestors(rec, by_id):
    out = []
    while rec.parent is not None:
        rec = by_id[rec.parent]
        out.append(rec.name)
    return out


@pytest.mark.parametrize("graph_repr", REPRS)
def test_spans_nest_as_the_round(graph_repr):
    snap, _, start = _profiled_round(graph_repr)
    recs = snap["records"]
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert {"round", "local_train", "local_train.gather",
            "local_train.loss_grad", "local_train.update", "aggregate",
            "refresh", "ggc.init", "ggc.position", "reward", "mix",
            "eval"} <= names
    # no codec in these rounds; K1, K2 and K4 launch on a card only
    assert not names & {"codec", "k1", "k2", "k4", "k4_bwd"}
    assert [r.name for r in recs if r.parent is None] == ["round"]
    assert all(r.t == start.t for r in recs)
    chains = {r.name: _ancestors(r, by_id) for r in recs}
    assert chains["local_train"] == ["round"]
    assert chains["local_train.loss_grad"] == ["local_train", "round"]
    assert chains["local_train.update"] == ["local_train", "round"]
    assert chains["local_train.gather"] == ["local_train", "round"]
    assert chains["refresh"] == ["aggregate", "round"]
    assert chains["ggc.init"] == ["refresh", "aggregate", "round"]
    assert chains["ggc.position"] == ["refresh", "aggregate", "round"]
    assert chains["reward"][:2] == ["ggc.position", "refresh"]
    assert chains["mix"] == ["aggregate", "round"]
    assert chains["eval"] == ["round"]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    steps = (TRAIN // BATCH) * 1
    assert snap["counts"]["rounds"] == 1
    assert snap["counts"]["local_train.steps"] == steps
    assert sum(r.name == "local_train.loss_grad" for r in recs) == steps
    assert sum(r.name == "local_train.gather" for r in recs) == 1


@pytest.mark.parametrize("graph_repr", REPRS)
def test_greedy_counters_at_their_hand_counts(graph_repr):
    snap, _, start = _profiled_round(graph_repr)
    if graph_repr == "dense":
        omega = start.aux["omega"] & ~torch.eye(N, dtype=torch.bool)
        positions = N
    else:
        omega = start.aux["omega_nbr"] >= 0
        positions = start.aux["omega_nbr"].shape[1]
        assert positions == BUDGET
    assert snap["counts"]["ggc.probe_models"] == 4 * N * positions
    assert sum(r.name == "ggc.position" for r in snap["records"]) == \
        positions
    assert sum(r.name == "reward" for r in snap["records"]) == positions
    assert 0 < int(omega.sum()) < N * positions
    assert snap["tallies"] == {
        "ggc.candidate_probe_models": 4 * int(omega.sum())}


@pytest.mark.parametrize("graph_repr", REPRS)
def test_records_share_the_profilers_clock(graph_repr):
    snap, prof, _ = _profiled_round(graph_repr)
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(obs.PREFIX):
            ranges.setdefault(ev.name()[len(obs.PREFIX):], []).append(
                ev.start_ns())
    recs = {}
    for r in snap["records"]:
        recs.setdefault(r.name, []).append(r.start_ns)
    assert set(ranges) == set(recs)
    for name, starts in recs.items():
        assert len(starts) == len(ranges[name]), name
        for mine, theirs in zip(sorted(starts), sorted(ranges[name])):
            assert abs(mine - theirs) < 1_000_000, name


def test_obs_api():
    assert not obs.active()
    with obs.span("a"):
        with obs.span("b"):
            assert obs.stack() == ("a", "b")
            obs.count("n")
    assert obs.stack() == ()
    assert obs.snapshot() == {"records": [], "counts": {}, "tallies": {}}
    with pytest.raises(KeyError):
        with obs.span("c"):
            raise KeyError
    assert obs.stack() == ()
    obs.enable()
    with obs.span("round", t=7):
        with obs.span("x"):
            obs.count("n", 3)
            obs.count("n")
            obs.tally("m", torch.tensor(2), n=4)
            obs.tally("m", torch.tensor(1))
    with obs.span("y"):
        pass
    obs.disable()
    obs.count("n")
    snap = obs.snapshot()
    x, rnd, y = snap["records"]
    assert (x.name, x.parent, x.t) == ("x", rnd.id, 7)
    assert (rnd.name, rnd.parent, rnd.t) == ("round", None, 7)
    assert (y.name, y.parent, y.t) == ("y", None, None)
    assert len({x.id, rnd.id, y.id}) == 3
    assert snap["counts"] == {"n": 4} and snap["tallies"] == {"m": 9}
    with obs.tracing():
        assert obs.active()
    assert not obs.active()
    obs.reset()
    assert obs.snapshot() == {"records": [], "counts": {}, "tallies": {}}


def test_a_collectives_region_is_the_refresh_span():
    assert commaudit.REFRESH in coll.TAGS
    mesh = coll.ShapeMesh((2,), ("data",))
    x = torch.empty((3, 4), device="meta")

    def region():
        with coll.recording() as recs:
            coll.all_gather_rows(x, mesh, ("data",))
        return recs[0].region

    assert region() is None
    with obs.span(commaudit.REFRESH):
        assert region() == commaudit.REFRESH
        with obs.span("ggc.init"), obs.span("k1"):
            assert region() == commaudit.REFRESH
    with obs.span("mix"):
        assert region() is None


@pytest.mark.gpu
def test_kernel_span_on_the_card():
    """K1's launch lies inside its span (the kernels launch on a card
    only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops

    A = torch.rand((4, 4), device="cuda")
    W = torch.rand((4, 64), device="cuda")
    with obs.tracing():
        ops.graph_mix(A, W)
    torch.cuda.synchronize()
    assert [r.name for r in obs.snapshot()["records"]] == ["k1"]
