"""The port's runtime guards (`repro_torch.analysis.guards`) on the CPU,
case by case against `repro`'s tests/test_guards.py where a case has a
torch meaning:

* the recompile sentinel over `kernels._build`'s build and load counts,
  driven by stand-ins for its nvcc and dlopen steps (nothing is
  compiled here): cold and warm counts, an unexpected build raises,
  ``max_new`` is an upper bound, the body's exceptions pass through;
* the donation report: a toy step, and the dense DPFL round of a small
  engine, whose lists equal `repro`'s `donation_report` of its
  `dpfl_round_step` but for the round counter;
* `run_rounds`: the flushes of `repro`'s test, the loop inside the
  fence, the mid-loop flush inside `allow_transfers`, the last one
  outside;
* the fence itself: a no-op on the CPU, which the test states and
  checks (it touches no ``torch.cuda`` call) rather than passing as if
  it had checked a fence. What the fence catches on the card is
  tests/test_torch_cuda.py's (marked ``gpu``).
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import analysis, prng  # noqa: E402
from repro_torch.analysis import guards  # noqa: E402
from repro_torch.analysis.guards import (RecompileError,  # noqa: E402
                                         allow_transfers, assert_donatable,
                                         donation_report, no_transfer,
                                         recompile_sentinel)
from repro_torch.fl import round_engine  # noqa: E402
from repro_torch.fl.round_engine import (init_round_state,  # noqa: E402
                                         run_rounds)
from repro_torch.kernels import _build  # noqa: E402


# ---- the recompile sentinel ---------------------------------------------


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """`_build` with its nvcc step writing an empty library and its
    dlopen step returning a stand-in, a fresh build directory, no
    library loaded and zero counts. Returns the names nvcc "built"."""
    built = []

    def compile_(todo):
        out = {}
        for name, path in todo.items():
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(b"")
            built.append(name)
            out[name] = (0.0, "")
        return out

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_open", lambda path: object())
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "counts",
                        {n: [0, 0] for n in _build.SOURCES})
    return built


def test_sentinel_counts_cold_and_warm_compiles(fake_build, monkeypatch):
    with recompile_sentinel(expect_new=1) as h:
        _build.load("graph_mix")
    assert (h.new_builds(), h.new_loads(), h.new_compiles()) == (1, 1, 1)
    assert h.compiled_names() == ["graph_mix"] == fake_build
    with recompile_sentinel(expect_new=0) as h:
        for _ in range(4):
            _build.load("graph_mix")
    assert h.new_compiles() == 0
    # a new process finds the library on disk: a load, no build
    monkeypatch.setattr(_build, "_LIBS", {})
    with recompile_sentinel(["graph_mix"], expect_new=1) as h:
        _build.load("graph_mix")
    assert (h.new_builds(), h.new_loads()) == (0, 1)
    assert fake_build == ["graph_mix"]


def test_sentinel_raises_on_unexpected_recompile(fake_build):
    _build.load("graph_mix")
    with pytest.raises(RecompileError, match="expected exactly 0"):
        with recompile_sentinel(expect_new=0):
            _build.load("ssd")   # a kernel's first use: a fresh build


def test_sentinel_watches_only_its_names(fake_build):
    with recompile_sentinel(["graph_mix"], expect_new=0) as h:
        _build.load("ssd")
    assert h.compiled_names() == []
    assert _build.counts["ssd"] == [1, 1]


def test_sentinel_max_new_is_an_upper_bound(fake_build):
    with recompile_sentinel(max_new=2):
        _build.load("graph_mix")
        _build.build(["ssd"])    # built, not loaded: counts once
    with pytest.raises(RecompileError, match="at most 1"):
        with recompile_sentinel(max_new=1):
            _build.load("rglru_scan")
            _build.load("flash_attention")


def test_sentinel_does_not_mask_body_exceptions(fake_build):
    with pytest.raises(ValueError, match="boom"):
        with recompile_sentinel(expect_new=1):
            raise ValueError("boom")  # no RecompileError on top


# ---- the donation report ------------------------------------------------


def test_donation_report_splits_donatable_and_blocked():
    def step(s):
        return {"a": s["a"] + 1, "b": s["b"].to(torch.int32),
                "c": s["c"].add_(1)}

    s = {"a": torch.ones((3, 3)), "b": torch.zeros(()),
         "c": torch.zeros(2)}
    rep = donation_report(step, s)
    assert rep["donatable"] == ["['a']", "['c']"]
    assert rep["blocked"] == ["['b']"]
    assert rep["in_place"] == ["['c']"]   # kept its storage
    assert rep["donatable_bytes"] == 3 * 3 * 4 + 2 * 4
    # the report ran the step on a copy
    assert torch.equal(s["c"], torch.zeros(2))
    with pytest.raises(AssertionError, match="not donatable"):
        assert_donatable(step, s)


DPFL_KW = dict(rounds=2, tau_init=1, tau_train=1, budget=3, seed=0)


def test_dpfl_round_donation_equals_repro():
    """The dense DPFL round of the small MLP engine: every leaf keeps its
    path, shape and dtype (nothing blocked), as `repro` finds by
    ``eval_shape`` of its jitted round. The lists are `repro`'s less
    ``.t``: `repro`'s round counter is an int32 array leaf, the port's a
    host int, which is no tensor and so no leaf. The round donates, as
    `repro`'s does: every donatable leaf keeps its storage."""
    from repro.analysis.guards import donation_report as jdonation
    from repro.core import DPFLConfig as JConfig
    from repro.core.dpfl import abstract_round_state, \
        dpfl_round_step as jstep
    from repro_torch.core.dpfl import (DPFLConfig, dpfl_initial_state,
                                       dpfl_round_step)

    je, te = common.make_engines("mlp")
    jrep = jdonation(jstep(je, JConfig(**DPFL_KW)),
                     abstract_round_state(je, JConfig(**DPFL_KW)))
    cfg = DPFLConfig(**DPFL_KW)
    state, _ = dpfl_initial_state(te, cfg)
    rep = donation_report(dpfl_round_step(te, cfg), state)
    assert ".t" in jrep["donatable"]
    assert rep["donatable"] == [p for p in jrep["donatable"] if p != ".t"]
    assert rep["blocked"] == jrep["blocked"] == []
    # written in place or passed through: the counters, the histories,
    # Omega and the keys, and (donated) the mixed panel, the graph and
    # the best models
    assert {".aux['comm']", ".aux['graph_hist']", ".val_hist",
            ".aux['omega']", ".key", ".flat", ".best_flat",
            ".aux['adj']"} <= set(rep["in_place"])
    assert rep["in_place"] == rep["donatable"]
    assert rep["donatable_bytes"] == sum(
        t.numel() * t.element_size() for t in guards._leaves(state).values())


# ---- run_rounds ---------------------------------------------------------


def test_run_rounds_is_guarded_and_flushes_through_the_fence(monkeypatch):
    """`repro`'s case: the flushes at (2, 2), (4, 2), (5, 1). Stand-ins for
    the two guards record where each round and flush ran: the rounds
    and the mid-loop flushes inside the fence, those flushes inside an
    `allow_transfers` hole, the last flush outside the fence."""
    where = []
    depth = {"fence": 0, "hole": 0}

    def tracker(kind):
        @contextlib.contextmanager
        def cm(*args):
            depth[kind] += 1
            try:
                yield
            finally:
                depth[kind] -= 1
        return cm

    monkeypatch.setattr(round_engine, "no_transfer", tracker("fence"))
    monkeypatch.setattr(round_engine, "allow_transfers", tracker("hole"))

    def bump(s):
        where.append(("round", depth["fence"], depth["hole"]))
        return dataclasses.replace(s, t=s.t + 1)

    pulls = []

    def flush(s, n):
        where.append(("flush", depth["fence"], depth["hole"]))
        pulls.append((s.t, n))

    with recompile_sentinel(expect_new=0):
        out = run_rounds(bump, init_round_state(torch.ones((2, 3)),
                                                prng.PRNGKey(0)),
                         5, on_flush=flush, flush_every=2)
    assert out.t == 5
    assert pulls == [(2, 2), (4, 2), (5, 1)]
    assert where == [("round", 1, 0)] * 2 + [("flush", 1, 1)] + \
        [("round", 1, 0)] * 2 + [("flush", 1, 1)] + [("round", 1, 0)] + \
        [("flush", 0, 0)]


# ---- the fence ----------------------------------------------------------


def test_fence_is_a_no_op_on_the_cpu(monkeypatch):
    """On the CPU `no_transfer` and `allow_transfers` do nothing: no
    device exists to wait for, and this build of torch has no sync-debug
    mode to set. This test checks that they call nothing of
    ``torch.cuda`` and that host reads pass; it checks no fence. The
    fence is checked on the card (tests/test_torch_cuda.py)."""
    def refuse(*args, **kw):
        raise AssertionError("the CPU path touched torch.cuda")

    for name in ("get_sync_debug_mode", "set_sync_debug_mode",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    x = torch.arange(4.0)
    with no_transfer("cpu"):
        assert guards._depth == 0       # no fence was raised
        assert x.sum().item() == 6.0
        assert np.asarray(x.cpu()).sum() == 6.0
        with allow_transfers():
            assert x[0].item() == 0.0
    with allow_transfers():             # outside any fence: a no-op too
        pass


def test_fence_sets_and_restores_the_sync_debug_mode(monkeypatch):
    """The bookkeeping of the CUDA path, with torch.cuda's two mode calls
    stubbed (no card here): ``no_transfer`` sets "error" and restores the
    previous mode; ``allow_transfers`` lifts it to 0 inside and restores
    "error"; nested fences restore in order."""
    mode = {"now": 0}
    calls = []

    def get():
        return mode["now"]

    def set_(m):
        calls.append(m)
        mode["now"] = 2 if m == "error" else m

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_)
    with no_transfer("cuda"):
        assert mode["now"] == 2 and guards._depth == 1
        with allow_transfers():
            assert mode["now"] == 0
            with no_transfer(torch.device("cuda", 0)):
                assert mode["now"] == 2 and guards._depth == 2
            assert mode["now"] == 0
        assert mode["now"] == 2
    assert mode["now"] == 0 and guards._depth == 0
    assert calls == ["error", 0, "error", 0, 2, 0]


def test_fence_restores_the_mode_when_the_body_raises(monkeypatch):
    mode = {"now": 1}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(
                            "now", 2 if m == "error" else m))
    with pytest.raises(RuntimeError, match="sync"):
        with no_transfer("cuda"):
            raise RuntimeError("called a synchronizing CUDA operation")
    assert mode["now"] == 1 and guards._depth == 0


# ---- the package's surface ----------------------------------------------


def test_analysis_exports_and_one_fence():
    for name in ("no_transfer", "allow_transfers", "recompile_sentinel",
                 "RecompileError", "TransferError", "donation_report",
                 "commaudit", "exchange_site", "EXCHANGE_SITES",
                 "ExchangeSite"):
        assert getattr(analysis, name) is not None, name
    assert analysis.no_transfer is guards.no_transfer
    assert issubclass(analysis.TransferError, RuntimeError)
    assert issubclass(analysis.RecompileError, AssertionError)
    # one implementation: the round engine's own fence is gone
    assert not hasattr(round_engine, "no_sync")
