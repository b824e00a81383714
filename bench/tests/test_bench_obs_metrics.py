"""The metrics read from the program's own spans and counters
(`repro_torch.obs`): a traced tiny CPU cell reads all three, the
greedy's two counters at their hand counts from the run's Omega; an
untraced run keeps nothing to read."""
import pytest
import torch

from bench.tests import tiny

NEW = ("ggc_probes_per_step", "ggc_useful_share", "local_train_host_ms")


@pytest.fixture
def omega(monkeypatch):
    """The Omega the run's preprocessing built (dense: fixed after it)."""
    from repro_torch.core import dpfl

    seen = {}
    real = dpfl.dpfl_initial_state

    def initial(engine, cfg):
        state, result = real(engine, cfg)
        seen["omega"] = state.aux["omega"].clone()
        return state, result

    monkeypatch.setattr(dpfl, "dpfl_initial_state", initial)
    return seen


def test_traced_cell_reads_the_programs_counters(omega):
    from repro_torch import obs

    obs.reset()
    cell = tiny.cell("papercnn-n100.dense")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    result, _ = tiny.run(cell, trace=True)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    N = cell.config["clients"]
    # 4 probe models a client at each of the dense scan's N positions
    assert m["ggc_probes_per_step"] == 4 * N * N
    pairs = int((omega["omega"] & ~torch.eye(N, dtype=torch.bool)).sum())
    assert 0 < pairs <= N * cell.config["dpfl"]["budget"]
    assert m["ggc_useful_share"] == pytest.approx(100.0 * pairs / (N * N))
    assert m["local_train_host_ms"] > 0
    obs.reset()


def test_untraced_run_keeps_nothing(omega):
    from repro_torch import obs

    obs.reset()
    result, _ = tiny.run("papercnn-n100.dense", trace=False)
    assert result["correct"], result["checks"]
    assert obs.snapshot() == {"records": [], "counts": {}, "tallies": {}}
