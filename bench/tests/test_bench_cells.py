"""The harness on tiny CPU versions of the cells: the result line, the
reference against the port on each path, the planted faults."""
import math

import pytest
import torch

from bench import harness
from bench.tests import tiny

WORKLOADS = ("papercnn-n100.dense", "papercnn-n100.sparse-topk", "lm")


def _cell(workload):
    return tiny.lm_cell() if workload == "lm" else tiny.cell(workload)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_port(workload):
    result, lines = tiny.run(_cell(workload))
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    # the compared numbers are the last lines, in the result's order
    checks = lines[-len(result["checks"]):]
    assert [line.split(":")[0] for line in checks] == \
        [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("trace", (False, True))
def test_result_line_keys(trace):
    result, _ = tiny.run("papercnn-n100.dense", trace=trace)
    assert set(result) == KEYS | ({"breakdown"} if trace else set())
    # the checks come last
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"step_s", "setup_s"} <= set(result["metrics"])
    assert result["attempted"] > 0 and result["failed"] == 0


def _unchanged(monkeypatch):
    """The round step returns its state unchanged (its round counter
    moved on)."""
    from repro_torch.core import dpfl

    real = dpfl.dpfl_round_step

    def step_factory(engine, cfg, **kw):
        real(engine, cfg, **kw)

        def step(state):
            state.t += 1
            return state
        return step

    monkeypatch.setattr(dpfl, "dpfl_round_step", step_factory)


def _half_batch(monkeypatch):
    from bench import control
    return control.half_batch


def _altered_mix(monkeypatch):
    """One client's mixed row altered where the Eq.-4 mix produces it."""
    from repro_torch.kernels import ops

    real = ops.graph_mix

    def altered(A, W, **kw):
        out = real(A, W, **kw)
        if A.shape[0] == A.shape[1]:
            out = out.clone()
            out[0, 0] += 1.0
        return out

    monkeypatch.setattr(ops, "graph_mix", altered)


def _altered_graph(monkeypatch):
    """A client's selection altered where the refresh produces it."""
    from repro_torch.core import dpfl

    real = dpfl.all_clients_graph_sparse

    def altered(key, flat_w, p, cand_idx, *a, **kw):
        out = real(key, flat_w, p, cand_idx, *a, **kw).clone()
        # the client with the most candidates takes them all, or none
        # where it took them all
        k = int((cand_idx >= 0).sum(dim=1).argmax())
        full = torch.sort(cand_idx[k], descending=True).values
        out[k] = torch.full_like(out[k], -1) if torch.equal(
            torch.sort(out[k], descending=True).values, full) else \
            cand_idx[k]
        return out

    monkeypatch.setattr(dpfl, "all_clients_graph_sparse", altered)


def _altered_omega(monkeypatch):
    """A client's candidate set altered where the preprocessing's BGGC
    produces it (an adjacency, or neighbor lists)."""
    from repro_torch.core import dpfl

    def alter(real, lists):
        def altered(*a, **kw):
            out = real(*a, **kw).clone()
            # client 0 drops its last candidate, or takes client 1 where
            # it has none
            if lists:
                slots = [i for i, j in enumerate(out[0].tolist()) if j > 0]
                if slots:
                    out[0, slots[-1]] = -1
                else:
                    out[0, 0] = 1
            else:
                others = [j for j in torch.nonzero(out[0]).flatten()
                          .tolist() if j != 0]
                if others:
                    out[0, others[-1]] = False
                else:
                    out[0, 1] = True
            return out
        return altered

    monkeypatch.setattr(dpfl, "all_clients_bggc",
                        alter(dpfl.all_clients_bggc, False))
    monkeypatch.setattr(dpfl, "all_clients_bggc_sparse",
                        alter(dpfl.all_clients_bggc_sparse, True))


@pytest.mark.parametrize("workload,fault", [
    ("papercnn-n100.dense", _unchanged),
    ("papercnn-n100.dense", _half_batch),
    ("papercnn-n100.dense", _altered_mix),
    ("papercnn-n100.sparse-topk", _altered_graph),
    ("papercnn-n100.dense", _altered_omega),
    ("papercnn-n100.sparse-topk", _altered_omega),
    ("lm", _half_batch),
])
def test_faults_come_out_incorrect(monkeypatch, workload, fault):
    hook = fault(monkeypatch)
    result, _ = tiny.run(_cell(workload), after_engine=hook)
    assert not result["correct"], result["checks"]
    assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in result["checks"].values())


def test_control_comes_out_incorrect_on_the_card():
    """The control (TF32 on) at the dense cell's own size fails the
    check. Needs a card."""
    pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench import control
    cell = harness.load_cell("papercnn-n100.dense")
    result, _ = harness.run_cell(cell, 2 ** 31 + 11, 1.0, False, 0.0,
                                 after_engine=control.tf32)
    assert not result["correct"], result["checks"]


test_control_comes_out_incorrect_on_the_card = pytest.mark.gpu(
    test_control_comes_out_incorrect_on_the_card)
