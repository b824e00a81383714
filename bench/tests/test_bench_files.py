"""The harness finds cells and metrics by name in files of their own; the
FLOP counts against hand counts; BENCHMARK.json within the contract's
limits; nothing the benchmark imports is JAX or the JAX package."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness
from bench.families import lm, papercnn
from bench.tests import tiny

ROOT = harness.ROOT
BENCH = harness.BENCH


def test_added_cell_and_metric_are_found(tmp_path):
    """A cell and a per-layer metric added as files and entries are run
    and read, with no edit to a file that is there."""
    shutil.copytree(BENCH, tmp_path / "bench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench" / "mixes" / "dense-twice.json").write_text(
        json.dumps({"entry": "dpfl", "dpfl": {"graph_repr": "dense",
                                              "mix_rule": "weighted"}}))
    cfg = tiny.config("papercnn-n100")
    (tmp_path / "bench" / "configs" / "papercnn-tiny.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench" / "limits" / "papercnn-tiny.dense-twice.json") \
        .write_text((BENCH / "limits" / "papercnn-n100.dense.json")
                    .read_text())
    (tmp_path / "bench" / "metrics" / "rounds_seen.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    spec["configs"].append({"name": "papercnn-tiny", "source": "x",
                            "file": "bench/configs/papercnn-tiny.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "papercnn-tiny.dense-twice",
                              "config": "papercnn-tiny",
                              "traffic": "dense-twice", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "step_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("papercnn-tiny.dense-twice", tmp_path)
    assert cell.config == cfg and cell.mix["dpfl"]["graph_repr"] == "dense"
    assert "rounds_seen" in [m["name"] for m in cell.per_layer]
    # metrics listed for other cells only are not this cell's
    assert "roofline.k1" not in [m["name"] for m in cell.per_layer]
    result, _ = harness.run_cell(cell, 5, 0.3, True, 0.0, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["rounds_seen"]["value"] == \
        result["attempted"]
    # the check reads the rule the mix names from the folder's own file:
    # a rule that does not mix fails it
    (tmp_path / "bench" / "rules" / "weighted.py").write_text(
        "def mix(trained, recv, graph, p, sparse, rows, **_):\n"
        "    return trained[rows]\n")
    result, _ = harness.run_cell(cell, 5, 0.3, False, 0.0, device="cpu")
    assert not result["correct"]
    assert result["checks"]["mix"]["value"] > \
        result["checks"]["mix"]["limit"]


def test_papercnn_flops_by_hand():
    m = tiny.harness.load_cell("papercnn-n100.dense").config["model"]
    conv1 = 28 * 28 * 6 * (5 * 5 * 3)        # multiply-adds an image
    conv2 = 10 * 10 * 16 * (5 * 5 * 6)
    dense = 400 * 120 + 120 * 84 + 84 * 10
    fwd = 2 * (conv1 + conv2 + dense)
    assert papercnn.forward_flops(m) == fwd == 1_303_440
    # backward: weight gradients of every layer, input gradients of all
    # but the first
    assert papercnn.train_flops(m) == 3 * fwd - 2 * conv1 == 3_204_720
    assert papercnn.n_params(m) == 62_006


def test_qwen3_layer_flops_by_hand():
    """Qwen3-0.6B's published widths, 2 layers, 32-token sequences."""
    cfg = {"model": dict(tiny.LM["model"], hidden_size=1024,
                         intermediate_size=3072, num_attention_heads=16,
                         num_key_value_heads=8, head_dim=128,
                         vocab_size=151936),
           "data": dict(tiny.LM["data"], seq_len=32)}
    d, S, V = 1024, 32, 151_936
    q_o = 2 * d * 16 * 128                   # wq and wo, multiply-adds
    k_v = 2 * d * 8 * 128                    # wk and wv
    mlp = 3 * d * 3072
    attn = 4 * 16 * 128 * (S * (S + 1) // 2)  # QK and PV over causal pairs
    layer = 2 * (q_o + k_v + mlp) * S + attn
    head = 2 * d * V * S
    assert lm.forward_flops(cfg) == 2 * layer + head
    assert lm.n_params(cfg) == 187_045_376


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_within_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200
    ends = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in ends
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in ends and "\n" not in m["layer"]
    for text in [c["why"] for c in spec["configs"]] + \
            [c["source"] for c in spec["configs"]] + \
            [m["layer"] for m in spec["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and \
            "\t" not in text


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_jax_in_the_benchmark_sources():
    """No file under bench/ imports JAX or the JAX package (top-level names
    compared whole: the port's name begins with the JAX package's)."""
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)


def test_no_jax_loaded_by_a_run():
    """A tiny CPU run loads neither JAX nor the JAX package."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench.tests import tiny\n"
            "tiny.run('papercnn-n100.sparse-topk')\n"
            "from bench import harness\n"
            "print(harness.forbidden_modules())\n") % (
        str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_card(tmp_path):
    """Without the cards the cell asks for, no result and a non-zero
    exit; the same where the program is missing."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "papercnn-n100.dense", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    alone = tmp_path / "alone"
    shutil.copytree(BENCH, alone / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    out = subprocess.run(
        [sys.executable, str(alone / "bench" / "run.py"), "--workload",
         "papercnn-n100.dense", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=alone)
    assert out.returncode != 0 and not out.stdout.strip()


def test_topk_ties_take_the_programs_choice():
    """Magnitudes tied at the k-th largest: either is a top-k, and the
    reference follows the program's pick; a kept set that is no top-k is
    flagged."""
    import torch

    from bench.codecs.topk import topk_exchange

    flat = torch.tensor([[4.0, -2.0, 2.0, 1.0, 0.5]])
    ef = torch.zeros_like(flat)
    # k = ceil(0.4 * 5) = 2: 4.0, then one of the two 2.0s
    for pick in (1, 2):
        dec = torch.zeros_like(flat)
        dec[0, [0, pick]] = flat[0, [0, pick]]
        x, got, res, bad = topk_exchange(flat, ef, 0.4, flat - dec)
        assert not bad.any() and torch.equal(got, dec)
        assert torch.equal(res, flat - dec)
    wrong = flat.clone()
    wrong[0, [0, 3]] = 0.0                   # kept 4.0 and 1.0
    *_, bad = topk_exchange(flat, ef, 0.4, wrong)
    assert bad.all()


class _Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, device, start, dur, corr):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_reduction():
    """Operations are charged to the range open at their launch (their
    runtime call's correlation id), a layer's time is the union of its
    operations' intervals, the ranges' device mirrors are no operations,
    and idle gaps are labelled by the range open at the gap."""
    from bench.trace import reduce

    ev = [
        _Event("bench::local_train", False, 0, 100, 1),
        _Event("cudaLaunchKernel", False, 10, 1, 7),
        _Event("cudaLaunchKernel", False, 20, 1, 8),
        _Event("bench::greedy", False, 200, 100, 2),
        _Event("cudaLaunchKernel", False, 210, 1, 9),
        _Event("bench::greedy", True, 200, 500, 3),      # a mirror
        _Event("gemm", True, 30, 40, 7),                 # 30-70
        _Event("gemm", True, 50, 40, 8),                 # 50-90, overlaps
        _Event("conv", True, 250, 50, 9),                # 250-300
    ]
    tr = reduce(ev, window_s=1e-6, rounds=1)
    assert tr.kernels == tr.device_ops == 3 and tr.unattributed == 0
    assert tr.layer_s == {"local_train": 60e-9, "greedy": 50e-9}
    assert tr.busy_s == pytest.approx(110e-9)
    assert tr.by_name == {"gemm": 80e-9, "conv": 50e-9}
    # the gap 90-250: the device went idle while the local train's range
    # was still open on the host (it closed at 100)
    assert tr.idle_by_layer == {"local_train": 160e-9}
