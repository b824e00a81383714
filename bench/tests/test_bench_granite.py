"""The granite cell on the CPU: a tiny twin of
``granite-4.0-h-micro-l10-n4.dense-blocked`` (the same configuration
file, every width and the depth cut, one attention layer between two
Mamba2 layers) agrees with its float64 reference and reads ``correct``
false under planted faults of the model (a dropped
``residual_multiplier``, rotary positions turned on, a dropped conv
bias); the blocked refresh's reward calls regrouped; the yardstick's
counts by hand; the ``roofline.k5`` reader."""
import copy
import dataclasses
import json

import pytest
import torch

from bench import harness
from bench.entries import dpfl_blocked
from bench.families import granite

CELL = "granite-4.0-h-micro-l10-n4.dense-blocked"
#: the twin's limits: its sound readings on 3 seeds reach 2.4e-7 (grad),
#: 2.9e-4 (train) and 4.1e-4 (the mixes: a float32 mix of rows whose
#: change is small against them); the faults read 3.7e-3 and more
#: (grad, pre_grad)
LIMITS = {"loss": 1e-5, "grad": 1e-4, "train": 3e-3, "reward": 1e-5,
          "graph": 0, "mix": 3e-3, "eval": 0, "pre_grad": 1e-4,
          "pre_reward": 1e-5, "omega": 0, "pre_mix": 3e-3}


def tiny_config() -> dict:
    cfg = copy.deepcopy(harness.load_cell(CELL).config)
    cfg.update(hidden_size=64, intermediate_size=96,
               shared_intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, mamba_d_head=16, mamba_n_heads=8,
               mamba_d_state=16, mamba_chunk_size=8, num_hidden_layers=3,
               vocab_size=67, layer_types=["mamba", "attention", "mamba"])
    cfg["data"].update(seq_len=16)
    return cfg


def tiny_cell() -> harness.Cell:
    real = harness.load_cell(CELL)
    return dataclasses.replace(real, name="granite-tiny.dense-blocked",
                               config_name="granite-tiny",
                               config=tiny_config(), limits=dict(LIMITS))


def _run(seed=2 ** 31 + 7, **kw):
    return harness.run_cell(tiny_cell(), seed, 0.5, False, 0.0,
                            device="cpu", **kw)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7])
def test_tiny_twin_agrees_with_its_reference(seed):
    result, _ = _run(seed)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


def _cfg_fault(**kw):
    def after(engine):
        engine.model.cfg = dataclasses.replace(engine.model.cfg, **kw)
    return after


class _NoBias:
    """A Mamba2 layer whose conv bias reads as zeros."""

    def __init__(self, layer):
        self._layer = layer

    def __getattr__(self, name):
        value = getattr(self._layer, name)
        return value * 0 if name == "conv_b" else value


@pytest.mark.parametrize("fault", ["residual", "rope", "conv_bias"])
def test_planted_faults_read_not_correct(monkeypatch, fault):
    from repro_torch.models import lm

    after = None
    if fault == "residual":
        after = _cfg_fault(residual_multiplier=1.0)
    elif fault == "rope":
        after = _cfg_fault(use_rope=True)
    else:
        real = lm.mamba_mixer
        monkeypatch.setattr(lm, "mamba_mixer", lambda layer, *a, **k:
                            real(_NoBias(layer), *a, **k))
    result, _ = _run(after_engine=after)
    assert not result["correct"]
    assert result["checks"]["grad"]["value"] > LIMITS["grad"]


def test_regroup_gives_each_client_its_positions():
    """Blocks of one client, N calls each, become N calls of every
    client: call s holds each client's s-th call."""
    calls = [(torch.tensor([k]), torch.full((1, 4), 10.0 * k + s))
             for k in range(3) for s in range(3)]
    out = dpfl_blocked.regroup(calls)
    assert len(out) == 3
    for s, (k_idx, r) in enumerate(out):
        assert k_idx.tolist() == [0, 1, 2]
        assert r[:, 0].tolist() == [s, 10.0 + s, 20.0 + s]


def test_granite_counts_by_hand():
    """The cut's 772,160,448 weights a client (9 Mamba2 layers of
    76,182,976, one attention layer of 60,821,504, the embedding slice
    and the final norm), and one sequence's forward FLOPs by hand."""
    cfg = harness.load_cell(CELL).config
    assert granite.n_params(cfg) == 772_160_448 == \
        9 * 76_182_976 + 60_821_504 + 12544 * 2048 + 2048
    d, S, V, ff, d_in, n, H = 2048, 512, 12544, 8192, 4096, 128, 64
    mlp = 3 * d * ff
    mamba = d * (2 * d_in + 2 * n + H) + 4 * (d_in + 2 * n) + d_in * d + mlp
    attn = d * 2048 * 2 + d * 512 * 2 + mlp
    L, c = 256, 2
    pairs = L * (L + 1) // 2
    scan = c * pairs * 2 * n + H * (c * pairs * 2 * 64 + c * 2 * L * n * 64
                                    + (c - 1) * 2 * L * n * 64)
    fwd = 2 * S * (9 * mamba + attn + d * V) + 9 * scan \
        + 4 * 32 * 64 * S * (S + 1) // 2
    assert granite.forward_flops(cfg) == fwd


def test_plain_models_agree():
    """The benchmark's float64 model (the scan in its chunked dual form)
    and the port's plain reference (the recurrence step by step) give
    one loss on the tiny twin's weights, within 1e-12."""
    from repro_torch.configs.granite_4_0_h_micro import GraniteConfig
    from repro_torch.models import build_model, granite_ref

    cfg = tiny_config()
    model = build_model(GraniteConfig(**granite.arch(cfg)), device="meta")
    from repro_torch import prng
    params = {k: v.double() for k, v in
              model.init(prng.PRNGKey(3)).items()}
    toks = torch.randint(0, cfg["vocab_size"], (2, 17),
                         generator=torch.Generator().manual_seed(0))
    ref = granite.RefModel(cfg)
    got = ref.loss({k: v[None] for k, v in params.items()}, toks[None],
                   None)[0]
    want = granite_ref.loss(params, GraniteConfig(**granite.arch(cfg)),
                            toks)
    assert abs(float(got - want)) < 1e-12


class _Trace:
    def __init__(self, by_name):
        self.by_name = by_name


class _Run:
    def __init__(self, trace):
        self.trace = trace
        self.cell = harness.load_cell(CELL)


def test_k5_roofline_reads_the_counters_and_the_kernels():
    from bench.work import least_seconds
    from bench.work_k5 import k5_bwd_work, k5_work
    from repro_torch import obs

    reader = harness.find(harness.BENCH, "metrics", "roofline.k5")
    names = {"void ssd_chunk_kernel<64>(Params)": 0.002,
             "ssd_pass_kernel": 0.001, "ssd_output_kernel": 0.003,
             "ssd_bwd_dx_kernel": 0.004, "ssd_bwd_w_kernel": 0.002,
             "gemmSN_NN_kernel": 1.0}
    obs.reset()
    assert reader.read(_Run(_Trace(names))) is None
    with obs.tracing():
        for b in (4, 4, 8):
            obs.count("k5.seqs.l512", b)
        obs.count("k5_bwd.seqs.l512", 8)
    least = least_seconds(*k5_work(16, 512, 64, 64, 128, 256), "float32") \
        + least_seconds(*k5_bwd_work(8, 512, 64, 64, 128, 256), "float32")
    assert reader.read(_Run(_Trace(names))) == \
        pytest.approx(100.0 * least / 0.012)
    assert reader.read(_Run(_Trace({"gemm": 1.0}))) is None
    obs.reset()


def test_the_cell_reports_its_metrics():
    cell = harness.load_cell(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert {"roofline.k4", "roofline.k5", "roofline.k1", "mfu",
            "ggc_probes_per_step"} <= set(names)
    assert "k7_models_per_step" not in names
    assert cell.mix["entry"] == "dpfl_blocked" and cell.chips == 1
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = [c for c in spec["configs"]
            if c["name"] == cell.config_name][0]
    assert set(conf["reduced"]) == {"num_hidden_layers", "vocab_size",
                                    "torch_dtype"}
