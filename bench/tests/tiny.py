"""Tiny CPU versions of the benchmark's cells, for the tests."""
import copy
import json
from pathlib import Path

from bench import harness

BENCH = Path(harness.__file__).resolve().parent

#: DPFL over decoder-LM clients (the `lm` family) at toy widths, with the
#: check's limits of its last chip proof (qwen3-0.6b's widths, 2 layers,
#: 4 clients; PERF.md): no cell runs the family now
LM = {
    "name": "lm-tiny", "family": "lm",
    "model": {"num_hidden_layers": 2, "hidden_size": 64,
              "intermediate_size": 128, "num_attention_heads": 2,
              "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 256,
              "tie_word_embeddings": True, "rope_theta": 1000000,
              "rms_norm_eps": 1e-06, "torch_dtype": "float32"},
    "dtype": "float32", "clients": 4,
    "data": {"vocab": 256, "seq_len": 8, "n_seqs": 48, "n_clusters": 2,
             "split": [24, 36]},
    "train": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.001,
              "batch_size": 8},
    "dpfl": {"tau_init": 2, "tau_train": 2, "budget": 3,
             "refresh_period": 1},
    "rounds_cap": 100000}
LM_LIMITS = {"loss": 1.2e-05, "grad": 0.0001, "train": 0.00015,
             "reward": 1e-06, "graph": 0, "mix": 0.01, "eval": 0}
LM_LIMITS.update({"pre_" + k: LM_LIMITS[k] for k in
                  ("grad", "reward", "mix")}, omega=0)


def config(name: str) -> dict:
    """The configuration ``name`` cut to a size the CPU runs in seconds."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["clients"] = 8
    cfg["model"]["image_size"] = 16
    cfg["data"].update(n_train=20, n_val=8, n_test=8,
                       image_shape=[16, 16, 3])
    cfg["train"]["batch_size"] = 10
    cfg["dpfl"].update(tau_init=1, tau_train=1, budget=3)
    return cfg


#: the sparse top-k mix's limits of its last chip proof (PERF.md): no
#: cell runs the mix now
SPARSE_LIMITS = {"loss": 0.03, "grad": 0.0012, "train": 0.03,
                 "reward": 0.0001, "graph": 0, "mix": 1e-05, "eval": 0,
                 "pre_grad": 0.0012, "pre_reward": 0.0001, "omega": 0,
                 "pre_mix": 1e-05}


def cell(workload: str) -> harness.Cell:
    """The cell ``workload`` (``<config>.<mix>``) with its configuration
    cut: the benchmark's own, or its configuration on another mix of
    `bench/mixes/`, with the dense cell's metrics."""
    try:
        real = harness.load_cell(workload)
    except SystemExit:
        real = harness.load_cell("papercnn-n100.dense")
        mix = workload.split(".", 1)[1]
        real.mix_name = mix
        real.mix = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
        real.limits = dict(SPARSE_LIMITS)
    return harness.Cell(
        name=workload, config_name=real.config_name,
        config=config(real.config_name), mix_name=real.mix_name,
        mix=real.mix, chips=real.chips, end_to_end=real.end_to_end,
        per_layer=real.per_layer, limits=real.limits)


def lm_cell() -> harness.Cell:
    """LM clients on the dense mix, with the dense cell's metrics."""
    real = harness.load_cell("papercnn-n100.dense")
    return harness.Cell(
        name="lm-tiny.dense", config_name="lm-tiny", config=copy.deepcopy(LM),
        mix_name="dense", mix=real.mix, chips=1, end_to_end=real.end_to_end,
        per_layer=real.per_layer, limits=dict(LM_LIMITS))


def run(workload, seed: int = 2 ** 31 + 7, trace: bool = False, **kw):
    """One tiny CPU run of the cell ``workload`` (a name, or a `Cell`)."""
    c = workload if isinstance(workload, harness.Cell) else cell(workload)
    return harness.run_cell(c, seed, 0.5, trace, 0.0, device="cpu", **kw)
