"""Run the JAX reference on the configurations that ``chip_smoke.py``
drives through the port, on the CPU, and print the accuracies (and, for
DPFL, the comm counters) of each as one JSON line.

``chip_smoke.py``'s learning checks take their thresholds from these runs,
and its card-against-JAX train check its losses:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_reference_smoke.py \
        [dense] [sparse] [topk] [sparse-topk] [dense-markov] \
        [sparse-freerider-clipped] [topk-signflip-clipped] \
        [dense-labelflip-trimmed] [local] [fedavg] ... [pfedgraph] \
        [fedavg-markov-topk] [train-cross] [train-cross-ssm] \
        [train-cross-hybrid] [train-cross-vlm] [train-cross-moe] \
        [train-cross-audio] [train-cross-bf16]

(no names: all twenty-seven). The data and run settings (PaperCNN at its
published width, 32 clients, 3 rounds) are the ones in ``chip_smoke.py``'s
``SMOKE_*`` constants. A DPFL variant is one of its ``VARIANTS``, run by
`repro.core.dpfl.run_dpfl`; a baseline run is one of its
``BASELINE_RUNS``, run by `repro.fl.baselines.run_baseline` at
``BASELINE_RUN``. Both are built here with `repro`'s config classes.
The "train-cross*" names are the runs of ``CROSS_TRAINS``:
`repro.launch.train`'s loop (the same corpus, batches, AdamW and
schedule, a vlm's batches with zero vision embeddings, an audio model's
with zero frames) on qwen3-0.6b, mamba2-370m and internvl2-2b at full
width cut to their first two layers, whisper-medium at full width cut to
two encoder and two decoder layers, and on recurrentgemma-9b's and
qwen3-moe-30b-a3b's reduced configs, for ``CROSS_TRAIN_JAX_LOSSES``
(about 40 s and 3 GiB for qwen3), in float32, and "train-cross-bf16":
qwen3-0.6b's cut run at the config's bf16, `repro`'s default dtype.
"""
from __future__ import annotations

import json
import resource
import sys
import time

# jax 0.9's PrimitiveBatchersProxy has no __contains__, which
# repro.sharding.compat needs at import; the test suite carries the same
# patch (tests/test_torch_common.py)
from jax.interpreters import batching

if not hasattr(type(batching.primitive_batchers), "__contains__"):
    type(batching.primitive_batchers).__contains__ = \
        lambda self, p: p in batching.fancy_primitive_batchers

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs.paper_cnn import CNNConfig  # noqa: E402
from repro.core import (AdversaryConfig, CompressionConfig,  # noqa: E402
                        DPFLConfig, ParticipationConfig, run_dpfl)
from repro.data import make_federated_classification  # noqa: E402
from repro.fl.adversary import segregation_history  # noqa: E402
from repro.fl.baselines import run_baseline  # noqa: E402
from repro.fl.engine import FLEngine  # noqa: E402
from repro.models.classifier import PaperCNN  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the constants only; imports no port code)


def config(name):
    """`repro`'s DPFLConfig of chip_smoke.py's variant ``name``."""
    spec = dict(chip_smoke.VARIANTS[name])
    codec = spec.pop("codec", None)
    if codec:
        spec["compression"] = CompressionConfig(
            codec, topk_frac=chip_smoke.TOPK_FRAC)
    if "participation" in spec:
        spec["participation"] = ParticipationConfig(**spec["participation"])
    if "adversary" in spec:
        spec["adversary"] = AdversaryConfig(**spec["adversary"])
    return DPFLConfig(**chip_smoke.SMOKE_RUN, **spec)


def main():
    names = sys.argv[1:] or (list(chip_smoke.VARIANTS)
                             + list(chip_smoke.BASELINE_RUNS)
                             + list(chip_smoke.CROSS_TRAINS))
    engine = None
    for name in names:
        if name in chip_smoke.CROSS_TRAINS:
            run_train_cross(name)
            continue
        if engine is None:
            data = make_federated_classification(**chip_smoke.SMOKE_DATA)
            engine = FLEngine(PaperCNN(CNNConfig()), data,
                              lr=chip_smoke.SMOKE_LR,
                              batch_size=chip_smoke.SMOKE_BATCH)
        if name in chip_smoke.BASELINE_RUNS:
            run_baseline_one(engine, name)
        else:
            run_one(engine, name)


def run_train_cross(name):
    """`repro.launch.train.main`'s loop on chip_smoke.CROSS_TRAINS[name]'s
    cut config: the init of PRNGKey(0), loss_chunks 4, the same corpus
    and batches, ``adamw(warmup_cosine(lr, 10, steps))``, the jitted
    step."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data import make_lm_token_data
    from repro.launch.steps import make_train_step
    from repro.models import build_model
    from repro.optim import adamw, warmup_cosine

    c = chip_smoke.CROSS_TRAINS[name]
    t0 = time.perf_counter()
    cfg = get_config(c["arch"])
    if c.get("reduced"):
        cfg = cfg.reduced()
    cfg = cfg.replace(**{k: c[k] for k in ("n_layers", "n_enc_layers")
                         if k in c})
    cfg = cfg.replace(dtype=c.get("dtype", "float32"))
    model = build_model(cfg, loss_chunks=4)
    params = model.init(jax.random.PRNGKey(0))
    tokens, _ = make_lm_token_data(
        seed=0, n_clients=1, vocab=min(cfg.vocab_size, 4096),
        seq_len=c["seq"], n_seqs=max(c["batch"] * 8, 64))
    corpus = jnp.asarray(tokens[0])
    optimizer = adamw(warmup_cosine(c["lr"], 10, c["steps"]))
    opt_state = optimizer.init(params)
    step_fn = jax.jit(make_train_step(model, optimizer))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(c["steps"]):
        idx = rng.integers(0, corpus.shape[0], c["batch"])
        batch = {"tokens": corpus[idx]}
        if cfg.family == "vlm":
            batch["vision"] = jnp.zeros(
                (c["batch"], cfg.n_vision_tokens, cfg.d_model))
        if cfg.family == "audio":
            batch["frames"] = jnp.zeros(
                (c["batch"], cfg.n_audio_frames, cfg.d_model))
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
    print(json.dumps({
        "train": name, "config": c, "losses": losses,
        "n_params": int(sum(x.size for x in jax.tree.leaves(params))),
        "seconds": time.perf_counter() - t0,
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1024,
    }), flush=True)


def run_baseline_one(engine, name):
    method, part, codec = chip_smoke.BASELINE_RUNS[name]
    kw = dict(chip_smoke.BASELINE_RUN)
    if part is not None:
        kw["participation"] = ParticipationConfig(**part)
    if codec is not None:
        kw["compression"] = CompressionConfig(
            codec, topk_frac=chip_smoke.TOPK_FRAC)
    t0 = time.perf_counter()
    out = run_baseline(method, engine, **kw)
    print(json.dumps({
        "baseline": name,
        "mean_test_acc": float(np.mean(out["test_acc"])),
        "n_params": engine.n_params,
        "seconds": time.perf_counter() - t0,
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1024,
    }), flush=True)


def run_one(engine, name):
    t0 = time.perf_counter()
    res = run_dpfl(engine, config(name))
    seg = (segregation_history(res.graph_history, res.malicious)
           if res.malicious is not None else None)
    print(json.dumps({
        "variant": name,
        "mean_test_acc": float(np.mean(res.test_acc)),
        "mean_val_acc_per_round": [float(np.mean(v))
                                   for v in res.val_acc_history],
        "comm_downloads": res.comm_downloads,
        "comm_preprocess": res.comm_preprocess,
        "comm_bytes": res.comm_bytes,
        "participation_per_round": (None if res.participation is None else
                                    res.participation.sum(1).tolist()),
        "malicious": (None if res.malicious is None else
                      np.flatnonzero(res.malicious).tolist()),
        "edge_rates": seg,
        "n_params": engine.n_params,
        "seconds": time.perf_counter() - t0,
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1024,
    }), flush=True)


if __name__ == "__main__":
    main()
