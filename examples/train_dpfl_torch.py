"""End-to-end DPFL driver (Algorithm 1) on the PyTorch port:
`examples/train_dpfl.py` run through `repro_torch` (the same flags, plus
``--device``): configurable clients, budget and partition,
best-on-validation checkpointing, an optional baseline comparison and
the graph report.

  PYTHONPATH=src python examples/train_dpfl_torch.py --clients 16 \
      --rounds 10 --budget 4 --partition dirichlet \
      --baselines local,fedavg,ditto --ckpt-dir /tmp/dpfl_ckpt
  PYTHONPATH=src python examples/train_dpfl_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro_torch.core import (DPFLConfig, graph_stats, run_dpfl,
                              run_dpfl_reference)
from repro_torch.data import make_federated_classification
from repro_torch.fl.baselines import BASELINES, run_baseline
from repro_torch.fl.engine import FLEngine
from repro_torch.models.classifier import MLP, PaperCNN


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--tau-init", type=int, default=3)
    ap.add_argument("--tau-train", type=int, default=3)
    ap.add_argument("--budget", type=int, default=4)
    ap.add_argument("--refresh-period", type=int, default=1)
    ap.add_argument("--partition", default="pathological",
                    choices=["pathological", "dirichlet", "iid"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--baselines", default="local,fedavg")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--engine", default="compiled",
                    choices=["compiled", "host"],
                    help="compiled = device-resident round engine "
                         "(run_dpfl); host = the host-driven round loop "
                         "(run_dpfl_reference)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    args = ap.parse_args()

    img = args.model == "cnn"
    data = make_federated_classification(
        seed=args.seed, n_clients=args.clients, n_clusters=args.clusters,
        partition=args.partition, alpha=0.1, classes_per_client=3,
        image_shape=(32, 32, 3) if img else None, feature_dim=16,
        n_train=32 if img else 16, n_val=24, n_test=48, noise=2.0,
        assign_level="cluster")
    model = PaperCNN(CNN_CONFIG) if img else MLP(16, 32, 10)
    engine = FLEngine(model, data, lr=0.05 if not img else 0.01,
                      batch_size=16 if img else 8, device=args.device)

    results = {}
    for name in [b for b in args.baselines.split(",") if b]:
        if name not in BASELINES:
            ap.error(f"unknown baseline {name} (known: {sorted(BASELINES)})")
        out = run_baseline(name, engine, rounds=args.rounds,
                           tau=args.tau_train, seed=args.seed)
        results[name] = out["test_acc"]
        print(f"{name:12s} acc={out['test_acc'].mean():.4f} "
              f"var={out['test_acc'].var():.5f}")

    cfg = DPFLConfig(rounds=args.rounds, tau_init=args.tau_init,
                     tau_train=args.tau_train, budget=args.budget,
                     refresh_period=args.refresh_period, seed=args.seed)
    runner = run_dpfl if args.engine == "compiled" else run_dpfl_reference
    res = runner(engine, cfg)
    results["dpfl"] = res.test_acc
    print(f"{'dpfl':12s} acc={res.test_acc.mean():.4f} "
          f"var={res.test_acc.var():.5f}")
    print("graph:", graph_stats(res))

    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        # per-client best-val models, in the layout `repro` loads
        best = engine.unflatten(torch.from_numpy(res.best_flat))
        mgr.keep_best(float(res.test_acc.mean()), best,
                      {"acc_per_client": res.test_acc.tolist()})
        print(f"checkpointed to {args.ckpt_dir}")

    order = sorted(results, key=lambda k: results[k].mean(), reverse=True)
    print("\nranking:", " > ".join(f"{k}({results[k].mean():.3f})"
                                   for k in order))


if __name__ == "__main__":
    main()
