"""Quickstart on the PyTorch port: DPFL vs local-only vs FedAvg on a
clustered heterogeneous synthetic benchmark, `examples/quickstart.py`
run through `repro_torch` (the same flags, plus ``--device``).

  PYTHONPATH=src python examples/quickstart_torch.py           # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core import DPFLConfig, graph_stats, run_dpfl
from repro_torch.data import make_federated_classification
from repro_torch.fl.baselines import run_baseline
from repro_torch.fl.engine import FLEngine
from repro_torch.models.classifier import MLP


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--tau", type=int, default=3,
                    help="local epochs (tau_init = tau_train = tau)")
    ap.add_argument("--budget", type=int, default=4,
                    help="per-client collaborator budget B_c")
    ap.add_argument("--graph-repr", default="dense",
                    choices=["dense", "sparse"],
                    help="graph layout: (N, N) masks or (N, B) neighbor "
                         "lists (DESIGN.md §12)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    args = ap.parse_args()

    data = make_federated_classification(
        seed=3, n_clients=args.clients, n_clusters=2,
        partition="pathological", classes_per_client=3, feature_dim=16,
        n_train=16, n_val=24, n_test=48, noise=2.0, assign_level="cluster")
    engine = FLEngine(MLP(16, 32, 10), data, lr=0.05, batch_size=8,
                      device=args.device)

    local = run_baseline("local", engine, rounds=args.rounds, tau=args.tau,
                         seed=0)
    fedavg = run_baseline("fedavg", engine, rounds=args.rounds,
                          tau=args.tau, seed=0)
    res = run_dpfl(engine, DPFLConfig(
        rounds=args.rounds, tau_init=args.tau, tau_train=args.tau,
        budget=args.budget, seed=0, graph_repr=args.graph_repr))

    print(f"{'method':12s} mean-acc  per-client")
    for name, acc in (("local", local["test_acc"]),
                      ("fedavg", fedavg["test_acc"]),
                      (f"DPFL(B={args.budget})", res.test_acc)):
        print(f"{name:12s} {acc.mean():.4f}   "
              + " ".join(f"{a:.2f}" for a in acc))

    stats = graph_stats(res)
    print("\ncollaboration graph:", stats)
    adj = res.graph_history[-1]
    cl = data.cluster
    same = adj[cl[:, None] == cl[None, :]].mean()
    cross = adj[cl[:, None] != cl[None, :]].mean()
    print(f"edge rate within clusters {same:.2f} vs across {cross:.2f} "
          "(GGC discovers the hidden clusters)")


if __name__ == "__main__":
    main()
