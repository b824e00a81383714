"""Dry-run the paper's own workload at production scale: N PaperCNN
clients on a client mesh of D devices, one rank running the very
`core.dpfl.dpfl_round_step` that `run_dpfl` runs, on "meta" tensors
(port of `repro.launch.fl_dryrun`: ``build_engine_step``, ``main``).

    PYTHONPATH=src python -m repro_torch.launch.fl_dryrun          # 512
    PYTHONPATH=src python -m repro_torch.launch.fl_dryrun --random-graph \\
        --audit-bytes
    PYTHONPATH=src python -m repro_torch.launch.fl_dryrun --devices 8 \\
        --clients 16 --run-rounds 2 --device cpu

`repro` lowers the round onto 512 forced host devices. Here the engine
is sharded over a ('pod', 'data') `ShapeMesh` (`repro_torch.sharding.
collectives`) and runs one round from `core.dpfl.abstract_round_state`
as rank 0: its Python loops (the greedy over the N positions, the
rotation's D - 1 steps) run in full, its kernels and collectives on
"meta" tensors, counted by `roofline.count_step`.
There is no bespoke round: what the dry run counts is what training
runs.

``--audit-bytes`` feeds the round's `CallRecord`s to
`analysis.commaudit.audit_records`. Every rank holds N / D clients, so
every rank's calls have rank 0's shapes: the dry run runs the first,
the middle and the last rank and holds their records equal, then gives
the audit rank 0's for each of the D ranks. With ``--random-graph``
(static downloads) it reconciles W x E == claimed x N x (D - 1) in
exact ints. ``--run-rounds K`` also runs `run_dpfl` for K rounds on
``--device`` (one device, the same configuration) under
`analysis.guards.recompile_sentinel(expect_new=0)`: no kernel library
is built or loaded inside the run (the counterpart of `repro`'s "one
compile" check; on the CPU the port has no kernel library to load).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from ..analysis import commaudit
from ..configs.paper_cnn import CONFIG as CNN_CONFIG
from ..core.dpfl import DPFLConfig, abstract_round_state, dpfl_round_step
from ..data import ParticipationConfig, make_federated_classification
from ..fl.adversary import ATTACKS, AdversaryConfig
from ..fl.compress import CompressionConfig
from ..fl.engine import FLEngine
from ..fl.robust import MIX_RULES
from ..models.classifier import PaperCNN
from ..roofline import HW, analyze_count, count_step
from ..sharding.collectives import ShapeMesh
from .mesh import AXES

OUT = os.path.join("build", "dryrun")


def build_engine_step(n_clients: int, n_train: int, n_val: int, tau: int,
                      budget: int, pods: int, devices: int,
                      participation: float = 1.0,
                      avail_model: str = "bernoulli",
                      compress: str = "none", topk_frac: float = 0.1,
                      quant_bits: int = 8, graph_repr: str = "dense",
                      random_graph: bool = False,
                      adversary: str = "none",
                      adversary_fraction: float = 0.4,
                      mix_rule: str = "weighted", rank: int = 0):
    """(round_step, state, mesh, engine, cfg): a PaperCNN `FLEngine` of
    ``n_clients`` clients sharded over the ('pod', 'data') `ShapeMesh` of
    ``devices`` in ``pods`` pods as ``rank``, on "meta" (its data and
    weights shapes alone), the `dpfl_round_step` of the configuration
    the flags name and its `abstract_round_state`, as `repro`'s builds
    them."""
    if devices % pods:
        raise ValueError(f"{devices} devices not divisible into {pods} pods")
    mesh = ShapeMesh((pods, devices // pods), AXES, rank)
    c = CNN_CONFIG
    data = make_federated_classification(
        seed=0, n_clients=n_clients, n_classes=c.n_classes,
        image_shape=(c.image_size, c.image_size, c.in_channels),
        n_train=n_train, n_val=n_val, n_test=n_val, noise=1.0)
    engine = FLEngine(PaperCNN(CNN_CONFIG), data, lr=0.01, batch_size=16,
                      device="meta", mesh=mesh)
    cfg = config(tau, budget, participation, avail_model, compress,
                 topk_frac, quant_bits, graph_repr, random_graph, adversary,
                 adversary_fraction, mix_rule)
    return (dpfl_round_step(engine, cfg), abstract_round_state(engine, cfg),
            mesh, engine, cfg)


def config(tau, budget, participation=1.0, avail_model="bernoulli",
           compress="none", topk_frac=0.1, quant_bits=8,
           graph_repr="dense", random_graph=False, adversary="none",
           adversary_fraction=0.4, mix_rule="weighted") -> DPFLConfig:
    """The one-round `DPFLConfig` of the flags."""
    part = None if participation >= 1.0 else ParticipationConfig(
        rate=participation, model=avail_model)
    comp = None if compress == "none" else CompressionConfig(
        codec=compress, topk_frac=topk_frac, quant_bits=quant_bits)
    adv = None if adversary == "none" else AdversaryConfig(
        attack=adversary, fraction=adversary_fraction)
    return DPFLConfig(rounds=1, tau_train=tau, budget=budget,
                      track_history=False, participation=part,
                      compression=comp, graph_repr=graph_repr,
                      random_graph=random_graph, adversary=adv,
                      mix_rule=mix_rule)


def round_count(args, rank: int, hw: HW = HW()):
    """One round of the flags' configuration as ``rank``, counted."""
    step, state, mesh, engine, cfg = build_engine_step(
        args.clients, args.n_train, args.n_val, args.tau, args.budget,
        args.pods, args.devices, args.participation, args.avail_model,
        args.compress, args.topk_frac, args.quant_bits, args.graph_repr,
        args.random_graph, args.adversary, args.adversary_fraction,
        args.mix_rule, rank=rank)
    return count_step(lambda: step(state), hw=hw), mesh, engine, cfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=512,
                    help="ranks of the client mesh")
    ap.add_argument("--clients", type=int, default=512)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--tau", type=int, default=5)
    ap.add_argument("--budget", type=int, default=10)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="availability rate; < 1 runs the participation-"
                         "aware round (DESIGN.md §9)")
    ap.add_argument("--avail-model", default="bernoulli",
                    choices=["bernoulli", "markov", "cluster"])
    ap.add_argument("--compress", default="none",
                    choices=["none", "identity", "topk", "int8"],
                    help="peer-exchange codec (DESIGN.md §11)")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="topk codec: fraction of P transmitted")
    ap.add_argument("--quant-bits", type=int, default=8,
                    help="int8 codec: wire bits per coordinate")
    ap.add_argument("--graph-repr", default="dense",
                    choices=["dense", "sparse"],
                    help="collaboration-graph layout: dense (N, N) masks "
                         "or budget-sparse (N, B) neighbor lists "
                         "(DESIGN.md §12)")
    ap.add_argument("--adversary", default="none",
                    choices=["none", *ATTACKS],
                    help="device-resident attack (DESIGN.md §15)")
    ap.add_argument("--adversary-fraction", type=float, default=0.4,
                    help="fraction of clients that are malicious")
    ap.add_argument("--mix-rule", default="weighted", choices=MIX_RULES,
                    help="Eq.-4 aggregation rule: weighted (paper), "
                         "trimmed or clipped")
    ap.add_argument("--random-graph", action="store_true",
                    help="Fig.-3 ablation: fixed random C_k of size "
                         "budget instead of the greedy graph; the only "
                         "configs whose realized downloads are static, "
                         "so the one --audit-bytes reconciles exactly")
    ap.add_argument("--audit-bytes", action="store_true",
                    help="classify every collective of the round and "
                         "reconcile its wire bytes against the claimed "
                         "comm_bytes (DESIGN.md §14)")
    ap.add_argument("--run-rounds", type=int, default=0,
                    help="also run run_dpfl for K rounds on --device "
                         "under a recompile sentinel: no kernel library "
                         "built or loaded inside the run")
    ap.add_argument("--device", default="cuda",
                    help="the device of --run-rounds (default cuda)")
    ap.add_argument("--out", default=OUT,
                    help="output dir for the JSON record")
    ap.add_argument("--no-out", action="store_true",
                    help="don't write the JSON record")
    return ap


def run_rounds(args, cfg):
    """`run_dpfl` for ``args.run_rounds`` rounds of ``cfg`` on one
    ``args.device``, its kernels loaded first, under
    ``recompile_sentinel(expect_new=0)``. Returns (result, seconds)."""
    import torch

    from ..analysis.guards import recompile_sentinel
    from ..core.dpfl import run_dpfl
    from ..kernels import _build

    c = CNN_CONFIG
    data = make_federated_classification(
        seed=0, n_clients=args.clients, n_classes=c.n_classes,
        image_shape=(c.image_size, c.image_size, c.in_channels),
        n_train=args.n_train, n_val=args.n_val, n_test=args.n_val,
        noise=1.0)
    engine = FLEngine(PaperCNN(CNN_CONFIG), data, lr=0.01, batch_size=16,
                      device=args.device)
    if torch.device(args.device).type == "cuda":
        for name in ("graph_mix", "sparse_graph_mix",
                     "compressed_graph_mix"):
            _build.load(name)
    cfg_run = dataclasses.replace(cfg, rounds=args.run_rounds)
    t0 = time.time()
    with recompile_sentinel(expect_new=0):
        result = run_dpfl(engine, cfg_run)
    return result, time.time() - t0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    hw = HW()
    t0 = time.time()
    count, mesh, engine, cfg = round_count(args, 0, hw)
    D = mesh.size()
    rec = {"workload": "dpfl_round_engine_paper_cnn",
           "clients": args.clients, "tau": args.tau, "budget": args.budget,
           "devices": D, "pods": args.pods, "rank": 0,
           "participation": args.participation,
           "compress": args.compress, "graph_repr": args.graph_repr,
           "random_graph": args.random_graph,
           "adversary": args.adversary, "mix_rule": args.mix_rule,
           "n_params": engine.n_params, "status": "ok"}
    rec.update(analyze_count(count, hw))
    rec["memory"] = {"step_peak_bytes": count.peak_bytes}
    rec["count_s"] = time.time() - t0
    rl = rec["roofline"]
    print(f"DPFL round_step x{args.clients} clients on {D} devices "
          f"({args.pods} pods), rank 0: {count.flops} flops, "
          f"{count.hbm_bytes} HBM bytes (unfused), {count.collective_bytes} "
          f"collective bytes received, {len(count.records)} collective "
          f"calls, step peak {count.peak_bytes} bytes; modelled at "
          f"{hw.name}'s data-sheet rates: compute={rl['compute_s']:.6f}s "
          f"memory={rl['memory_s']:.6f}s "
          f"collective={rl['collective_s']:.6f}s dominant={rl['dominant']}")
    run_result = None
    if args.run_rounds:
        run_result, seconds = run_rounds(args, cfg)
        print(f"run_rounds: {args.run_rounds} rounds on {args.device} in "
              f"{seconds:.1f}s, no kernel library built or loaded inside "
              f"the run; comm_bytes {run_result.comm_bytes}")
        rec["run_rounds"] = args.run_rounds
        rec["run_rounds_new_libraries"] = 0
    if args.audit_bytes:
        mine = [dataclasses.astuple(c) for c in count.records]
        for other in sorted({D // 2, D - 1} - {0}):
            theirs = round_count(args, other, hw)[0].records
            if [dataclasses.astuple(c) for c in theirs] != mine:
                print(f"AUDIT FAIL: rank {other}'s calls differ from rank "
                      f"0's")
                return 1
        rep = commaudit.audit_records(
            [count.records] * D, n_clients=args.clients, n_devices=D,
            n_params=engine.n_params, compression=cfg.compression,
            graph_repr=cfg.graph_repr,
            claimed_downloads=commaudit.static_downloads_per_round(
                cfg, args.clients))
        print(rep.table())
        claimed_rows = ([rep.claimed_downloads * rep.bytes_per_model]
                        if rep.claimed_downloads is not None else [])
        if run_result is not None:
            claimed_rows = run_result.comm_bytes
        print(f"{'round':>6}{'claimed B':>14}{'wire B':>14}"
              f"{'wire/claimed':>14}")
        for t, cb in enumerate(claimed_rows):
            ratio = (f"{rep.wire_model_bytes / cb:.3f}" if cb else "-")
            print(f"{t:>6}{cb:>14}{rep.wire_model_bytes:>14}{ratio:>14}")
        if rep.claimed_downloads is not None and rep.ok:
            commaudit.reconcile(
                rep, rep.claimed_downloads * rep.bytes_per_model)
            print("audit: wire x E == claimed x N(D-1) — reconciled")
        rec["audit"] = {
            "wire_model_bytes": rep.wire_model_bytes,
            "wire_refresh_bytes": rep.wire_refresh_bytes,
            "wire_control_bytes": rep.wire_control_bytes,
            "claimed_downloads": rep.claimed_downloads,
            "bytes_per_model": rep.bytes_per_model,
            "ok": rep.ok}
        if not rep.ok:
            for f in rep.failures:
                print("AUDIT FAIL:", f)
            return 1
    if not args.no_out:
        os.makedirs(args.out, exist_ok=True)
        fn = os.path.join(args.out, f"fl_round_N{args.clients}_D{D}x"
                                    f"{args.pods}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
