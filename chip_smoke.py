#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero unless all pass):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build every kernel of the port from the sources in this checkout
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it and at its edge cases: K1 graph_mix,
   K2 sparse_graph_mix (sentinel slots, all-sentinel rows, duplicate
   indices, B > N, ragged P, bf16, the one-column path, B past a group
   of 8 slots and a chunk of 64; the same bits on a repeat), K3
   compressed_graph_mix (duplicate indices, -1 pads, K and P off the
   tile, every entry in one tile, K > P, four bucketing windows, a
   window past the shared-memory stage; the
   same bits on a repeat, and its bucketing pass exactly its plain
   version's);
   K4 flash_attention (the serve shape in fp32 and bf16, MQA with a
   window, h2o-danube's hd 80, recurrentgemma's hd 256 with one KV
   head at a window of 64 and at its serve shape with the window of
   2048, internvl2-2b's serve shape (S 768: 256 vision positions and
   512 tokens) and qwen3-moe-30b-a3b's (32/4 heads), ragged S, S = 1,
   Sq != Sk, and whisper-medium's: its encoder non-causal over 1,500
   frames in fp32 and bf16, its cross-attention at Sq 224 and Sq 1
   against them, its decoder's causal self-attention), K5 ssd
   (mamba2-370m's serve
   shape with the model's dt, tests/test_kernels.py's three shapes, the
   reduced model's, one ragged chunk, h0, p 128, eight chunks at the
   serve width, B and C as views of the model's xBC projection, h0 with
   one chunk, p 24 with n 4, inputs off 16-byte alignment; the same bits
   on a repeat) and K6 rglru_scan
   (recurrentgemma-9b's serve shape with the model's a and b,
   tests/test_kernels.py's three shapes with h0 and its case without,
   ragged S and W, one step with h0, fewer channels than one block);
   K4's backward (K4_BWD_CASES), K5's backward (the mamba2-370m train
   shape, h0 with dh_last, one chunk, eight chunks, views of one
   projection, inputs off 16-byte alignment, p 128, two head groups;
   the same bits on a repeat) and K6's backward (the recurrentgemma-9b
   train shape, ragged S and W with and without h0 and dh_last, one
   step; bit for bit); K4's bf16 backward (K4_BWD_BF16_CASES: qwen3-0.6b's
   train shape, whisper-medium's encoder, recurrentgemma-9b's; in bf16
   against the plain version in bf16, each gradient's error printed, one
   launch of the bf16 library a call, the same bits on a repeat and
   through autograd); K4 under
   ``torch.func.vmap`` over clients
   (K4_VMAP_CASES, the lm-dpfl example's head_dim 32 among them: one
   launch on the folded batch, forward and backward, bit for bit the
   per-client launches); K7 cnn_features (K7_CASES: the dense cell's
   reward call of 400 probe models with the weights as views of one
   probe panel, image 16, the narrow widths, one input channel, one
   image, ragged G and B; in float64 against the plain version, the
   same bits on a repeat and for a model launched alone);
   then `prng.normal` (2**20 draws) on the card: the CPU's bits and
   jax.random.normal's (`NORMAL_SHA256`);
4. the port's main paths: Algorithm 1 through
   `repro_torch.core.dpfl.run_dpfl` on PaperCNN at its published width
   (32 clients, 3 rounds) in eight configurations (`VARIANTS`: dense
   graphs without a codec; ``graph_repr="sparse"``; dense with the top-k
   codec; sparse with top-k; then partial participation, adversaries and
   the robust mix rules: markov outages; free riders under bernoulli
   outages, clipped, sparse; sign flippers under cluster outages,
   clipped, top-k; label flippers, trimmed), each with the kernel launch
   counts zeroed just before and read just after (K7's held to the
   run's reward calls plus twice its evaluations), the run's invariants
   (Omega equal to the dense run's, realized downloads, absent clients'
   graphs held, the malicious head-count) and a learning check; then
   the same entry point on a small input on the card and on the CPU
   (dense, sparse, top-k, int8, and dense and sparse under participation
   with sign flippers clipped, with label flippers trimmed and with noisy
   free riders), which must select the same graphs; the guards phase
   (`repro_torch.analysis.guards`): the dense run again, warm, under
   ``recompile_sentinel(expect_new=0)`` over every kernel library (0
   new builds and loads) with its rounds inside `run_rounds`'
   ``no_transfer`` fence, each of `transfer_probes` inside the
   fence (raising where `TRANSFER_FENCED` says) and inside
   ``allow_transfers`` (passing), and the `donation_report` of the
   full-width dense `dpfl_round_step` (every donatable leaf in place);
   the donation phase: the dense run with the round step's donation off
   and on, bit for bit, each one's peak of allocated memory and report;
   the paper's §4.5 label-flip run (Fig. 4: LABEL_FLIP_DATA, 3 of 8
   clients malicious) on the card (K1 on its path) and on the CPU, each
   last graph segregating benign from malicious clients; the dense
   run's best
   models through the port's `CheckpointManager` and back bit for bit;
   then the eleven Table-1 baselines, and FedAvg under markov outages
   with the top-k codec, through `repro_torch.fl.baselines.run_baseline`
   on the same engine (`BASELINE_RUNS`), each with the counts zeroed
   just before and read just after (K1 once a round for pFedGraph, no
   kernel in the others), every round under the no-sync fence, and a
   learning check; then the same runs on client meshes of processes
   that share the card (`repro_torch.launch.mesh`, gloo; SHARD_MESHES:
   2 ranks of 16 clients, and 2 x 2 ranks of 8 crossing the pod axis):
   the random-graph dense, sparse and top-k runs and the dense, sparse
   and top-k variants (SHARD_RUNS), each rank's K1-K3 launches against
   `shard_launches`, one round of each audited
   (`repro_torch.analysis.commaudit.audit_config`: the random-graph
   rounds' wire W equal to AUDIT_WIRE's and reconciled with the run's
   comm_bytes, W x E == claimed x N x (D - 1), the greedy rounds with
   no UNEXPLAINED call),
   every round under the no-sync fence, the counters equal to the
   single-device runs', the random-graph, dense and top-k runs bit for
   bit against single-device runs whose forwards and backwards take the
   shard's client count at a time (``FLEngine._client_chunk``;
   SHARD_BITWISE), each rotated K2 mix of the sparse run and a seeded
   int8 rotation within 1e-5 of the plain mix of the same inputs over
   the gathered table, the single-device random-graph run repeated bit
   for bit, with the transport table and the smallest greedy margin;
   then the serving
   path:
   `repro_torch.launch.serve.generate` on qwen3-0.6b at its full
   published config (28 layers, float32, random weights from a seed),
   batch 4, prompt 512, 32 new tokens, greedy, with the counts zeroed
   just before and read just after (28 K4 launches in the prefill, 0 in
   decode), the same tokens from a second call, and the same weights on
   the card and on the CPU (batch 1, prompt 128, 8 tokens), which must
   give the same tokens; its warm serve under
   ``recompile_sentinel(expect_new=0)``, each decode step inside
   `generate`'s fence; and the same weights in a model built with
   ``build_model(cfg, attn_window=REPAIR_WINDOW)``, shorter than the
   prompt, its prefill logits and tokens against the same model with
   K4's plain version (K4_TOL); then the same for mamba2-370m at its full
   published config (48 Mamba2 blocks, float32; 48 K5 launches in the
   prefill, 0 in decode, no other kernel of the port) and for
   recurrentgemma-9b at its published widths on its first 14 of 38
   layers (SERVE_LAYERS: 10 RG-LRU blocks and 4 local-attention blocks,
   float32; 10 K6 and 4 K4 launches in the prefill, 0 in decode), whose
   card-against-CPU
   check runs the model's first five layers (two segments) with its
   embedding, head and final norm (CROSS_LAYERS); then internvl2-2b at
   its full published config (24 layers behind 256 vision embeddings
   drawn from a seed; 24 K4 launches in the prefill, 0 in decode; card
   against CPU on its first 4 layers) and qwen3-moe-30b-a3b at full
   width on its first 4 of 48 layers (SERVE_LAYERS: 4 K4 launches in
   the prefill, 0 in decode, its experts plain batched products; the
   same logits bits on a second call; the smallest router gap and the
   copies its capacity drops; card against CPU on its first 2 layers)
   and whisper-medium at its published config (24 encoder and 24 decoder
   layers behind 1,500 frames drawn from a seed, prompt 224; 72 K4
   launches in the prefill, non-causal over the frames, causal in the
   decoder, non-causal in each cross-attention, and 24 in each decode
   step, where the cross-attention runs again; card against CPU on its
   first 2 encoder and 2 decoder layers, prompt 64);
   then the training
   path: `launch.train.main` on qwen3-0.6b (TRAIN_ARGV) and mamba2-370m
   (TRAIN_SSM_ARGV) at their published configs, qwen3-0.6b whole in bf16
   through `launch.train.train` (TRAIN_BF16: K4's bf16 forward twice and
   its bf16 backward once a layer and step; its warm step, AdamW's share
   and peak printed beside the fp32 run's), and through
   `launch.train.train` internvl2-2b on 12 of its 24 layers (TRAIN_VLM:
   seeded vision embeddings) and recurrentgemma-9b and qwen3-moe-30b-a3b
   at full width
   on their first 6 and 2 layers (TRAIN_HYBRID, TRAIN_MOE; the moe run's
   router loss printed), and whisper-medium at full width on 12 of its
   24 encoder and 24 decoder layers (TRAIN_AUDIO: B 8,
   448 tokens after 1,500 seeded frames; 72 K4 forward and 36 backward
   launches a step), each 10 steps with the counts zeroed just
   before
   and read just after (each layer's kernel forward twice a step and its
   backward once, under remat "full"), finite, falling losses; then each
   family cut small on the card and on the CPU against JAX's losses
   (CROSS_TRAINS; qwen3-0.6b's twice, in fp32 and in bf16), and the DPFL
   mix of the dense one's weights; then
   the LM examples: `examples/lm_dpfl_torch.py` (Algorithm 1 over qwen3
   clients, their loss and accuracy vmapped over the clients) in its
   own setting on the card and on the CPU, which must select the same
   graphs with the same accuracies and the best models' validation
   losses within CROSS_TRAIN_LOSS_TOL, then at qwen3-0.6b's published widths on 2 layers and 4
   clients (LM_DPFL_FULL), each with the counts zeroed just before and
   read just after (K4 once a layer per vmapped call, its backward once
   a layer per local step, K1 as in the dense run: `lm_dpfl_launches`),
   every round under the no-sync fence, and the full-width run again
   with a round step that does not donate (its peak beside the donating
   run's; the same graphs and accuracies); and
   `examples/serve_personalized_torch.py` on the whole published
   qwen3-0.6b (PERSONALIZED_RUN: 3 clients' weights, 4 requests of 512
   tokens, 32 new; 28 K4 launches in the prefill, 0 in decode), each
   request's tokens those of `generate` on its own client's weights;
   then the model mesh (`repro_torch.launch.mesh.run_on_mesh`, one
   process a shard of a ("data", "model") mesh sharing the card over
   gloo): `generate` on qwen3-0.6b (7 layers on (1, 2) and on (2, 2))
   and on qwen3-moe-30b-a3b at full width (its experts split over
   "model", on 1 layer) with each attention ring
   sharded on its slots over "model" (flash-decoding) on meshes (1, 2)
   and (2, 2) (MODEL_MESH_RUNS), each rank's every step's logits within
   MESH_LOGITS_TOL of its rows of the single-device run (the moe model's
   of its data block's own run, whose dropped copies and router
   statistics it must reproduce), K4 once a layer a rank, the
   collectives counted, every decode step under the no-sync fence; and
   the LM example's clients on client meshes of 2 and 3 ranks
   (LM_CLIENT_MESHES), bit for bit the single-device run with the
   shard's client count at a time, the plain run's graphs; then the
   dry run (`run_dryrun`, `repro_torch.launch.dryrun`'s means on the
   card): each kernel and backward at its first timed shape asks the
   allocator for exactly what its meta path allocates; the peak that
   `roofline.count_step` predicts on "meta" tensors within
   DRYRUN_PEAK_TOL of `max_memory_allocated` for one dense round, the
   qwen3-0.6b, mamba2-370m and whisper-medium train steps and
   qwen3-0.6b's serve, and within DRYRUN_BF16_PEAK_TOL for qwen3-0.6b's
   bf16 train step
   (DRYRUN_TRAINS, DRYRUN_SERVE); and the `ShapeMesh` rounds' collective
   records equal the sharded phase's audited rounds', rank by rank;
5. each kernel timed beside its plain version, the one PyTorch call
   that computes the same function where there is one (none for K5
   and K6), K3's launches also alone, K5's three kernels by
   torch.profiler's records and its wrapper's host time,
   and its bound (after phase 4, so the card runs at its working
   clocks, not idle ones);
6. one JSON line of per-kernel results, then the device line.

Needs one CUDA card; exits non-zero, printing no result, without one or
without the port's sources beside it. Imports no JAX.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# ---- the main-path configuration (tools/jax_reference_smoke.py runs the
# same one through the JAX reference)
SMOKE_DATA = dict(seed=0, n_clients=32, n_clusters=4,
                  partition="pathological", classes_per_client=3,
                  image_shape=(32, 32, 3), n_train=128, n_val=32, n_test=64,
                  noise=2.0, assign_level="cluster")
SMOKE_RUN = dict(rounds=3, tau_init=2, tau_train=1, budget=4, seed=0)
SMOKE_LR, SMOKE_BATCH = 0.01, 16
PAPER_CNN_PARAMS = 62006
TOPK_FRAC = 0.1
# The main-path runs, as DPFLConfig settings over SMOKE_RUN (``codec``: a
# CompressionConfig of that codec at TOPK_FRAC; ``participation`` and
# ``adversary``: the keyword arguments of ParticipationConfig and
# AdversaryConfig). tools/jax_reference_smoke.py builds `repro`'s configs
# from the same table. The last four run partial participation,
# adversaries and the robust mix rules: markov outages on dense graphs
# (K1 on the restricted matrix); free riders (noise 1.0) under bernoulli
# outages, clipped, on lists (K2 with the wire table as W_peers); sign
# flippers under cluster outages, clipped, with top-k (K3 on the clipped
# matrix, the error-feedback hold); label flippers, trimmed (K1 only in
# BGGC and the greedy: the trimmed mix is plain torch, as in `repro`).
VARIANTS = {
    "dense": {}, "sparse": dict(graph_repr="sparse"),
    "topk": dict(codec="topk"),
    "sparse-topk": dict(graph_repr="sparse", codec="topk"),
    "dense-markov": dict(participation=dict(
        rate=0.7, model="markov", mean_burst=3.0, seed=0)),
    "sparse-freerider-clipped": dict(
        graph_repr="sparse",
        participation=dict(rate=0.8, model="bernoulli", seed=1),
        adversary=dict(attack="free_rider", fraction=0.25, noise_scale=1.0,
                       seed=0),
        mix_rule="clipped", clip_mult=1.0),
    "topk-signflip-clipped": dict(
        codec="topk", participation=dict(rate=0.75, model="cluster", seed=2),
        adversary=dict(attack="sign_flip", fraction=0.25, seed=0),
        mix_rule="clipped", clip_mult=1.0),
    "dense-labelflip-trimmed": dict(
        adversary=dict(attack="label_flip", fraction=0.25, seed=0),
        mix_rule="trimmed", trim_frac=0.2)}
# The baseline runs (Table 1, `repro_torch.fl.baselines`) on the same
# engine: each of the eleven methods once at BASELINE_RUN, then FedAvg
# under markov outages with the top-k codec, so both branches of their
# round loop (`baselines._loop`: the availability schedule, the codec
# with its residual hold) run on the card. Values: (method, keyword
# arguments of ParticipationConfig or None, codec or None).
BASELINE_RUN = dict(rounds=3, tau=1, seed=0)
BASELINE_RUNS = {name: (name, None, None) for name in (
    "local", "fedavg", "fedavg_ft", "fedprox", "fedprox_ft", "apfl",
    "perfedavg", "ditto", "fedrep", "knnper", "pfedgraph")}
BASELINE_RUNS["fedavg-markov-topk"] = (
    "fedavg", dict(rate=0.7, model="markov", mean_burst=3.0, seed=0),
    "topk")
# Learning check: the JAX reference on each configuration, on the CPU,
# reaches a mean best-validation test accuracy of LEARN_REF
# (`PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_reference_smoke.py`,
# jax 0.9.0 on x86-64; its mean validation accuracy per round was 0.628,
# 0.760, 0.870 dense, 0.628, 0.760, 0.871 sparse, and 0.475, 0.512, 0.536
# with top-k in either representation: three rounds of top-k at 10 %
# learn slower; 0.561, 0.647, 0.757 dense-markov, 0.465, 0.585, 0.633
# sparse-freerider-clipped, 0.395, 0.482, 0.493 topk-signflip-clipped
# and 0.551, 0.620, 0.729 dense-labelflip-trimmed). Chance is 1/10. The
# port must reach the reference's figure less a margin of 0.1, for graph
# decisions that fp noise may flip.
LEARN_REF = {"dense": 0.8583984375, "sparse": 0.8583984375,
             "topk": 0.54345703125, "sparse-topk": 0.54345703125,
             "dense-markov": 0.74267578125,
             "sparse-freerider-clipped": 0.64404296875,
             "topk-signflip-clipped": 0.55810546875,
             "dense-labelflip-trimmed": 0.744140625,
             # the baseline runs (the same command, jax 0.9.0 on x86-64's
             # CPU; 12-25 s each): FedAvg's one global model sits below
             # local training on this pathological split after three
             # rounds, and at 10 % top-k under outages near chance
             "local": 0.50830078125, "fedavg": 0.2822265625,
             "fedavg_ft": 0.43603515625, "fedprox": 0.28662109375,
             "fedprox_ft": 0.4541015625, "apfl": 0.46044921875,
             "perfedavg": 0.34765625, "ditto": 0.48095703125,
             "fedrep": 0.3798828125, "knnper": 0.48828125,
             "pfedgraph": 0.4453125, "fedavg-markov-topk": 0.16650390625}
LEARN_MARGIN = 0.1
# The paper's §4.5 label-flip run (Fig. 4; tests/test_fl_e2e.py's
# segregation claim): `make_label_flip_data` with 3 of 8 clients under one
# label permutation, MLP(16, 32, 10), lr 0.05, batch 8, and its DPFLConfig.
LABEL_FLIP_DATA = dict(seed=0, n_clients=8, n_malicious=3, feature_dim=16,
                       n_train=24, n_val=24, n_test=24, noise=0.5)
LABEL_FLIP_MLP = (16, 32, 10)
LABEL_FLIP_ENGINE = dict(lr=0.05, batch_size=8)
LABEL_FLIP_RUN = dict(rounds=6, tau_init=3, tau_train=3, budget=5, seed=0)
# The sharded phase: the main path's width (SMOKE_DATA, SMOKE_RUN) on
# client meshes (pods, ranks a pod) of processes sharing the card, gloo
# between them. Runs: the random-graph dense run (no greedy decision, so
# the same bits as a single-device run of the same per-launch client
# count) and three of VARIANTS.
SHARD_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SHARD_RUNS = ("dense-random", "sparse-random", "topk-random", "dense",
              "sparse", "topk")
# The wire-bytes audit of one round of each sharded run
# (`analysis.commaudit.audit_config`): on the random graph, W = N x bpm x
# (D - 1) bytes received over the ranks (PaperCNN P 62,006, N 32; bpm
# 248,024 in fp32, 49,608 at top-k 0.1: K 6,201), dense and sparse alike,
# reconciled against the run's comm_bytes; the greedy runs' audits show
# no UNEXPLAINED call. (codec, mesh) -> W
AUDIT_WIRE = {("fp32", "1x2"): 7936768, ("fp32", "2x2"): 23810304,
              ("topk", "1x2"): 1587456, ("topk", "2x2"): 4762368}
# the runs held bit for bit against a single-device run that takes the
# shard's client count at a time (FLEngine._client_chunk): cuDNN picks
# its grouped-convolution algorithms by the group count, so the plain
# single-device run, all 32 clients at a time, parts from the sharded
# one in the last bits of local training, and the greedy's near-ties
# may then part the graphs. The neighbor-list run has no such twin: its
# rotation adds the peers in visit order, so each of its rotated mixes
# is held within TOL["float32"] of the plain mix of the same inputs over
# the all-gathered table instead (`rotation_error`).
SHARD_BITWISE = ("dense-random", "dense", "topk")
# The model-mesh phase: `repro`'s ("data", "model") mesh axis, one
# process a shard sharing the card over gloo, each rank serving its block
# of SERVE_RUN's batch through `launch.serve.generate`, its attention
# rings sharded on "model" (its C / M slots of the 544-slot rings): run ->
# (arch, layers, mesh (data, model)). qwen3-0.6b on 7 of its 28 layers
# at (1, 2) and at (2, 2); qwen3-moe-30b-a3b at its published widths
# with its experts sharded too, on 1 of its 48 layers at (1, 2) (64
# experts a rank) and at (2, 2). These runs were cut (moe from 8, 4
# and 2 layers, qwen3 from 28 and 14) to keep the script under 800 s
# with the dry-run phase and the bf16 phases.
MODEL_MESH_RUNS = {"qwen3 1x2": ("qwen3-0.6b", 7, (1, 2)),
                   "qwen3 2x2": ("qwen3-0.6b", 7, (2, 2)),
                   "moe 1x2": ("qwen3-moe-30b-a3b", 1, (1, 2)),
                   "moe 2x2": ("qwen3-moe-30b-a3b", 1, (2, 2))}
# the logits of every step against the single-device run's rows; the aux
# loss against the whole batch's; a top-2 gap under MESH_GAP may part the
# greedy tokens
MESH_LOGITS_TOL = 1e-4
MESH_AUX_TOL = 1e-6
MESH_GAP = 1e-5
# the repair of build_model(attn_window=): qwen3-0.6b served with this
# window, shorter than SERVE_RUN's 512-token prompt, so K4's window binds
REPAIR_WINDOW = 256
# each deliberate transfer of `transfer_probes` -> whether the CUDA fence
# of `repro_torch.analysis.guards.no_transfer` refuses it (the table its
# docstring states; tests/test_torch_cuda.py holds the card to it too)
TRANSFER_FENCED = {"item": True, "cpu": True, "as_tensor numpy": True,
                   "tensor scalar": True, "python scalar operand": False,
                   "pinned non_blocking to cuda": False}
# the archs whose serve runs leave the model-mesh runs their references
# LM clients on the client mesh: the LM example's setting (its reduced
# qwen3, 6 clients) on client meshes of 2 and 3 ranks
LM_CLIENT_MESHES = {"1x2": 2, "1x3": 3}
# the card's name and power limit as nvidia-smi gives them (set in main,
# printed beside every number of the sharded phase)
SMI = ""
# prng.normal on the card: NORMAL_DRAWS draws from PRNGKey(3) must be the
# CPU's bits and jax's: the SHA-256 of jax.random.normal(PRNGKey(3),
# (2**20,)) as little-endian float32 bytes (jax 0.9.0 on x86-64's CPU)
NORMAL_DRAWS = 1 << 20
NORMAL_SHA256 = ("a3dc40feacf240c8ed4b4f59e2c8a1e0"
                 "cbf1be7b9d3be8bcf82bd56f72775261")
# the dense run's best models go through the port's CheckpointManager
# here (git-ignored) and must come back bit for bit
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"

# K1 shapes: (M, N, P, dtype, W a row-offset view) — the Eq.-4 mix, one
# BGGC phase-1 batch, one client's set sum, a ragged P, bf16 W, and the
# Eq.-4 mix at an odd P, which takes the one-column path (these six are
# timed); then shapes that reach every vector width and edge
# (kernels/graph_mix.py vector_width): P = 0 and 3 mod 4 (PaperCNN's is
# 2), P under one vector, M 33 and 64 (two block rows), N 1, 33 and 100,
# and W as a view one element into a larger buffer (`narrow`), so its
# data_ptr() is only element-aligned
K1_SHAPES = [(32, 32, PAPER_CNN_PARAMS, "float32", False),
             (32, 4, PAPER_CNN_PARAMS, "float32", False),
             (1, 32, PAPER_CNN_PARAMS, "float32", False),
             (7, 5, 1000, "float32", False),
             (32, 32, PAPER_CNN_PARAMS, "bfloat16", False),
             (32, 32, 62005, "float32", False),
             (32, 32, 62004, "float32", False),
             (32, 32, 62007, "float32", False),
             (5, 3, 3, "float32", False),
             (5, 3, 1, "bfloat16", False),
             (33, 32, 1000, "float32", False),
             (64, 32, 2048, "bfloat16", False),
             (32, 1, PAPER_CNN_PARAMS, "float32", False),
             (32, 33, 999, "float32", False),
             (7, 100, 4098, "bfloat16", False),
             (32, 32, 62004, "float32", True),
             (32, 32, PAPER_CNN_PARAMS, "float32", True),
             (32, 32, 62004, "bfloat16", True)]
K1_TIMED = 6   # the first six shapes
TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # tests/test_kernels.py
# K4 cases: (name, B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype); the
# first is the serve run's prefill attention (qwen3-0.6b, batch 4,
# prompt 512)
K4_CASES = [("serve", 4, 512, 512, 16, 8, 128, True, None, "float32"),
            ("serve bf16", 4, 512, 512, 16, 8, 128, True, None, "bfloat16"),
            ("MQA, window 96", 1, 256, 256, 4, 1, 64, True, 96, "float32"),
            ("hd 80, window 128", 2, 384, 384, 32, 8, 80, True, 128,
             "float32"),
            ("hd 256, Hkv 1, window 64", 1, 256, 256, 16, 1, 256, True, 64,
             "float32"),
            ("hybrid serve, hd 256, Hkv 1, window 2048", 4, 512, 512, 16, 1,
             256, True, 2048, "float32"),
            # internvl2-2b's prefill (256 vision positions and a 512-token
            # prompt) and qwen3-moe-30b-a3b's (32/4 heads: GQA ratio 8)
            ("vlm serve, S 768", 4, 768, 768, 16, 8, 128, True, None,
             "float32"),
            ("moe serve, 32/4 heads", 4, 512, 512, 32, 4, 128, True, None,
             "float32"),
            ("ragged S = 200", 2, 200, 200, 16, 8, 128, True, None, "float32"),
            ("S = 1", 4, 1, 1, 16, 8, 128, True, None, "float32"),
            ("Sq 128, Sk 256", 2, 128, 256, 16, 8, 128, True, None, "float32"),
            # bf16 twins: the tensor-core path at every edge, and its
            # timing row at the hybrid shape
            ("MQA, window 96", 1, 256, 256, 4, 1, 64, True, 96, "bfloat16"),
            ("hd 80, window 128", 2, 384, 384, 32, 8, 80, True, 128,
             "bfloat16"),
            ("hd 256, Hkv 1, window 64", 1, 256, 256, 16, 1, 256, True, 64,
             "bfloat16"),
            ("hybrid serve, hd 256, Hkv 1, window 2048", 4, 512, 512, 16, 1,
             256, True, 2048, "bfloat16"),
            ("ragged S = 200", 2, 200, 200, 16, 8, 128, True, None,
             "bfloat16"),
            ("S = 1", 4, 1, 1, 16, 8, 128, True, None, "bfloat16"),
            ("Sq 128, Sk 256", 2, 128, 256, 16, 8, 128, True, None,
             "bfloat16"),
            # whisper-medium (16 heads of 64, MHA): its encoder's
            # non-causal self-attention over 1,500 frames at the serve
            # run's B 4 (1,500 = 23 tiles of 64 and 28: a ragged last key
            # tile), with its bf16 twin; the cross-attention of the
            # 224-token prompt and of a decode step (one valid row in its
            # query tile) against the frames; the decoder's causal
            # self-attention
            ("whisper encoder serve, non-causal", 4, 1500, 1500, 16, 16, 64,
             False, None, "float32"),
            ("whisper encoder serve, non-causal", 4, 1500, 1500, 16, 16, 64,
             False, None, "bfloat16"),
            ("whisper cross, Sq 224, Sk 1500", 4, 224, 1500, 16, 16, 64,
             False, None, "float32"),
            ("whisper serve decode cross, Sq 1, Sk 1500", 4, 1, 1500, 16,
             16, 64, False, None, "float32"),
            ("whisper decoder self, S 224", 4, 224, 224, 16, 16, 64, True,
             None, "float32")]
K4_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
# bf16 K4 also against the fp32 plain version on the same bf16 inputs,
# (atol, rtol): rtol 2^-6, two bf16 ulps, for the output's own rounding
# (at most half an ulp); atol 2^-7 for the rounding of P to bf16 (at
# most 2^-8 of each p), an error that scales with |v|, not with the
# output, so it shows in rows whose output is near 0
K4_BF16_FP32_TOL = (2.0 ** -7, 2.0 ** -6)
# The serving paths: qwen3-0.6b (dense, K4), mamba2-370m (SSM, K5),
# recurrentgemma-9b (hybrid: K6 in its recurrent blocks, K4 in its
# attention blocks), internvl2-2b (vlm: dense layers, K4, behind 256
# vision embeddings drawn from a seed) and qwen3-moe-30b-a3b (moe: K4 and
# the experts' plain batched products) and whisper-medium (audio: K4 in
# its encoder, non-causal over 1,500 frames drawn from a seed, and in its
# decoder's causal self-attention and non-causal cross-attention, decode
# too) at their published configs, in float32 as `repro.launch.serve`
# runs them
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-370m", "recurrentgemma-9b",
               "internvl2-2b", "qwen3-moe-30b-a3b", "whisper-medium")
SERVE_RUN = dict(batch=4, prompt_len=512, new_tokens=32)
# whisper-medium's prompt: 224 tokens, about the most previous text that
# openai/whisper's decoding keeps (half of its 448 text positions)
SERVE_PROMPT = {"whisper-medium": 224}
# served at full width on their first layers: qwen3-moe-30b-a3b's 48
# layers hold 30.5 B weights (122 GB in fp32, more than the card); it
# serves on its first 4 with the embedding, head and final norm (cut from
# 8, 5.61 B weights whose draw took 28 s, to keep the script under 800
# s); recurrentgemma-9b on 14 of its 38 layers (both segments: 4 groups
# of (rec, rec, attn), then (rec, rec)), cut from 38 for the same reason
# (its whole 26.1 GB draw took 32 s)
SERVE_LAYERS = {"qwen3-moe-30b-a3b": 4, "recurrentgemma-9b": 14}
# the seed of the vlm's vision embeddings (unit normals, B x 256 x 2048)
VISION_SEED = 5
# the seed of the audio model's frames (unit normals, B x 1500 x 1024)
FRAMES_SEED = 6
CROSS_RUN = dict(batch=1, prompt_len=128, new_tokens=8)
CROSS_PROMPT = {"whisper-medium": 64}
# Card against CPU at a stated reduction: recurrentgemma-9b's served
# weights (14 layers, SERVE_LAYERS) are run on the CPU as the model's
# first five layers (rec, rec,
# attn, then the (rec, rec) remainder segment, so both segments run) with
# its embedding, head and final norm, copied to the host, nothing drawn
# anew. internvl2-2b runs its first 4 of 24 layers (2.4 GB with its
# embedding and head) and qwen3-moe-30b-a3b its first 2 (7.5 GB);
# whisper-medium its first 2 encoder and 2 decoder layers with its
# embedding and norms (prompt 64). The other serve models run whole.
CROSS_LAYERS = {"recurrentgemma-9b": 5, "internvl2-2b": 4,
                "qwen3-moe-30b-a3b": 2, "whisper-medium": 2}
# Card against CPU on the same weights: last-position prefill logits
# (qwen3's std 0.64) within CROSS_TOL. A CPU rehearsal at full width with 2 and 4
# layers (B 1, S 128, float32) put two summation orders (the prompt alone
# against inside a batch of 3; 4 threads against 1) at most 6.3e-6 apart,
# and 4.2e-6 from a float64 forward, growing little with depth; 28
# layers and another BLAS grow that, while a wrong mask or rope moves
# logits by 1e-2 and more.
CROSS_TOL = 1e-3
# K2 cases: (name, N, B, P, dtype, index table, separate W_peers). The
# main path's: Omega-shaped lists (B = budget distinct peers) over one
# table (no codec) and over a separate decoded table (a codec).
K2_CASES = [("main", 32, 4, PAPER_CNN_PARAMS, "float32", "lists", False),
            ("main, W_peers=dec", 32, 4, PAPER_CNN_PARAMS, "float32",
             "lists", True),
            ("main bf16", 32, 4, PAPER_CNN_PARAMS, "bfloat16", "lists", True),
            # a visiting panel of the sharded rotation (SHARD_MESHES:
            # n_loc 16 and 8): (n_loc, P) peers, the slots naming other
            # shards masked to -1, rows of none, zero self weights
            ("rotation panel, 1x2", 16, 4, PAPER_CNN_PARAMS, "float32",
             "panel", True),
            ("rotation panel, 2x2", 8, 4, PAPER_CNN_PARAMS, "float32",
             "panel", True),
            ("sentinel slots", 16, 4, 2100, "float32", "random", True),
            ("all-sentinel rows", 6, 3, 40, "float32", "sentinel", True),
            ("duplicate indices", 16, 4, 2100, "float32", "zeros", True),
            ("B > N", 5, 7, 33, "float32", "random", True),
            ("ragged P, bf16", 9, 5, 1001, "bfloat16", "random", True),
            # the one-column path (odd P) past a group of kSlots = 4 peer
            # rows, and past a staged chunk of 64 slots
            ("odd P, B 11 > kSlots", 5, 11, 1001, "float32", "random",
             True),
            ("B 70 > kChunk, bf16", 6, 70, 2002, "bfloat16", "random",
             True)]
# K3 cases: (name, M, N, K, P, index table). The main path's: the top-k
# payload of (32, 62006) rows at topk_frac 0.1.
K3_CASES = [("main", 32, 32, 6201, PAPER_CNN_PARAMS, "topk"),
            ("duplicate indices", 12, 12, 300, 900, "duplicates"),
            ("-1 pads", 12, 12, 300, 900, "pads"),
            ("K, P off the tile", 7, 5, 33, 1000, "topk"),
            ("M > 32 rows", 40, 9, 77, 515, "duplicates"),
            # the bucketing design's edges: one tile holding every entry
            # (buckets of 200, duplicates across 32-entry steps), K > P,
            # P over one bucketing window of 256 tiles (4 windows), and a
            # window of more entries than shared memory stages (24,576)
            ("every entry in one tile", 4, 4, 200, 1000, "one tile"),
            ("K > P", 5, 5, 300, 100, "duplicates"),
            ("4 bucketing windows", 4, 3, 5000, 200_000, "topk"),
            ("a window past the shared-memory stage", 3, 2, 30_000, 5000,
             "duplicates")]

# K5 cases: (name, b, l, H, p, n, chunk, dlogA, h0, layout). The first
# is the serve run's prefill scan (mamba2-370m, batch 4, prompt 512: 32
# heads of 64, state 128, chunk 256), with dlogA as the model makes it
# ("model": dt = softplus(normal logits), A = -1 at init, x scaled by
# dt); "kernels" draws as tests/test_kernels.py does. Layout "xBC": x, B
# and C as column slices of one (b, l, H p + 2n) tensor, as mamba_block
# passes B and C (row stride 2,304 floats at the serve width); "offset":
# x, B and C one float into their buffers, off 16-byte alignment, so the
# kernels copy by element. No bf16 case: the kernels take float32 only
# (csrc/ssd.cu).
K5_CASES = [("serve", 4, 512, 32, 64, 128, 256, "model", False, None),
            ("test_kernels 1", 1, 128, 2, 16, 8, 32, "kernels", False, None),
            ("test_kernels 2", 2, 256, 4, 32, 16, 64, "kernels", False,
             None),
            ("test_kernels 3, one chunk", 1, 64, 1, 64, 32, 64, "kernels",
             False, None),
            ("reduced model", 2, 64, 16, 32, 16, 32, "model", False, None),
            ("one ragged chunk, l 100", 2, 100, 8, 64, 128, 256, "model",
             False, None),
            ("h0", 2, 256, 4, 32, 16, 64, "kernels", True, None),
            ("p 128, n 64, h0", 1, 256, 4, 128, 64, 128, "model", True,
             None),
            ("8 chunks", 1, 2048, 32, 64, 128, 256, "model", False, None),
            ("serve, B/C views of xBC", 4, 512, 32, 64, 128, 256, "model",
             False, "xBC"),
            ("h0, one chunk", 2, 64, 4, 32, 16, 64, "kernels", True, None),
            ("p 24, n 4", 2, 192, 3, 24, 4, 64, "model", True, None),
            ("p 10, 4-byte copies", 2, 128, 3, 10, 12, 64, "model", True,
             "offset")]
#: the K5 cases timed (the first is the serve shape)
K5_TIMED = ("serve", "8 chunks")
K5_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_kernels.py
# K6 cases: (name, B, S, W, inputs, h0). The first is the serve run's
# prefill recurrence (recurrentgemma-9b, batch 4, prompt 512, lru width
# 4096) with a and b as the model makes them ("model": a = u^r with u
# uniform on [0.9, 0.999) per channel, Griffin's init, and r a sigmoid;
# b = sqrt(1 - a^2) i v with i a sigmoid); "kernels" draws as
# tests/test_kernels.py does (a = sigmoid(normal) * 0.2 + 0.79, or
# * 0.5 + 0.49 in its case without h0; b = normal * 0.1). No bf16 case:
# the kernel takes float32 only (csrc/rglru_scan.cu).
K6_CASES = [("serve", 4, 512, 4096, "model", False),
            ("test_kernels 1", 1, 128, 256, "kernels", True),
            ("test_kernels 2", 2, 256, 512, "kernels", True),
            ("test_kernels 3", 3, 64, 128, "kernels", True),
            ("test_kernels, no h0", 2, 128, 128, "wide", False),
            ("ragged S 200, W 100", 2, 200, 100, "kernels", True),
            ("S = 1, h0", 4, 1, 4096, "model", True),
            ("B W under one block", 1, 33, 40, "kernels", False)]
K6_TOL = 1e-4   # tests/test_kernels.py (atol)
# K4 backward cases: (name, B, Sq, Sk, Hq, Hkv, hd, causal, window). The
# first is the train run's (qwen3-0.6b, batch 8, sequence 512, one head
# split); the second recurrentgemma-9b's at the same batch and sequence
# (hd 256, one KV head, its window of 2,048: 8 splits of the group); then
# its head at a window of 64 (16 splits), h2o-danube-1.8b's (hd 80, 32/8
# heads) at a window, a ragged S that no tile of 32 or 64 divides, Sq <
# Sk (keys no row sees), non-causal, hd 176 (the first head size with one
# stage of Q and dO) at a window, hd 224 non-causal with Sq < Sk, and S
# 4096 at a window of 512, whose scratch walks the keys in 4 slabs (query
# tiles that see no key of the first)
K4_BWD_CASES = [("train", 8, 512, 512, 16, 8, 128, True, None),
                ("hybrid", 4, 512, 512, 16, 1, 256, True, 2048),
                # internvl2-2b's train step (B 8, 256 vision positions and
                # 512 tokens) and qwen3-moe-30b-a3b's (B 4, 32/4 heads)
                ("vlm train", 8, 768, 768, 16, 8, 128, True, None),
                ("moe train", 4, 512, 512, 32, 4, 128, True, None),
                ("hd 256, Hkv 1, window 64", 1, 256, 256, 16, 1, 256, True,
                 64),
                ("hd 80, 32/8 heads, window 128", 2, 384, 384, 32, 8, 80,
                 True, 128),
                ("ragged S = 200", 2, 200, 200, 16, 8, 128, True, None),
                ("Sq 128, Sk 256", 2, 128, 256, 16, 8, 128, True, None),
                ("non-causal", 2, 256, 256, 16, 8, 128, False, None),
                ("hd 176, 8/2 heads, window 100", 2, 300, 300, 8, 2, 176,
                 True, 100),
                ("hd 224, non-causal, Sq 200, Sk 260", 1, 200, 260, 8, 1,
                 224, False, None),
                ("S 4096, window 512, 4 slabs", 1, 4096, 4096, 16, 4, 64,
                 True, 512),
                # whisper-medium's train step (B 8, 448 tokens, 16 heads of
                # 64): the encoder's non-causal self-attention over 1,500
                # frames (5 slabs of 320 keys, the last 220, a ragged
                # tile), the cross-attention (slabs of 1,152 and 348
                # keys), the decoder's causal self-attention (one slab)
                ("whisper encoder train, non-causal", 8, 1500, 1500, 16, 16,
                 64, False, None),
                ("whisper cross train, non-causal", 8, 448, 1500, 16, 16, 64,
                 False, None),
                ("whisper decoder self train", 8, 448, 448, 16, 16, 64, True,
                 None)]
# the K4 backward cases timed: the train runs' (qwen3-0.6b,
# recurrentgemma-9b, internvl2-2b, qwen3-moe-30b-a3b, whisper-medium's
# encoder)
K4_BWD_TIMED = ("train", "hybrid", "vlm train", "moe train",
                "whisper encoder train, non-causal")
# each of dq, dk, dv against the plain version's, as a share of that
# gradient's largest element (tests/test_torch_cuda.py): fp32 sums over
# up to 512 keys (queries and heads) in another order than cuBLAS's
K4_BWD_TOL = 1e-4
# the forward's row log-sum-exp against torch.logsumexp of the plain
# scores (atol = rtol)
K4_LSE_TOL = 1e-5
# K4's bf16 backward (csrc/flash_attention_bwd_bf16.cu), in bf16 at the
# three shapes of bf16 training's main path, every one timed: qwen3-0.6b's
# train shape, whisper-medium's encoder (non-causal, 1,500 keys in one
# pass) and recurrentgemma-9b's (one KV head of 256, 8 head splits,
# window 2,048)
K4_BWD_BF16_CASES = [("train bf16", 8, 512, 512, 16, 8, 128, True, None),
                     ("whisper encoder train bf16", 8, 1500, 1500, 16, 16,
                      64, False, None),
                     ("hybrid bf16", 4, 512, 512, 16, 1, 256, True, 2048)]
# dq, dk, dv against the plain version's in bf16 (the autograd of the
# plain attention with `repro`'s cast points), each as a share of that
# gradient's largest element (tests/test_torch_cuda.py): both round each
# gradient to bf16 once (2^-8 of itself, an ulp on a rounding boundary),
# and D reads the bf16 out where the plain autograd sums P dP (PR 33's
# first chip run: at most 9.0e-3)
K4_BWD_BF16_TOL = 2e-2
# K5 backward cases: (name, b, l, H, p, n, chunk, inputs, h0, dh_last,
# layout), inputs and layout as in K5_CASES. The first is the train run's
# (mamba2-370m, batch 8, sequence 512: two chunks, no h0, and no dh_last,
# which the loss does not read); then h0 with a nonzero dh_last, one
# chunk, eight chunks, x / B / C as views of one projection at the train
# width, inputs off 16-byte alignment (p 10, one float in), p 128, 9
# heads (a dx block of one head; second W and state head groups of one
# head) and 17 (three groups). The train case and the 8-chunk
# one are timed: the design is held to many chunks with a state at both
# ends as well as to the train run's two
K5_BWD_CASES = [
    ("train", 8, 512, 32, 64, 128, 256, "model", False, False, None),
    ("h0, dh_last", 2, 256, 4, 32, 16, 64, "kernels", True, True, None),
    ("one chunk, h0, dh_last", 2, 64, 4, 32, 16, 64, "kernels", True, True,
     None),
    ("8 chunks, h0, dh_last", 1, 2048, 32, 64, 128, 256, "model", True, True,
     None),
    ("train, x/B/C views of xBC", 8, 512, 32, 64, 128, 256, "model", False,
     False, "xBC"),
    ("p 10, 4-byte copies", 2, 128, 3, 10, 12, 64, "model", True, True,
     "offset"),
    ("p 128, n 64, h0", 1, 256, 4, 128, 64, 128, "model", True, False, None),
    ("9 heads, dh_last", 2, 192, 9, 16, 8, 64, "model", False, True, None),
    ("17 heads, h0, dh_last", 1, 192, 17, 8, 8, 64, "model", True, True,
     None)]
K5_BWD_TIMED = ("train", "8 chunks, h0, dh_last")
# the backward's six kernels, by the profiler's names (group 1 the key)
K5_BWD_KERNELS = r"\bssd_bwd_(chunk|pass|state|dx|w|final)_kernel\b"
# each of dx, d dlogA, dB, dC and dh0 against the plain version's, as a
# share of that gradient's largest element: fp32 sums over 256 positions
# and 32 heads in other orders than autograd's; d dlogA's row and column
# sums nearly cancel, so it is held to its largest element, not
# elementwise (tests/test_torch_cuda.py)
K5_BWD_TOL = 1e-4
# K6 backward cases: (name, B, S, W, inputs, h0, dh_last), inputs as in
# K6_CASES. The first is the train run's (recurrentgemma-9b, batch 4,
# sequence 512, lru width 4096; no h0, and no dh_last); then ragged S and
# W with and without h0 and dh_last, and one step
K6_BWD_CASES = [("train", 4, 512, 4096, "model", False, False),
                ("ragged S 200, W 100, h0, dh_last", 2, 200, 100, "kernels",
                 True, True),
                ("ragged, no h0", 2, 200, 100, "kernels", False, True),
                ("ragged, no dh_last", 2, 200, 100, "kernels", True, False),
                ("S = 1, h0, dh_last", 4, 1, 4096, "model", True, True)]
K6_BWD_TIMED = ("train",)
# K7, PaperCNN's convolution stack: (label, G, B, image, cin, c1, c2). The
# dense cell's reward call (400 probe models x 50 validation images, the
# weights views of one probe panel as `make_reward_fn` hands them over;
# timed), image 16, the tests' narrow widths, one input channel, one
# image, and G and B that no tile divides (a block takes at most 4
# images). Held to the plain version in float64 within K7_TOL of the
# largest feature: each output sums 75 or 150 fp32 products in another
# order
K7_CASES = [("reward call", 400, 50, 32, 3, 6, 16),
            ("image 16", 7, 5, 16, 3, 6, 16),
            ("narrow", 6, 8, 16, 3, 4, 8),
            ("1 channel", 5, 6, 32, 1, 6, 16),
            ("narrow 1 channel", 3, 7, 16, 1, 4, 8),
            ("one image", 9, 1, 32, 3, 6, 16),
            ("ragged", 13, 9, 32, 3, 6, 16)]
K7_TOL = 1e-5
# the K6 backward rounds each product and sum in the plain version's
# order (every sum has two terms): bit for bit, checked with torch.equal
# The training path: `repro_torch.launch.train.main` at qwen3-0.6b's
# published config (28 layers, float32), batch 8, sequence 512, 10 steps
TRAIN_ARGV = ["--arch", "qwen3-0.6b", "--steps", "10", "--batch", "8",
              "--seq", "512"]
# and at mamba2-370m's (48 Mamba2 layers, float32), batch 8, sequence
# 512 (two chunks of 256), 10 steps
TRAIN_SSM_ARGV = ["--arch", "mamba2-370m", "--steps", "10", "--batch", "8",
                  "--seq", "512"]
# recurrentgemma-9b at full width cut in depth only: its first 6 layers
# (two whole (rec, rec, attn) segments: 4 RG-LRU and 2 attention blocks)
# with the full embedding, untied head and final norm, 2.81 B weights
# (45 GB with gradients and AdamW's moments: the whole model's 104 GB
# does not fit one card), batch 4, sequence 512, 10 steps, through
# `launch.train.train` from the init of PRNGKey(0)
TRAIN_HYBRID = dict(arch="recurrentgemma-9b", n_layers=6, batch=4, seq=512,
                    steps=10, lr=3e-4)
# internvl2-2b at full width on 12 of its 24 layers (cut from 24 to keep
# the script under 800 s), batch 8, sequence 512 behind 256 vision
# embeddings (768 positions) from `make_vision`, the same at every step,
# 10 steps, through `launch.train.train`. Not `main`'s zero embeddings:
# at full depth they give non-finite gradients in `repro` as in the port
# (each RMS norm of a zero row scales its gradient by 1/sqrt(1e-6), and
# 48 norms overflow fp32; tests/test_torch_lm_families.py)
TRAIN_VLM = dict(arch="internvl2-2b", n_layers=12, batch=8, seq=512,
                 steps=10, lr=3e-4)
# qwen3-moe-30b-a3b at full width on its first 2 layers (1.87 B weights,
# 29.9 GB with gradients and moments), batch 4, sequence 512, 10 steps
TRAIN_MOE = dict(arch="qwen3-moe-30b-a3b", n_layers=2, batch=4, seq=512,
                 steps=10, lr=3e-4)
# whisper-medium at full width on 12 of its 24 encoder and 24 decoder
# layers (cut from 24 to keep the script under 800 s), batch 8, sequence
# 448 (whisper's 448 text positions: tokens (8, 449)) after 1,500 frames
# from `make_frames`, the same at every step, 10 steps, through
# `launch.train.train`
# qwen3-0.6b whole at bf16, `repro`'s default dtype (bf16 weights,
# gradients and activations, AdamW's moments fp32), through
# `launch.train.train`: K4's bf16 forward and backward every step
TRAIN_BF16 = dict(arch="qwen3-0.6b", n_layers=28, batch=8, seq=512,
                  steps=10, lr=3e-4, dtype="bfloat16")
TRAIN_AUDIO = dict(arch="whisper-medium", n_layers=12, batch=8, seq=448,
                   steps=10, lr=3e-4)
# Card against CPU and against JAX, each family on the training loop
# (`launch.train.train`) for 3 steps at lr 3e-4 from the init of
# PRNGKey(0), keyed by the tools/jax_reference_smoke.py name that runs it
# in JAX: qwen3-0.6b at full width cut to its first two layers (the full
# embedding, tied head and final norm), batch 2, sequence 128;
# mamba2-370m at full width cut to two layers, batch 2, sequence 512 (two
# chunks of 256, so the backward's reverse state pass runs); and
# recurrentgemma-9b's reduced config (rec, rec, attn at width 256, its
# window of 32 binding at 128 positions), batch 2, sequence 128: at full
# width even three layers would hold some 40 GB of state on the JAX side
CROSS_TRAINS = {
    "train-cross": dict(arch="qwen3-0.6b", n_layers=2, batch=2, seq=128,
                        steps=3, lr=3e-4),
    "train-cross-ssm": dict(arch="mamba2-370m", n_layers=2, batch=2,
                            seq=512, steps=3, lr=3e-4),
    "train-cross-hybrid": dict(arch="recurrentgemma-9b", reduced=True,
                               batch=2, seq=128, steps=3, lr=3e-4),
    # internvl2-2b at full width cut to two layers (its 256 zero vision
    # embeddings before the 128 tokens, as `launch.train` feeds them),
    # and qwen3-moe-30b-a3b's reduced config (4 experts top 2 at width
    # 256), whose capacity of 160 copies an expert drops copies of the
    # 512 that B 2, S 128 route
    "train-cross-vlm": dict(arch="internvl2-2b", n_layers=2, batch=2,
                            seq=128, steps=3, lr=3e-4),
    "train-cross-moe": dict(arch="qwen3-moe-30b-a3b", reduced=True,
                            batch=2, seq=128, steps=3, lr=3e-4),
    # whisper-medium at full width cut to 2 encoder and 2 decoder layers,
    # its 1,500 zero frames as `launch.train` feeds them
    "train-cross-audio": dict(arch="whisper-medium", n_layers=2,
                              n_enc_layers=2, batch=2, seq=128, steps=3,
                              lr=3e-4),
    # qwen3-0.6b's cut run at bf16 (`repro`'s default dtype: bf16 weights,
    # gradients and activations, AdamW's moments fp32), K4's bf16 forward
    # and backward on the card
    "train-cross-bf16": dict(arch="qwen3-0.6b", n_layers=2, batch=2,
                             seq=128, steps=3, lr=3e-4, dtype="bfloat16")}
# the JAX reference's losses of those runs (tools/jax_reference_smoke.py
# train-cross train-cross-ssm train-cross-hybrid train-cross-vlm
# train-cross-moe train-cross-audio train-cross-bf16, on the CPU)
CROSS_TRAIN_JAX_LOSSES = {
    "train-cross": [12.067048072814941, 12.131933212280273,
                    12.170770645141602],
    "train-cross-ssm": [11.39367389678955, 11.2791748046875,
                        11.313643455505371],
    "train-cross-hybrid": [6.733729362487793, 6.728228569030762,
                           6.701728820800781],
    "train-cross-vlm": [11.865507125854492, 12.00423812866211,
                        11.906243324279785],
    "train-cross-moe": [6.785251140594482, 6.8302788734436035,
                        6.734958171844482],
    "train-cross-audio": [11.074835777282715, 11.003856658935547,
                          10.927026748657227],
    "train-cross-bf16": [12.066932678222656, 12.132614135742188,
                         12.170795440673828]}
# losses (atol) and step-0 gradients (each leaf as a share of its
# largest element): fp32 sums over the vocabulary's logits and the
# positions in other orders (card, CPU, XLA)
CROSS_TRAIN_LOSS_TOL = 1e-4
CROSS_TRAIN_GRAD_TOL = 1e-4
# the bf16 cut run's (train-cross-bf16): each activation rounded to bf16
# lands on one side of a rounding boundary or the other, so card, CPU
# and XLA differ by the bf16 noise; tests/test_torch_bf16.py's tolerances
# for the reduced families (PR 33's probe on an NVIDIA H100 80GB HBM3 at
# 700 W: losses at most 3.7e-4 apart, step-0 gradients 0.028 of a leaf's
# largest element)
CROSS_TRAIN_BF16_LOSS_TOL = 5e-3
CROSS_TRAIN_BF16_GRAD_TOL = 5e-2
# the DPFL mix of that model's weights: 4 clients
DPFL_MIX_CLIENTS = 4
# The LM examples (examples/lm_dpfl_torch.py, serve_personalized_torch.py)
# run K4 under torch.func.vmap over the clients, folded into its batch
# axis. K4 vmapped, (name, clients, B, S, Hq, Hkv, hd) in fp32: at
# qwen3-0.6b's heads (16 query and 8 KV heads of 128) lm-dpfl's local
# step at full width (4 clients of batch 8, 32 tokens) and the
# personalized prefill (4 requests of one 512-token prompt); at the
# example's reduced qwen3 (2/2 heads of 32, a body of its own in K4's
# forward and backward) its local step (6 clients of batch 8) and its
# reward call (4 probe models for each of 6 clients, 12 sequences each)
K4_VMAP_CASES = (("lm-dpfl", 4, 8, 32, 16, 8, 128),
                 ("personalized prefill", 4, 1, 512, 16, 8, 128),
                 ("lm-dpfl example local step", 6, 8, 32, 2, 2, 32),
                 ("lm-dpfl example reward", 24, 12, 32, 2, 2, 32))
# lm-dpfl at qwen3-0.6b's published widths (d_model 1024, 16/8 heads of
# 128, d_ff 3072, vocab 151,936, qk-norm, tied), cut to 2 of its 28
# layers and 4 clients (2 a corpus cluster; the example has 6): P =
# 187,045,376 (748 MB) a client, and the dense greedy's (N, 4, P) probes
# with some seven (N, P) temporaries take about 33 GB beside the round's
# 18 at N = 4 (about 49 + 27 GB at 6). The corpus keeps the example's 256
# token ids: its bigram tables are vocab^2 entries (369 GB at the model's
# vocabulary)
LM_DPFL_FULL = dict(arch="qwen3-0.6b", n_layers=2, clients=4)
# The lm-dpfl full-width run's peak of allocated memory with a round step
# that allocated its outputs (no donation), as kept in PERF.md §5 (NVIDIA
# H100 80GB HBM3): printed beside this run's, with the plain step's
# peak measured in the same run.
LM_DPFL_FULL_PLAIN_PEAK_GB = 70.7
# personalized serving on the whole published qwen3-0.6b (28 layers,
# float32): the example's 3 clients (weights drawn from split(PRNGKey(0),
# 3)) and its 4 requests' clients, each request a 512-token prompt drawn
# from a seed, 32 new tokens
PERSONALIZED_RUN = dict(arch="qwen3-0.6b", prompt_len=512, new_tokens=32,
                        seed=3)

def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_rates(name: str):
    """The card's row of the port's hardware table
    (`repro_torch.roofline.analysis.CARDS`: HBM bytes/s, fp32 FLOP/s
    outside the tensor cores, dense bf16 FLOP/s on the tensor cores, SMs,
    one NVLink direction, memory; NVIDIA data sheets), which the dry run
    reads too. A bound takes the rate of its inputs' type: a kernel on
    bf16 inputs could use the tensor cores."""
    from repro_torch.roofline.analysis import card_for

    rates = card_for(name)
    if rates is None:
        fail(f"no published rates for {name!r}: the port targets Hopper")
    return rates


def _close(torch, label, got, want, tol, rtol=None):
    """Max abs error of ``got`` against ``want``; fails beyond atol
    ``tol`` and rtol ``rtol`` (default ``tol``)."""
    rtol = tol if rtol is None else rtol
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: got {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=rtol):
        fail(f"{label}: max abs err {err} over atol={tol} rtol={rtol}")
    return err


def _bound(rates, nbytes, flops, dtype):
    """The least time (ms) for ``nbytes`` of memory traffic and ``flops``
    on inputs of ``dtype``, and which of the two binds."""
    peak = rates[2] if dtype == "bfloat16" else rates[1]
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, torch, reps: int = 50, warmup: int = 10) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events.
    Before each run a 64 MiB write evicts the 50 MB L2 (the round loop
    finds W after local training has streamed activations through it),
    and a spin kernel holds the card while the host enqueues the events
    and ``fn``'s launches, so the interval holds device time only, not
    the host's launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(torch):
    """Seeded (A, W) on the card for every K1 shape: A row-stochastic
    like the Eq.-4 matrix, W normal in the shape's dtype (as a view one
    element into a larger buffer where the shape says so)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for M, N, P, dt, offset in K1_SHAPES:
        A = torch.rand((M, N), generator=gen, device="cuda")
        A = A / A.sum(dim=1, keepdim=True)
        W = torch.randn((N, P), generator=gen,
                        device="cuda").to(getattr(torch, dt))
        if offset:
            buf = torch.empty(N * P + 1, dtype=W.dtype, device="cuda")
            W = buf.narrow(0, 1, N * P).view(N, P).copy_(W)
        out.append((M, N, P, dt, A, W))
    return out


def check_k1(torch, inputs):
    """K1 against its plain version at every shape, and a repeated call
    bit for bit (fixed summation order); returns the max abs error per
    shape and the vector widths reached."""
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import ref

    errs, widths = [], {}
    for M, N, P, dt, A, W in inputs:
        label = f"K1 {M}x{N}@{N}x{P} {dt} (W at {W.data_ptr() % 16} mod 16)"
        got = k1.graph_mix(A, W)
        errs.append(_close(torch, label, got, ref.graph_mix_ref(A, W),
                           TOL[dt]))
        if not torch.equal(got, k1.graph_mix(A, W)):
            fail(f"{label}: a repeated call gave other bits")
        cols = k1.vector_width(P, W.element_size(), W.data_ptr())
        widths.setdefault((dt, cols), []).append(P)
    if {c for _, c in widths} != set(k1.WIDTHS):
        fail(f"K1 shapes reach vector widths {sorted(widths)}, not all of "
             f"{k1.WIDTHS}")
    return errs, widths


def time_k1(torch, inputs, errs, rates):
    """K1, its plain version and the yardstick matmul timed at every
    shape, beside the bound; returns the rows."""
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import ref

    rows = []
    for (M, N, P, dt, A, W), err in zip(inputs[:K1_TIMED], errs):
        ms = time_ms(lambda: k1.graph_mix(A, W), torch)
        plain_ms = time_ms(lambda: ref.graph_mix_ref(A, W), torch)
        lib_ms = (time_ms(lambda: torch.matmul(A, W), torch)
                  if dt == "float32" else None)
        nbytes, flops = k1.work(M, N, P, W.element_size())
        bound_ms, bound_by = _bound(rates, nbytes, flops, dt)
        rows.append(dict(M=M, N=N, P=P, dtype=dt, max_abs_err=err,
                         tol=TOL[dt], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops))
        print(f"  K1 {M:>2}x{N:>2} @ {N:>2}x{P:<6} {dt:<8} err {err:.3g} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"matmul {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
              f"  bound {bound_ms:.4f} ms")
    return rows


def k2_inputs(torch):
    """Seeded K2 inputs on the card for every case: (name, dtype, self_w,
    nbr_w, idx, W_self, W_peers)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for name, N, B, P, dt, table, separate in K2_CASES:
        if table == "lists":
            # B distinct peers per client, ascending, none of them itself
            # (what the budget-constrained greedy emits)
            pick = torch.rand((N, N), generator=gen, device="cuda")
            pick.fill_diagonal_(2.0)
            idx = torch.sort(torch.argsort(pick, dim=1)[:, :B], dim=1).values
        elif table == "random":
            idx = torch.randint(-1, N, (N, B), generator=gen, device="cuda")
        elif table == "zeros":
            idx = torch.zeros((N, B), dtype=torch.int64, device="cuda")
        elif table == "panel":
            # about half the slots on this panel, row 0 with none
            idx = torch.randint(0, N, (N, B), generator=gen, device="cuda")
            off = torch.rand((N, B), generator=gen, device="cuda") < 0.5
            off[0] = True
            idx = torch.where(off, -1, idx)
        else:
            idx = torch.full((N, B), -1, dtype=torch.int64, device="cuda")
        idx = idx.to(torch.int32)
        sw = torch.rand((N,), generator=gen, device="cuda")
        nw = torch.rand((N, B), generator=gen, device="cuda")
        nw = torch.where(idx >= 0, nw, 0.0)
        denom = sw + nw.sum(dim=1)
        sw, nw = sw / denom, nw / denom[:, None]
        if table == "panel":
            sw = torch.zeros_like(sw)     # the self term is offset 0's
        dtype = getattr(torch, dt)
        W = torch.randn((N, P), generator=gen, device="cuda").to(dtype)
        Wp = (torch.randn((N, P), generator=gen, device="cuda").to(dtype)
              if separate else W)
        out.append((name, dt, sw, nw.contiguous(), idx, W, Wp))
    return out


def k3_inputs(torch):
    """Seeded K3 inputs on the card for every case: (name, A, vals, idx,
    P), A row-stochastic with a zero diagonal as the caller passes it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for name, M, N, K, P, table in K3_CASES:
        A = torch.rand((M, N), generator=gen, device="cuda")
        A = A / A.sum(dim=1, keepdim=True)
        A = A * (1.0 - torch.eye(M, N, device="cuda"))
        x = torch.randn((N, P), generator=gen, device="cuda")
        if table == "topk":
            idx = torch.topk(x.abs(), K, dim=1).indices
            vals = x.gather(1, idx)
        elif table == "one tile":
            idx = torch.randint(256, 512, (N, K), generator=gen,
                                device="cuda")
            vals = torch.randn((N, K), generator=gen, device="cuda")
        else:
            # few distinct columns per row, so indices repeat
            idx = torch.randint(0, max(1, P // 8), (N, K), generator=gen,
                                device="cuda") * 8
            vals = torch.randn((N, K), generator=gen, device="cuda")
            if table == "pads":
                idx = torch.where(torch.rand((N, K), generator=gen,
                                             device="cuda") < 0.3, -1, idx)
        out.append((name, A.contiguous(), vals.contiguous(),
                    idx.to(torch.int32).contiguous(), P))
    return out


def check_k2(torch, inputs):
    """K2 against its plain version in every case, and a repeated call
    bit for bit (slots added in a fixed order); returns the max abs
    error per case and the vector widths reached."""
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_graph_mix as k2

    errs, widths = [], set()
    for name, dt, sw, nw, idx, W, Wp in inputs:
        got = k2.sparse_graph_mix(sw, nw, idx, W, Wp)
        errs.append(_close(torch, f"K2 {name} {dt}", got,
                           ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp),
                           TOL[dt]))
        if not torch.equal(got, k2.sparse_graph_mix(sw, nw, idx, W, Wp)):
            fail(f"K2 {name} {dt}: a repeated call gave other bits")
        widths.add(k1.vector_width(W.shape[1], W.element_size(),
                                   W.data_ptr(), Wp.data_ptr()))
    if widths != set(k1.WIDTHS):
        fail(f"K2 cases reach vector widths {sorted(widths)}, not all of "
             f"{k1.WIDTHS}")
    return errs


def check_k3(torch, inputs):
    """K3 against its plain version in every case, a repeated call bit
    for bit (no atomics), and its bucketing pass exactly equal to the
    pass's plain version; plus the exact duplicate-index case of
    tests/test_kernels.py. Returns the max abs error per case."""
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import ref

    errs = []
    for name, A, vals, idx, P in inputs:
        got = k3.compressed_graph_mix(A, vals, idx, P)
        errs.append(_close(torch, f"K3 {name}", got,
                           ref.compressed_graph_mix_ref(A, vals, idx, P),
                           TOL["float32"]))
        if not torch.equal(got, k3.compressed_graph_mix(A, vals, idx, P)):
            fail(f"K3 {name}: a repeated call gave other bits")
        bucketed = k3.bucket_payload(vals, idx, P)
        want = ref.bucket_payload_ref(vals, idx, P, k3.TILE)
        if not all(torch.equal(g, w) for g, w in zip(bucketed, want)):
            fail(f"K3 {name}: the bucketing pass differs from its plain "
                 f"version")
    got = k3.compressed_graph_mix(
        torch.eye(2, device="cuda"),
        torch.tensor([[1.0, 2.0, 4.0], [0.5, 0.25, 0.125]], device="cuda"),
        torch.tensor([[3, 3, 0], [1, 1, 1]], dtype=torch.int32,
                     device="cuda"), 5)
    want = torch.tensor([[4.0, 0, 0, 3.0, 0], [0, 0.875, 0, 0, 0]],
                        device="cuda")
    if not torch.equal(got, want):
        fail(f"K3 duplicate indices: {got.tolist()} != {want.tolist()}")
    return errs


def time_k2(torch, inputs, errs, rates):
    """K2, its plain version and the yardstick (`torch.matmul` by the
    equivalent dense (N, N) Eq.-4 matrix, the same function where
    W_peers is W_self) timed at the main path's shapes, beside the bound;
    returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_graph_mix as k2

    rows = []
    for (name, dt, sw, nw, idx, W, Wp), err in zip(inputs, errs):
        if not name.startswith("main"):
            continue
        N, B = idx.shape
        P = W.shape[1]
        ms = time_ms(lambda: k2.sparse_graph_mix(sw, nw, idx, W, Wp), torch)
        plain_ms = time_ms(
            lambda: ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp), torch)
        lib_ms = None
        if Wp is W and dt == "float32":
            A = torch.diag(sw).index_put_(
                (torch.arange(N, device="cuda")[:, None].expand(N, B),
                 idx.clamp_min(0).long()),
                torch.where(idx >= 0, nw, 0.0), accumulate=True)
            lib_ms = time_ms(lambda: torch.matmul(A, W), torch)
        valid = idx >= 0
        peer_rows = 0 if Wp is W else int(torch.unique(idx[valid]).numel())
        nbytes, flops = k2.work(N, B, P, W.element_size(),
                                int(valid.sum()), peer_rows)
        bound_ms, bound_by = _bound(rates, nbytes, flops, dt)
        rows.append(dict(case=name, N=N, B=B, P=P, dtype=dt,
                         max_abs_err=err, tol=TOL[dt], ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, flops=flops))
        print(f"  K2 {name:<18} ({N}, {B}, {P}) {dt:<8} err {err:.3g} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  matmul "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
              f"bound {bound_ms:.4f} ms")
    return rows


def time_k3(torch, inputs, errs, rates):
    """K3 (both launches: the bucketing pass and the mix, as the main path
    pays them), its plain version and the yardstick (`torch.sparse.mm`
    of the payload as
    a sparse COO (P, N) matrix by A^T, the sparse tensor built outside
    the timed window) at the main path's shape, beside the bound; returns
    the rows."""
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import ref

    rows = []
    for (name, A, vals, idx, P), err in zip(inputs, errs):
        if name != "main":
            continue
        M, N = A.shape
        K = vals.shape[1]
        ms = time_ms(lambda: k3.compressed_graph_mix(A, vals, idx, P),
                     torch)
        # the split: the bucketing pass alone, the mix kernel alone
        bucket_ms = time_ms(lambda: k3.bucket_payload(vals, idx, P), torch)
        bucketed = k3.bucket_payload(vals, idx, P)
        kernel_ms = time_ms(lambda: k3.launch_bucketed(A, *bucketed, P),
                            torch)
        plain_ms = time_ms(
            lambda: ref.compressed_graph_mix_ref(A, vals, idx, P), torch)
        cols = torch.arange(N, device="cuda")[:, None].expand(N, K)
        S = torch.sparse_coo_tensor(
            torch.stack([idx.reshape(-1).long(), cols.reshape(-1)]),
            vals.reshape(-1), (P, N), check_invariants=False).coalesce()
        At = A.t().contiguous()
        lib_ms = time_ms(lambda: torch.sparse.mm(S, At), torch)
        entries = int((idx >= 0).sum())
        nbytes, flops = k3.work(M, N, K, P, entries)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        rows.append(dict(case=name, M=M, N=N, K=K, P=P, dtype="float32",
                         max_abs_err=err, tol=TOL["float32"], ms=ms,
                         bucket_ms=bucket_ms, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, flops=flops))
        print(f"  K3 {name:<18} ({M}, {N}, {K}, {P}) err {err:.3g} "
              f"bucket+kernel {ms:.4f} ms (bucket {bucket_ms:.4f}, kernel "
              f"{kernel_ms:.4f})  plain {plain_ms:.4f} ms  "
              f"sparse.mm {lib_ms:.4f} ms  bound {bound_ms:.4f} ms")
    return rows


def k4_inputs(torch):
    """Seeded (name, dtype, causal, window, q, k, v) on the card for every
    K4 case, q and k scaled by 0.5 as in tests/test_kernels.py."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for name, B, Sq, Sk, Hq, Hkv, hd, causal, window, dt in K4_CASES:
        def draw(S, H, scale):
            return (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                    * scale).to(getattr(torch, dt))
        out.append((name, dt, causal, window, draw(Sq, Hq, 0.5),
                    draw(Sk, Hkv, 0.5), draw(Sk, Hkv, 1.0)))
    return out


def check_k4(torch, inputs):
    """K4 against its plain version in every case, bf16 also against the
    fp32 plain version on the same inputs (K4_BF16_FP32_TOL), and a
    repeated call bit for bit (no atomics); returns the max abs error per
    case, and per bf16 case (None for fp32) the max abs error against
    fp32 and the largest share of its limit, |err| / (atol + rtol |ref|),
    that any element used."""
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    atol, rtol = K4_BF16_FP32_TOL
    errs, against_fp32 = [], []
    for name, dt, causal, window, q, k, v in inputs:
        kw = dict(causal=causal, window=window)
        got = k4.flash_attention(q, k, v, **kw)
        errs.append(_close(torch, f"K4 {name} {dt}", got,
                           ref.flash_attention_ref(q, k, v, **kw),
                           K4_TOL[dt]))
        if not torch.equal(got, k4.flash_attention(q, k, v, **kw)):
            fail(f"K4 {name} {dt}: a repeated call gave other bits")
        if dt == "float32":
            against_fp32.append(None)
            continue
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       **kw)
        err = _close(torch, f"K4 {name} bf16 against fp32", got.float(),
                     want, atol, rtol)
        share = ((got.float() - want).abs() / (atol + rtol * want.abs())
                 ).max().item() if want.numel() else 0.0
        against_fp32.append((err, share))
    return errs, against_fp32


def k4_work(q, k, causal, window):
    """(bytes, flops) of a K4 forward call on q (B, Sq, Hq, hd) and k
    (B, Sk, Hkv, hd): `kernels.flash_attention.work`."""
    from repro_torch.kernels import flash_attention as k4

    B, Sq, Hq, hd = q.shape
    return k4.work(B, Sq, k.shape[1], Hq, k.shape[2], hd, causal, window,
                   q.element_size())


def time_k4(torch, inputs, errs, rates):
    """K4, its plain version and the yardstick
    (`scaled_dot_product_attention` with the case's ``is_causal`` and
    ``enable_gqa`` on (B, H, S, hd) views) timed at qwen3-0.6b's serve
    shape, fp32 and bf16, at recurrentgemma-9b's, internvl2-2b's and
    qwen3-moe-30b-a3b's, and at whisper-medium's encoder (non-causal,
    fp32 and bf16) and its decode step's cross-attention (one query row
    against 1,500 keys), beside the bound; returns the rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    rows = []
    for (name, dt, causal, window, q, k, v), err in zip(inputs, errs):
        if "serve" not in name:
            continue
        # the hybrid's window of 2048 does not bind at 512 positions, so
        # the causal SDPA computes the same function there
        kw = dict(causal=causal, window=window)
        ms = time_ms(lambda: k4.flash_attention(q, k, v, **kw), torch)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                           torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), torch)
        lib_err = (F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
            .float() - k4.flash_attention(q, k, v, **kw).float()
        ).abs().max().item()
        nbytes, flops = k4_work(q, k, causal, window)
        bound_ms, bound_by = _bound(rates, nbytes, flops, dt)
        B, S, Hq, hd = q.shape
        rows.append(dict(case=name, B=B, S=S, Sk=k.shape[1], Hq=Hq,
                         Hkv=k.shape[2], hd=hd, causal=causal, window=window,
                         dtype=dt, max_abs_err=err, tol=K4_TOL[dt], ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_max_abs_diff=lib_err, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         tflops=flops / ms / 1e9))
        print(f"  K4 {name:<10} ({B}, {S}, {k.shape[1]}, {Hq}, {k.shape[2]}, "
              f"{hd}, causal {causal}, window {window}) "
              f"{dt:<8} err {err:.3g} kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s)  plain {plain_ms:.4f} ms  "
              f"sdpa {lib_ms:.4f} ms (diff {lib_err:.3g})  bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    return rows


def k4_bwd_inputs(torch):
    """Seeded (name, causal, window, q, k, v, dout) on the card for every
    K4 backward case, q and k scaled by 0.5 as in k4_inputs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for name, B, Sq, Sk, Hq, Hkv, hd, causal, window in K4_BWD_CASES:
        def draw(S, H, scale):
            return torch.randn((B, S, H, hd), generator=gen,
                               device="cuda") * scale
        out.append((name, causal, window, draw(Sq, Hq, 0.5),
                    draw(Sk, Hkv, 0.5), draw(Sk, Hkv, 1.0),
                    draw(Sq, Hq, 1.0)))
    return out


def lse_ref(torch, q, k, causal, window):
    """(B, Hq, Sq) torch.logsumexp of the plain scaled scores, masked as
    K4 masks them (aligned positions, -1e30)."""
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(rep, dim=2)) / math.sqrt(q.shape[3])
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None]
    mask = torch.ones_like(i == j)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    return torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)


def check_k4_bwd(torch, inputs):
    """In every K4 backward case: the forward with its log-sum-exp gives
    the same out bits as without it, and the LSE within K4_LSE_TOL of
    `lse_ref`; the backward's dq, dk and dv within K4_BWD_TOL of the plain
    version's (`ref.flash_attention_bwd_ref`), each as a share of that
    gradient's largest element; a repeated call bit for bit. Returns per
    case (max abs err over the three gradients, the largest share, the
    LSE's max abs err, the launch plan's head splits and slabs)."""
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    out_rows = []
    for name, causal, window, q, k, v, dout in inputs:
        (B, Sq, Hq, hd), (Sk, Hkv) = q.shape, k.shape[1:3]
        plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd,
                                k4._sm_count(q.device.index))
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        if not torch.equal(out, k4.flash_attention(q, k, v, **kw)):
            fail(f"K4 {name}: the forward with its LSE gave other out bits "
                 f"than without")
        lse_err = _close(torch, f"K4 {name} LSE", lse,
                         lse_ref(torch, q, k, causal, window), K4_LSE_TOL)
        got = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        err = share = 0.0
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.abs().max().clamp_min(1e-30)
            _close(torch, f"K4 backward {name} {label} / max |{label}|",
                   g / scale, w / scale, K4_BWD_TOL, 0.0)
            diff = (g - w).abs().max()
            err = max(err, diff.item())
            share = max(share, (diff / scale).item())
        again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K4 backward {name}: a repeated call gave other bits")
        out_rows.append((err, share, lse_err, plan.splits, plan.n_slabs))
    return out_rows


def k4_bwd_work(q, k, causal, window):
    """(bytes, flops) of a K4 backward call: `kernels.flash_attention.
    bwd_work`."""
    from repro_torch.kernels import flash_attention as k4

    B, Sq, Hq, hd = q.shape
    return k4.bwd_work(B, Sq, k.shape[1], Hq, k.shape[2], hd, causal,
                       window, q.element_size())


def kernel_split_ms(fn, torch, pattern, reps: int = 20):
    """Mean device time (ms) a call of each kernel in ``fn()`` whose name
    matches ``pattern`` (its group 1 the key), from torch.profiler's
    kernel records, over ``reps`` calls made as `time_ms` makes them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time_ms(fn, torch, reps=reps, warmup=0)
    out = {}
    for ev in prof.key_averages():
        m = re.search(pattern, ev.key)
        if m and ev.device_type == DeviceType.CUDA:
            out[m.group(1)] = out.get(m.group(1), 0.0) + \
                ev.self_device_time_total / reps / 1e3
    return out


def time_k4_bwd(torch, inputs, errs, rates):
    """K4's backward at the K4_BWD_TIMED shapes (the train run's first),
    its plain version (which runs the plain forward under autograd, then
    its backward) and the yardstick, SDPA's backward (the case's
    ``is_causal``, ``enable_gqa`` on (B, H, S, hd) views, its forward run
    once and its backward repeated; the hybrid's window of 2048 does not
    bind at 512 positions), beside the bound (the train runs' shapes:
    qwen3-0.6b, recurrentgemma-9b, internvl2-2b, qwen3-moe-30b-a3b,
    whisper-medium's encoder); each kernel's device time from the
    profiler; and the forward with and without the LSE. Returns the
    rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    rows = []
    for (name, causal, window, q, k, v, dout), err in zip(inputs, errs):
        if name not in K4_BWD_TIMED:
            continue
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)

        def bwd():
            return k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        ms = time_ms(bwd, torch)
        split = kernel_split_ms(
            bwd, torch,
            r"\bflash_attention_bwd_(delta|dkdv|dq|reduce)_kernel\b")
        if not {"delta", "dkdv", "dq"} <= set(split):
            fail(f"K4 backward: the profiler recorded the kernels "
                 f"{sorted(split)}")
        plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, dout, **kw), torch)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        dt = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, leaves, dt, retain_graph=True), torch)
        lib_grads = torch.autograd.grad(o, leaves, dt)
        lib_diff = max((a.transpose(1, 2) - b).abs().max().item()
                       for a, b in zip(lib_grads, bwd()))
        del o, leaves, lib_grads
        fwd_ms = time_ms(lambda: k4.flash_attention(q, k, v, **kw), torch)
        fwd_lse_ms = time_ms(lambda: k4.flash_attention_with_lse(
            q, k, v, **kw), torch)
        nbytes, flops = k4_bwd_work(q, k, causal, window)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        B, S, Hq, hd = q.shape
        plan = k4.backward_plan(B, S, k.shape[1], Hq, k.shape[2], hd,
                                k4._sm_count(q.device.index))
        print(f"  K4 backward {name} ({B}, {S}, {Hq}, {k.shape[2]}, {hd}, "
              f"causal {causal}, window {window}) float32 err "
              f"{err[0]:.3g} kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s; " + ", ".join(
                  f"{kname} {t:.4f}" for kname, t in split.items()) +
              f" ms a call; {plan.splits} head splits, {plan.n_slabs} "
              f"slabs, scratch {plan.scratch_bytes()} bytes)  plain "
              f"{plain_ms:.4f} ms  sdpa backward {lib_ms:.4f} ms (diff "
              f"{lib_diff:.3g})  bound {bound_ms:.4f} ms ({bound_by}); "
              f"forward at this shape {fwd_ms:.4f} ms, with its LSE "
              f"{fwd_lse_ms:.4f} ms")
        rows.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=k.shape[2], hd=hd,
                         causal=causal, window=window, dtype="float32",
                         max_abs_err=err[0],
                         tol=K4_BWD_TOL, ms=ms, kernel_ms=split,
                         splits=plan.splits, slabs=plan.n_slabs,
                         scratch_bytes=plan.scratch_bytes(),
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_max_abs_diff=lib_diff, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         tflops=flops / ms / 1e9, forward_ms=fwd_ms,
                         forward_lse_ms=fwd_lse_ms))
    return rows


def k4_bwd_bf16_inputs(torch):
    """Seeded (name, causal, window, q, k, v, dout) in bf16 on the card for
    every K4_BWD_BF16_CASES case, q and k scaled by 0.5 as in k4_inputs."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for name, B, Sq, Sk, Hq, Hkv, hd, causal, window in K4_BWD_BF16_CASES:
        def draw(S, H, scale):
            return (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                    * scale).bfloat16()
        out.append((name, causal, window, draw(Sq, Hq, 0.5),
                    draw(Sk, Hkv, 0.5), draw(Sk, Hkv, 1.0),
                    draw(Sq, Hq, 1.0)))
    return out


def check_k4_bwd_bf16(torch, inputs):
    """In every bf16 case: the backward's dq, dk and dv (bf16) within
    K4_BWD_BF16_TOL of the plain version's in bf16, each as a share of
    that gradient's largest element; one launch of the bf16 library a
    call (``flash_attention_bwd_bf16.launches``, none of the fp32 one's);
    a repeated call bit for bit; autograd through ``ops.flash_attention``
    the same bits. Returns per case (max abs err, the largest share,
    each gradient's share)."""
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ops, ref

    rows = []
    for name, causal, window, q, k, v, dout in inputs:
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        before = (k4.flash_attention_bwd.launches,
                  k4.flash_attention_bwd_bf16.launches)
        got = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        if (k4.flash_attention_bwd.launches,
                k4.flash_attention_bwd_bf16.launches) != (before[0],
                                                          before[1] + 1):
            fail(f"K4 bf16 backward {name}: not one launch of the bf16 "
                 f"library")
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        err = share = 0.0
        shares = {}
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
                fail(f"K4 bf16 backward {name} {label}: {g.dtype}")
            scale = w.float().abs().max().clamp_min(1e-30)
            _close(torch, f"K4 bf16 backward {name} {label} / max "
                   f"|{label}|", g.float() / scale, w.float() / scale,
                   K4_BWD_BF16_TOL, 0.0)
            diff = (g.float() - w.float()).abs().max()
            err = max(err, diff.item())
            shares[label] = (diff / scale).item()
            share = max(share, shares[label])
        del want
        again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K4 bf16 backward {name}: a repeated call gave other "
                 f"bits")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                    leaves, dout)
        if not all(torch.equal(a, b) for a, b in zip(grads, got)):
            fail(f"K4 bf16 backward {name}: autograd gave other bits")
        rows.append((err, share, shares))
    return rows


def time_k4_bwd_bf16(torch, inputs, errs, rates):
    """K4's bf16 backward at every K4_BWD_BF16_CASES shape (the train
    run's first): the kernel, its plain version in bf16 and the
    yardstick, SDPA's bf16 backward (the case's ``is_causal``,
    ``enable_gqa``; the hybrid's window does not bind at 512 positions),
    beside the bound at the bf16 rate; each kernel's device time from the
    profiler. Returns the rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    rows = []
    for (name, causal, window, q, k, v, dout), err in zip(inputs, errs):
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)

        def bwd():
            return k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        ms = time_ms(bwd, torch)
        split = kernel_split_ms(
            bwd, torch,
            r"\bflash_attention_bwd_(delta|dkdv|dq|reduce)_kernel\b")
        B, S, Hq, hd = q.shape
        plan = k4.backward_plan(B, S, k.shape[1], Hq, k.shape[2], hd,
                                k4._sm_count(q.device.index),
                                q.element_size())
        want = {"delta", "dkdv", "dq"} | (
            {"reduce"} if plan.splits > 1 else set())
        if set(split) != want:
            fail(f"K4 bf16 backward: the profiler recorded the kernels "
                 f"{sorted(split)}, not {sorted(want)}")
        plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, dout, **kw), torch)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        dt = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, leaves, dt, retain_graph=True), torch)
        del o, leaves
        nbytes, flops = k4_bwd_work(q, k, causal, window)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "bfloat16")
        print(f"  K4 bf16 backward {name} ({B}, {S}, {Hq}, {k.shape[2]}, "
              f"{hd}, causal {causal}, window {window}) err {err[0]:.3g} "
              f"({err[1]:.3g} of the largest element) kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s; " + ", ".join(
                  f"{kname} {t:.4f}" for kname, t in split.items()) +
              f" ms a call; {plan.splits} head splits, {plan.n_slabs} "
              f"slabs, scratch {plan.scratch_bytes()} bytes)  plain "
              f"{plain_ms:.4f} ms  sdpa backward {lib_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        rows.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=k.shape[2], hd=hd,
                         causal=causal, window=window, dtype="bfloat16",
                         max_abs_err=err[0], share=err[1],
                         shares=err[2], tol=K4_BWD_BF16_TOL, ms=ms,
                         kernel_ms=split,
                         splits=plan.splits, slabs=plan.n_slabs,
                         scratch_bytes=plan.scratch_bytes(),
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, tflops=flops / ms / 1e9))
    return rows


def k5_inputs(torch):
    """Seeded (name, chunk, x, dlogA, B, C, h0) on the card for every K5
    case: x, B, C normal * 0.3, and dlogA -|normal| * 0.1 ("kernels", as
    tests/test_kernels.py) or the model's -softplus(normal) with x scaled
    by that dt ("model"); h0 normal * 0.5 or None; x, B and C laid out as
    the case says (K5_CASES)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = []
    for name, b, l, H, p, n, chunk, kind, with_h0, layout in K5_CASES:
        def draw(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        x = draw(b, l, H, p, scale=0.3)
        if kind == "model":
            dt = torch.nn.functional.softplus(draw(b, l, H))
            x, dlogA = x * dt[..., None], -dt
        else:
            dlogA = -draw(b, l, H).abs() * 0.1
        h0 = draw(b, H, p, n, scale=0.5) if with_h0 else None
        B, C = draw(b, l, n, scale=0.3), draw(b, l, n, scale=0.3)
        if layout is not None:
            # one buffer (b, l, H p + 2n), at one float in for "offset"
            off = 1 if layout == "offset" else 0
            width = H * p + 2 * n
            buf = torch.empty(b * l * width + off, device="cuda")
            xBC = buf[off:].view(b, l, width)
            xBC.copy_(torch.cat([x.reshape(b, l, H * p), B, C], dim=-1))
            x = xBC[..., :H * p].unflatten(-1, (H, p))
            B, C = xBC[..., H * p:H * p + n], xBC[..., H * p + n:]
        out.append((name, chunk, x, dlogA, B, C, h0))
    return out


def check_k5(torch, inputs):
    """K5 against its plain version in every case (y and h_last), a
    repeated call bit for bit (fixed summation order, no atomics), and
    the 16-byte copy path taken where the inputs allow it; returns the
    max abs error per case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k5

    errs = []
    for (name, chunk, x, dlogA, B, C, h0), case in zip(inputs, K5_CASES):
        y, hl = k5.ssd(x, dlogA, B, C, chunk=chunk, h0=h0)
        wy, wh = ref.ssd_ref(x, dlogA, B, C, chunk, h0)
        tol = (K5_TOL["atol"], K5_TOL["rtol"])
        errs.append(max(_close(torch, f"K5 {name} y", y, wy, *tol),
                        _close(torch, f"K5 {name} h_last", hl, wh, *tol)))
        y2, hl2 = k5.ssd(x, dlogA, B, C, chunk=chunk, h0=h0)
        if not (torch.equal(y, y2) and torch.equal(hl, hl2)):
            fail(f"K5 {name}: a repeated call gave other bits")
        vec = (k5.aligned16(x, (0, 1, 2)) and k5.aligned16(B, (0, 1))
               and k5.aligned16(C, (0, 1)))
        if vec != (case[-1] != "offset" and x.shape[-1] % 4 == 0):
            fail(f"K5 {name}: 16-byte copies {vec}, not as the case says")
    return errs


def k5_work(x, B, chunk, h0):
    """(bytes, flops) of a K5 forward op: `kernels.ssd.work`."""
    from repro_torch.kernels import ssd as k5

    b, l, H, p = x.shape
    return k5.work(b, l, H, p, B.shape[-1], chunk, h0 is not None)


def host_ms(fn, torch, reps: int = 20) -> float:
    """Median host time (ms) of one ``fn()``: its checks, allocations and
    launches, with the card held by a spin (about 25 ms) so that no call
    waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_k5(torch, inputs, errs, rates):
    """K5 (its three launches, as the main path pays them) and its plain
    version timed at the serve shape and with eight chunks, beside the
    bound; each kernel's device time from the profiler, and the wrapper's
    host time a call. The flops the kernels are modelled to do
    (`ssd.kernel_flops`, not counted on the card) are printed beside the
    least work (`k5_work`, which sets the bound). No single PyTorch call
    computes a chunked SSD scan, so no library time. Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k5

    rows = []
    for (name, chunk, x, dlogA, B, C, h0), err in zip(inputs, errs):
        if name not in K5_TIMED:
            continue

        def op():
            return k5.ssd(x, dlogA, B, C, chunk=chunk, h0=h0)
        ms = time_ms(op, torch)
        pass_ms = kernel_split_ms(op, torch,
                                  r"\bssd_(chunk|pass|output)_kernel\b")
        if sorted(pass_ms) != ["chunk", "output", "pass"]:
            fail(f"K5: the profiler recorded the kernels {sorted(pass_ms)}, "
                 f"not ssd_chunk_kernel, ssd_pass_kernel and "
                 f"ssd_output_kernel")
        wrapper_ms = host_ms(op, torch)
        plain_ms = time_ms(lambda: ref.ssd_ref(x, dlogA, B, C, chunk, h0),
                           torch)
        nbytes, flops = k5_work(x, B, chunk, h0)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        b, l, H, p = x.shape
        n = B.shape[-1]
        done = k5.kernel_flops(b, l, H, p, n, min(chunk, l), h0 is not None)
        rows.append(dict(case=name, b=b, l=l, H=H, p=p, n=n,
                         chunk=chunk, dtype="float32", max_abs_err=err,
                         atol=K5_TOL["atol"], rtol=K5_TOL["rtol"], ms=ms,
                         pass_ms=pass_ms, host_ms=wrapper_ms,
                         plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, tflops=flops / ms / 1e9))
        print(f"  K5 {name:<10} ({b}, {l}, {H}, {p}, {n}, chunk "
              f"{chunk}) err {err:.3g} kernel {ms:.4f} ms (profiled: chunk "
              f"{pass_ms['chunk']:.4f} + pass {pass_ms['pass']:.4f} + "
              f"output {pass_ms['output']:.4f}; wrapper host "
              f"{wrapper_ms:.4f} ms a call; {flops / ms / 1e9:.2f} TFLOP/s "
              f"of the least {flops / 1e9:.3f} GFLOP; modelled, not "
              f"counted: {done['total'] / 1e9:.3f} GFLOP done, " + ", ".join(
                  f"{k} {v / 1e9:.3f}" for k, v in done.items()
                  if k != "total") + f")  plain {plain_ms:.4f} ms  "
              f"library none  bound {bound_ms:.4f} ms ({bound_by})")
    return rows


def k6_inputs(torch):
    """Seeded (name, a, b, h0) on the card for every K6 case (K6_CASES)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for name, B, S, W, kind, with_h0 in K6_CASES:
        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        if kind == "model":
            u = torch.rand((W,), generator=gen, device="cuda") * 0.099 + 0.9
            a = u ** torch.sigmoid(draw(B, S, W))
            b = torch.sqrt(1.0 - a * a) * torch.sigmoid(draw(B, S, W)) * \
                draw(B, S, W)
        else:
            lo, width = (0.49, 0.5) if kind == "wide" else (0.79, 0.2)
            a = torch.sigmoid(draw(B, S, W)) * width + lo
            b = draw(B, S, W) * 0.1
        out.append((name, a, b, draw(B, W) if with_h0 else None))
    return out


def check_k6(torch, inputs):
    """K6 against its plain version in every case (h and h_last) at atol
    K6_TOL; returns the max abs error per case and the number of cases
    that agree bit for bit (the kernel rounds in the plain version's
    order)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as k6

    errs, bitwise = [], 0
    for name, a, b, h0 in inputs:
        h, hl = k6.rglru_scan(a, b, h0)
        wh, whl = ref.linear_scan_ref(a, b, h0)
        errs.append(max(_close(torch, f"K6 {name} h", h, wh, K6_TOL, 0.0),
                        _close(torch, f"K6 {name} h_last", hl, whl, K6_TOL,
                               0.0)))
        bitwise += bool(torch.equal(h, wh) and torch.equal(hl, whl))
    return errs, bitwise


def k6_work(a, h0):
    """(bytes, flops) of a K6 forward call: `kernels.rglru_scan.work`."""
    from repro_torch.kernels import rglru_scan as k6

    return k6.work(*a.shape, h0 is not None)


def time_k6(torch, inputs, errs, rates):
    """K6 and its plain version (a Python loop of S steps) timed at the
    serve shape, beside the bound; no single PyTorch call computes a
    first-order linear recurrence, so no library time. Returns the
    rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as k6

    rows = []
    for (name, a, b, h0), err in zip(inputs, errs):
        if name != "serve":
            continue
        ms = time_ms(lambda: k6.rglru_scan(a, b, h0), torch)
        plain_ms = time_ms(lambda: ref.linear_scan_ref(a, b, h0), torch)
        nbytes, flops = k6_work(a, h0)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        B, S, W = a.shape
        rows.append(dict(case=name, B=B, S=S, W=W, dtype="float32",
                         max_abs_err=err, atol=K6_TOL, ms=ms,
                         plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, flops=flops,
                         gbytes_per_s=nbytes / ms / 1e6))
        print(f"  K6 {name:<10} ({B}, {S}, {W}) err {err:.3g} kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)  plain "
              f"{plain_ms:.4f} ms  library none  bound {bound_ms:.4f} ms "
              f"({bound_by})")
    return rows


def k5_bwd_inputs(torch):
    """Seeded (name, chunk, x, dlogA, B, C, h0, dy, dh_last) on the card for
    every K5 backward case: x, dlogA, B, C and h0 drawn and laid out as
    `k5_inputs` draws them, dy normal, dh_last normal or None."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for (name, b, l, H, p, n, chunk, kind, with_h0, with_dhl,
         layout) in K5_BWD_CASES:
        def draw(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        x = draw(b, l, H, p, scale=0.3)
        if kind == "model":
            dt = torch.nn.functional.softplus(draw(b, l, H))
            x, dlogA = x * dt[..., None], -dt
        else:
            dlogA = -draw(b, l, H).abs() * 0.1
        h0 = draw(b, H, p, n, scale=0.5) if with_h0 else None
        B, C = draw(b, l, n, scale=0.3), draw(b, l, n, scale=0.3)
        if layout is not None:
            off = 1 if layout == "offset" else 0
            width = H * p + 2 * n
            buf = torch.empty(b * l * width + off, device="cuda")
            xBC = buf[off:].view(b, l, width)
            xBC.copy_(torch.cat([x.reshape(b, l, H * p), B, C], dim=-1))
            x = xBC[..., :H * p].unflatten(-1, (H, p))
            B, C = xBC[..., H * p:H * p + n], xBC[..., H * p + n:]
        out.append((name, chunk, x, dlogA, B, C, h0, draw(b, l, H, p),
                    draw(b, H, p, n) if with_dhl else None))
    return out


def check_k5_bwd(torch, inputs):
    """K5's backward (from the forward's workspaces, `ssd_with_work`)
    against its plain version (`ref.ssd_bwd_ref`) in every case, each of
    dx, d dlogA, dB, dC and dh0 within K5_BWD_TOL of its largest element;
    a repeated call bit for bit (no atomics); the 16-byte copies where
    the case allows them. Returns per case (max abs err, largest
    share)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k5

    out = []
    for (name, chunk, x, dlogA, B, C, h0, dy, dhl), case in zip(
            inputs, K5_BWD_CASES):
        _, _, cum, states = k5.ssd_with_work(x, dlogA, B, C, chunk=chunk,
                                             h0=h0)
        got = k5.ssd_bwd(x, dlogA, B, C, chunk, h0, dy, dhl, cum, states)
        want = ref.ssd_bwd_ref(x, dlogA, B, C, chunk, h0, dy, dhl)
        err = share = 0.0
        for label, g, w in zip(("dx", "d dlogA", "dB", "dC", "dh0"), got,
                               want):
            if (g is None) != (w is None):
                fail(f"K5 backward {name}: {label} is {g} against {w}")
            if w is None:
                continue
            scale = w.abs().max().clamp_min(1e-30)
            _close(torch, f"K5 backward {name} {label} / max |{label}|",
                   g / scale, w / scale, K5_BWD_TOL, 0.0)
            diff = (g - w).abs().max()
            err = max(err, diff.item())
            share = max(share, (diff / scale).item())
        again = k5.ssd_bwd(x, dlogA, B, C, chunk, h0, dy, dhl, cum, states)
        if not all(a is None or torch.equal(a, b_)
                   for a, b_ in zip(got, again)):
            fail(f"K5 backward {name}: a repeated call gave other bits")
        vec = (k5.aligned16(x, (0, 1, 2)) and k5.aligned16(B, (0, 1)) and
               k5.aligned16(C, (0, 1)))
        if vec != (case[-1] != "offset" and x.shape[-1] % 4 == 0):
            fail(f"K5 backward {name}: 16-byte copies {vec}, not as the "
                 f"case says")
        out.append((err, share))
    return out


def k5_bwd_work(x, B, chunk, h0, dhl):
    """(bytes, flops) of a K5 backward call: `kernels.ssd.bwd_work`."""
    from repro_torch.kernels import ssd as k5

    b, l, H, p = x.shape
    return k5.bwd_work(b, l, H, p, B.shape[-1], chunk, h0 is not None,
                       dhl is not None)


def time_k5_bwd(torch, inputs, errs, rates):
    """K5's backward (its six launches) at the K5_BWD_TIMED shapes, each
    kernel's device time from the profiler, the wrapper's host time a
    call, and its plain version (autograd through `ssd_ref`), beside the
    bound. No single PyTorch call computes the gradient of a chunked SSD
    scan, so no library time. Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k5

    rows = []
    for (name, chunk, x, dlogA, B, C, h0, dy, dhl), err in zip(inputs,
                                                                errs):
        if name not in K5_BWD_TIMED:
            continue
        _, _, cum, states = k5.ssd_with_work(x, dlogA, B, C, chunk=chunk,
                                             h0=h0)

        def bwd():
            return k5.ssd_bwd(x, dlogA, B, C, chunk, h0, dy, dhl, cum,
                              states)
        ms = time_ms(bwd, torch)
        split = kernel_split_ms(bwd, torch, K5_BWD_KERNELS)
        if sorted(split) != ["chunk", "dx", "final", "pass", "state", "w"]:
            fail(f"K5 backward: the profiler recorded the kernels "
                 f"{sorted(split)}")
        host = host_ms(bwd, torch)
        plain_ms = time_ms(lambda: ref.ssd_bwd_ref(
            x, dlogA, B, C, chunk, h0, dy, dhl), torch, reps=20, warmup=3)
        nbytes, flops = k5_bwd_work(x, B, chunk, h0, dhl)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        b, l, H, p = x.shape
        n = B.shape[-1]
        plan = k5.backward_plan(b, l, H, p, n, min(chunk, l))
        rows.append(dict(case=name, b=b, l=l, H=H, p=p, n=n, chunk=chunk,
                         dtype="float32", max_abs_err=err[0],
                         max_share=err[1], tol=K5_BWD_TOL, ms=ms,
                         kernel_ms=split, host_ms=host, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         tflops=flops / ms / 1e9,
                         scratch_bytes=plan.scratch_bytes()))
        print(f"  K5 backward {name} ({b}, {l}, {H}, {p}, {n}, chunk "
              f"{chunk}) err {err[0]:.3g} ({err[1]:.3g} of the largest) "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s of the "
              f"least {flops / 1e9:.3f} GFLOP; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()) +
              f" ms a call; host {host:.4f} ms; scratch "
              f"{plan.scratch_bytes()} bytes)  plain "
              f"{plain_ms:.4f} ms  library none  bound {bound_ms:.4f} ms "
              f"({bound_by})")
    return rows


def k6_bwd_inputs(torch):
    """Seeded (name, a, b, h0, dy, dh_last) on the card for every K6
    backward case, a and b drawn as `k6_inputs` draws them."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for name, B, S, W, kind, with_h0, with_dhl in K6_BWD_CASES:
        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        if kind == "model":
            u = torch.rand((W,), generator=gen, device="cuda") * 0.099 + 0.9
            a = u ** torch.sigmoid(draw(B, S, W))
            b = torch.sqrt(1.0 - a * a) * torch.sigmoid(draw(B, S, W)) * \
                draw(B, S, W)
        else:
            a = torch.sigmoid(draw(B, S, W)) * 0.2 + 0.79
            b = draw(B, S, W) * 0.1
        out.append((name, a, b, draw(B, W) if with_h0 else None,
                    draw(B, S, W), draw(B, W) if with_dhl else None))
    return out


def check_k6_bwd(torch, inputs):
    """K6's backward (from the forward's output h) against its plain
    version (`ref.linear_scan_bwd_ref`) in every case, bit for bit (da,
    db and dh0); returns the max abs error per case (0)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as k6

    errs = []
    for name, a, b, h0, dy, dhl in inputs:
        h, _ = k6.rglru_scan(a, b, h0)
        got = k6.rglru_scan_bwd(a, h, h0, dy, dhl)
        want = ref.linear_scan_bwd_ref(a, b, h0, dy, dhl)
        err = 0.0
        for label, g, w in zip(("da", "db", "dh0"), got, want):
            if (g is None) != (w is None):
                fail(f"K6 backward {name}: {label} is {g} against {w}")
            if w is None:
                continue
            torch.cuda.synchronize()
            err = max(err, (g - w).abs().max().item())
            if not torch.equal(g, w):
                fail(f"K6 backward {name}: {label} differs from the plain "
                     f"version's (max abs err {err}), not bit for bit")
        errs.append(err)
    return errs


def time_k6_bwd(torch, inputs, errs, rates):
    """K6's backward and its plain version (autograd through the S-step
    loop) at the K6_BWD_TIMED shapes, beside the bound: a, h and dy read
    once, da and db written once (20 bytes an element), three flops an
    element. No single PyTorch call computes it. Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as k6

    rows = []
    for (name, a, b, h0, dy, dhl), err in zip(inputs, errs):
        if name not in K6_BWD_TIMED:
            continue
        h, _ = k6.rglru_scan(a, b, h0)
        ms = time_ms(lambda: k6.rglru_scan_bwd(a, h, h0, dy, dhl), torch)
        plain_ms = time_ms(lambda: ref.linear_scan_bwd_ref(
            a, b, h0, dy, dhl), torch, reps=5, warmup=1)
        B, S, W = a.shape
        nbytes, flops = k6.bwd_work(B, S, W, h0 is not None,
                                    dhl is not None)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        rows.append(dict(case=name, B=B, S=S, W=W, dtype="float32",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         gbytes_per_s=nbytes / ms / 1e6))
        print(f"  K6 backward {name} ({B}, {S}, {W}) err {err:.3g} kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)  plain "
              f"{plain_ms:.4f} ms  library none  bound {bound_ms:.4f} ms "
              f"({bound_by})")
    return rows


#: the kernels redesigned for Hopper: their ptxas report is printed in
#: full, and a spill fails the run
def k7_inputs(torch):
    """Seeded (x, conv1_w, conv1_b, conv2_w, conv2_b) on the card for every
    K7 case: normal images, weights of 0.1 normals as views of one
    (G, P) panel one element in (no 16-byte alignment), as the greedy's
    probe rows are."""
    out = []
    for label, G, B, image, cin, c1, c2 in K7_CASES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((G, B, image, image, cin), generator=gen,
                        device="cuda")
        shapes = [(5, 5, cin, c1), (c1,), (5, 5, c1, c2), (c2,)]
        sizes = [math.prod(sh) for sh in shapes]
        panel = 0.1 * torch.randn((G, sum(sizes) + 1), generator=gen,
                                  device="cuda")
        leaves = torch.split(panel[:, 1:], sizes, dim=1)
        out.append((label, (x, *[leaf.reshape((G,) + sh)
                                 for leaf, sh in zip(leaves, shapes)])))
    return out


def check_k7(torch, inputs):
    """K7 against its plain version (grouped convolutions) in float64 in
    every case, within K7_TOL of the largest feature; the same bits on a
    repeated call, and, in the reward call's case, for a model launched
    alone. Returns the error (a share of the largest feature) per case."""
    from repro_torch.kernels import cnn_features as k7
    from repro_torch.kernels import ref

    errs = []
    for label, args in inputs:
        got = k7.cnn_features(*args)
        want = ref.cnn_features_ref(*[a.double() for a in args])
        torch.cuda.synchronize()
        share = ((got.double() - want).abs().max() /
                 want.abs().max()).item()
        if not share <= K7_TOL:
            fail(f"K7 {label}: max abs err {share:.3g} of the largest "
                 f"feature, over {K7_TOL}")
        if not torch.equal(got, k7.cnn_features(*args)):
            fail(f"K7 {label}: a repeated call gave other bits")
        if label == "reward call":
            for g in (0, 211, args[0].shape[0] - 1):
                alone = k7.cnn_features(*[a[g:g + 1] for a in args])
                if not torch.equal(alone[0], got[g]):
                    fail(f"K7 {label}: model {g} alone gave other bits "
                         f"than among {args[0].shape[0]}")
        errs.append(share)
    return errs


def k7_library(torch, x, w1, b1, w2, b2):
    """The yardstick: cuDNN's grouped convolutions, bias, ReLU and pool of
    the plain version alone, on inputs already in its NCHW layout (the
    plain version's permutes and flatten left out)."""
    import torch.nn.functional as F

    G, B, H, W, cin = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(B, G * cin, H, W)
    wt1 = w1.permute(0, 4, 3, 1, 2).reshape(-1, cin, 5, 5)
    wt2 = w2.permute(0, 4, 3, 1, 2).reshape(-1, w1.shape[-1], 5, 5)
    bb1, bb2 = b1.reshape(1, -1, 1, 1), b2.reshape(1, -1, 1, 1)

    def stack():
        y = F.max_pool2d(F.relu(F.conv2d(h, wt1, groups=G) + bb1), 2)
        return F.max_pool2d(F.relu(F.conv2d(y, wt2, groups=G) + bb2), 2)

    return stack


def time_k7(torch, inputs, errs, rates):
    """K7, its plain version and cuDNN's grouped-convolution stack alone
    (`k7_library`) timed at the reward call's shape, beside the bound.
    Returns the rows."""
    from repro_torch.kernels import cnn_features as k7
    from repro_torch.kernels import ref

    rows = []
    for (label, args), err in zip(inputs, errs):
        if label != "reward call":
            continue
        ms = time_ms(lambda: k7.cnn_features(*args), torch)
        plain_ms = time_ms(lambda: ref.cnn_features_ref(*args), torch)
        lib_ms = time_ms(k7_library(torch, *args), torch)
        G, B, H, W, cin = args[0].shape
        c1, c2 = args[1].shape[-1], args[3].shape[-1]
        nbytes, flops = k7.work(G, B, H, W, cin, c1, c2)
        bound_ms, bound_by = _bound(rates, nbytes, flops, "float32")
        rows.append(dict(case=label, G=G, B=B, H=H, W=W, cin=cin, c1=c1,
                         c2=c2, dtype="float32", max_abs_err=err,
                         tol=K7_TOL, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         tflops=flops / ms / 1e9))
        print(f"  K7 {label} (G {G}, B {B}, {H}x{W}x{cin}, {c1}/{c2}) err "
              f"{err:.3g} kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
              f"TFLOP/s)  plain {plain_ms:.4f} ms  cuDNN stack {lib_ms:.4f}"
              f" ms  bound {bound_ms:.4f} ms ({bound_by})")
    return rows


REDESIGNED = ("graph_mix", "sparse_graph_mix", "compressed_graph_mix",
              "flash_attention", "flash_attention_bwd",
              "flash_attention_bwd_bf16", "ssd", "ssd_bwd", "rglru_scan_bwd",
              "cnn_features")


def ptxas_report(log):
    """Per entry function of an ``nvcc -Xptxas=-v`` log: (mangled name,
    registers, spill store bytes, spill load bytes, static shared
    bytes)."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append([m.group(1), None, 0, 0, 0])
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1][2:4] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1][1] = int(m.group(1))
            out[-1][4] = int(sm.group(1)) if sm else 0
    return [tuple(r) for r in out]


def demangle(names):
    """C++ names of mangled symbols, by the toolkit's ``cu++filt`` (beside
    nvcc), without their return type, parameter list and casts of
    template arguments: ``<unnamed>::graph_mix_kernel<32, 2, float>``."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cu++filt"
    lines = subprocess.run([str(tool), *names], capture_output=True,
                           text=True, check=True, timeout=60
                           ).stdout.splitlines()
    if len(lines) != len(names):
        fail(f"cu++filt gave {len(lines)} names for {len(names)}")
    out = []
    for line in lines:
        i, depth = len(line), 0   # the parameter list: the last (...)
        while line.endswith(")") and i > 0:
            i -= 1
            depth += {")": 1, "(": -1}.get(line[i], 0)
            if depth == 0:
                break
        out.append(line[:i].removeprefix("void ").replace("(int)", ""))
    return out


def sass_mma_counts(path):
    """``cuobjdump -sass`` of a built library: per entry function, the
    number of HMMA (mma.sync) and HGMMA (wgmma) instructions."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        counts[name] = (len(re.findall(r"\bHMMA\b", part)),
                        len(re.findall(r"\bHGMMA\b", part)))
    return counts


def report_build(built):
    """Print each kernel's ptxas use; for the redesigned kernels (and K4's
    backward) every entry function (registers, spills, static shared
    memory), failing on a spill; and K4's SASS: its bf16 kernels must run
    on the tensor cores (HMMA or HGMMA) and its fp32 kernels, the
    backward's 34 included, must not; nor may K5's backward's 11. The
    bf16 backward's 34: its dK/dV and dQ kernels at 16 head sizes must
    run on the tensor cores (every product is an mma.sync), its D and
    split-sum kernels must not (fp32 sums)."""
    from repro_torch.kernels import _build

    for kname, b in sorted(built.items()):
        if not b.log:
            print(f"  {kname}: built before this run, no ptxas log")
            continue
        rows = ptxas_report(b.log)
        if kname not in REDESIGNED:
            regs = [r[1] for r in rows if r[1] is not None]
            print(f"  {kname}: {len(rows)} entry functions, registers "
                  f"{min(regs, default=0)}-{max(regs, default=0)}, spill "
                  f"bytes {sum(r[2] + r[3] for r in rows)}")
            continue
        labels = demangle([r[0] for r in rows])
        for label, (_, regs, st, ld, smem) in zip(labels, rows):
            print(f"  {kname}: {label}: {regs} registers, spill stores "
                  f"{st} loads {ld} bytes, static smem {smem} bytes")
            if st or ld:
                fail(f"{kname} {label} spills registers ({st} bytes stored, "
                     f"{ld} loaded)")
    counts = sass_mma_counts(_build.library_path("flash_attention"))
    bf16 = {n: c for n, c in counts.items() if "bf16_kernel" in n}
    f32 = {n: c for n, c in counts.items() if "f32_kernel" in n}
    if len(bf16) != 16 or len(f32) != 16:
        fail(f"K4 SASS: {len(bf16)} bf16 and {len(f32)} fp32 kernels, "
             f"expected 16 each")
    if not all(h + g for h, g in bf16.values()):
        fail("K4 SASS: a bf16 kernel has no HMMA/HGMMA")
    if any(h + g for h, g in f32.values()):
        fail("K4 SASS: an fp32 kernel runs on the tensor cores")
    print(f"K4 SASS (cuobjdump -sass): HMMA {sum(h for h, _ in bf16.values())}"
          f", HGMMA {sum(g for _, g in bf16.values())} in its 16 bf16 "
          f"kernels (min HMMA {min(h for h, _ in bf16.values())} a kernel); "
          f"HMMA {sum(h for h, _ in f32.values())}, HGMMA "
          f"{sum(g for _, g in f32.values())} in its 16 fp32 kernels")
    bwd = sass_mma_counts(_build.library_path("flash_attention_bwd"))
    if len(bwd) != 34:
        fail(f"K4 backward SASS: {len(bwd)} kernels, expected 34 (D, "
             f"dK/dV and dQ at 16 head sizes, the split sum)")
    if any(h + g for h, g in bwd.values()):
        fail("K4 backward SASS: a kernel runs on the tensor cores (fp32 "
             "only, no TF32)")
    print(f"K4 backward SASS: no HMMA or HGMMA in its {len(bwd)} kernels")
    bwd16 = sass_mma_counts(_build.library_path("flash_attention_bwd_bf16"))
    mma16 = {n: c for n, c in bwd16.items() if re.search(r"_(dkdv|dq)_", n)}
    if len(bwd16) != 34 or len(mma16) != 32:
        fail(f"K4 bf16 backward SASS: {len(bwd16)} kernels, {len(mma16)} of "
             f"them dK/dV or dQ, expected 34 and 32 (D, dK/dV and dQ at 16 "
             f"head sizes, the split sum)")
    if not all(h + g for h, g in mma16.values()):
        fail("K4 bf16 backward SASS: a dK/dV or dQ kernel has no HMMA or "
             "HGMMA")
    if any(h + g for n, (h, g) in bwd16.items() if n not in mma16):
        fail("K4 bf16 backward SASS: its D or split-sum kernel runs on the "
             "tensor cores")
    print(f"K4 bf16 backward SASS: HMMA {sum(h for h, _ in mma16.values())}"
          f", HGMMA {sum(g for _, g in mma16.values())} in its 32 dK/dV and "
          f"dQ kernels (min HMMA {min(h for h, _ in mma16.values())} a "
          f"kernel); none in its D and split-sum kernels")
    k5b = sass_mma_counts(_build.library_path("ssd_bwd"))
    if len(k5b) != 11:
        fail(f"K5 backward SASS: {len(k5b)} kernels, expected 11 (chunk, "
             f"pass, state, dx and W at p's two paddings, final)")
    if any(h + g for h, g in k5b.values()):
        fail("K5 backward SASS: a kernel runs on the tensor cores (IEEE "
             "fp32 fmaf only, no TF32)")
    print(f"K5 backward SASS: no HMMA or HGMMA in its {len(k5b)} kernels")
    k7s = sass_mma_counts(_build.library_path("cnn_features"))
    if len(k7s) != 4:
        fail(f"K7 SASS: {len(k7s)} kernels, expected 4 (cin, c1, c2 of "
             f"cnn_features.KERNELS)")
    if any(h + g for h, g in k7s.values()):
        fail("K7 SASS: a kernel runs on the tensor cores (IEEE fp32 fmaf "
             "only, no TF32)")
    print(f"K7 SASS: no HMMA or HGMMA in its {len(k7s)} kernels")


def _kernel_modules():
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import sparse_graph_mix as k2
    from repro_torch.kernels import ssd as k5

    return {"graph_mix": k1.graph_mix,
            "sparse_graph_mix": k2.sparse_graph_mix,
            "compressed_graph_mix": k3.compressed_graph_mix,
            "flash_attention": k4.flash_attention,
            "flash_attention_bwd": k4.flash_attention_bwd,
            "flash_attention_bwd_bf16": k4.flash_attention_bwd_bf16,
            "ssd": k5.ssd,
            "ssd_bwd": k5.ssd_bwd, "rglru_scan": k6.rglru_scan,
            "rglru_scan_bwd": k6.rglru_scan_bwd}


def _zero_launches():
    for wrapper in _kernel_modules().values():
        wrapper.launches = 0


def _read_launches():
    return {name: wrapper.launches
            for name, wrapper in _kernel_modules().items()}


def smoke_config(variant, **run):
    from repro_torch.core.dpfl import DPFLConfig
    from repro_torch.data import ParticipationConfig
    from repro_torch.fl.adversary import AdversaryConfig
    from repro_torch.fl.compress import CompressionConfig

    spec = dict(VARIANTS[variant])
    codec = spec.pop("codec", None)
    if codec:
        spec["compression"] = CompressionConfig(codec, topk_frac=TOPK_FRAC)
    if "participation" in spec:
        spec["participation"] = ParticipationConfig(**spec["participation"])
    if "adversary" in spec:
        spec["adversary"] = AdversaryConfig(**spec["adversary"])
    return DPFLConfig(**run, **spec)


def make_engine():
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import PaperCNN

    data = make_federated_classification(**SMOKE_DATA)
    engine = FLEngine(PaperCNN(CNNConfig()), data, lr=SMOKE_LR,
                      batch_size=SMOKE_BATCH)
    if engine.n_params != PAPER_CNN_PARAMS:
        fail(f"PaperCNN has {engine.n_params} params, "
             f"expected {PAPER_CNN_PARAMS}")
    return engine


def run_main_path(torch, engine, variant):
    """Algorithm 1 at full PaperCNN width on the card in one variant;
    returns the result, the config, the launch counts of every kernel
    (zeroed just before the run, read just after), the wall time and the
    run's peak of allocated device memory in bytes."""
    from repro_torch.core.dpfl import run_dpfl
    from repro_torch.kernels import cnn_features as k7

    cfg = smoke_config(variant, **SMOKE_RUN)
    calls = {"reward": 0, "eval": 0}
    make, split = engine.make_reward_fn, engine._eval_split

    def make_counted():
        reward = make()

        def counted(*args):
            calls["reward"] += 1
            return reward(*args)

        return counted

    def split_counted(*args):
        calls["eval"] += 1
        return split(*args)

    engine.make_reward_fn, engine._eval_split = make_counted, split_counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    k7.cnn_features.launches = 0
    try:
        t0 = time.perf_counter()
        res = run_dpfl(engine, cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del engine.make_reward_fn, engine._eval_split
    counts = _read_launches()
    # K7 once a reward call (all its probe models) and twice an
    # evaluation (the accuracy's and the loss's forwards)
    counts["cnn_features"] = k7.cnn_features.launches
    if counts["cnn_features"] != calls["reward"] + 2 * calls["eval"]:
        fail(f"{variant}: {counts['cnn_features']} K7 launches for "
             f"{calls['reward']} reward calls and {calls['eval']} "
             f"evaluations")
    return res, cfg, counts, seconds, torch.cuda.max_memory_allocated()


def expected_launches(variant, N, B, rounds):
    """Launches of each kernel in one refresh-every-round run: BGGC phase 1
    is ceil(N/B) K1 launches and each round's greedy init one more
    (participation and attacks change no launch); the preprocessing mix
    and each round's mix are K1 (dense), K2 (sparse, with or without a
    codec) or, for the rounds of dense top-k, K3. The trimmed rule mixes
    its rounds in plain torch (an order statistic, no kernel), the
    clipped rule through the same kernels as the weighted one."""
    spec = VARIANTS[variant]
    sparse = spec.get("graph_repr") == "sparse"
    topk = spec.get("codec") == "topk"
    round_mixes = 0 if spec.get("mix_rule") == "trimmed" else rounds
    k1 = math.ceil(N / B) + rounds
    if not sparse:
        k1 += 1 + (0 if topk else round_mixes)
    want = {name: 0 for name in _kernel_modules()}
    want.update(graph_mix=k1,
                sparse_graph_mix=1 + round_mixes if sparse else 0,
                compressed_graph_mix=round_mixes if topk and not sparse
                else 0)
    return want


def check_main_path(res, engine, cfg, variant, launches, omega_dense,
                    want=None):
    """The invariants of a refresh_period=1 run; returns the mean test
    accuracy. Preprocessing sees every client and no attack, so every
    run's Omega is the dense run's. Each round downloads Omega among the
    clients available that round; a client absent in round t keeps its
    C_k of round t - 1 (Omega's in round 0). ``want``: the launches
    expected (default `expected_launches`)."""
    import numpy as np

    from repro_torch.fl.adversary import n_malicious
    from repro_torch.fl.compress import bytes_per_model

    N = SMOKE_DATA["n_clients"]
    P = engine.n_params
    B = cfg.budget
    if want is None:
        want = expected_launches(variant, N, B, cfg.rounds)
        # held to the run's reward and evaluation calls (`run_main_path`)
        want["cnn_features"] = launches["cnn_features"]
    if launches != want:
        fail(f"{variant}: kernel launches on the main path {launches}, "
             f"expected {want}")
    if res.comm_preprocess != 2 * N * (N - 1):
        fail(f"{variant}: comm_preprocess {res.comm_preprocess} != 2N(N-1)")
    if res.comm_bytes_preprocess != res.comm_preprocess * 4 * P:
        fail(f"{variant}: preprocessing not charged 4P per download")
    bpm = bytes_per_model(cfg.compression, P)
    if res.comm_bytes != [d * bpm for d in res.comm_downloads]:
        fail(f"{variant}: comm_bytes != downloads * {bpm}")
    omega = res.omega.astype(bool)
    if omega_dense is not None and not np.array_equal(omega, omega_dense):
        fail(f"{variant}: Omega differs from the dense run's")
    part = res.participation
    if (part is None) != (cfg.participation is None) or (
            part is not None and part.shape != (cfg.rounds, N)):
        fail(f"{variant}: no (rounds, N) participation schedule")
    if cfg.adversary is not None and (
            res.malicious is None
            or int(res.malicious.sum()) != n_malicious(cfg.adversary, N)):
        fail(f"{variant}: the malicious set is not "
             f"{n_malicious(cfg.adversary, N)} of {N} clients")
    off_omega = omega & ~np.eye(N, dtype=bool)
    for t, d in enumerate(res.comm_downloads):
        act = np.ones(N, bool) if part is None else part[t]
        want = int((off_omega & act[:, None] & act[None, :]).sum())
        if d != want:   # every round refreshes: Omega among the available
            fail(f"{variant} round {t}: {d} downloads, the realized count "
                 f"over Omega is {want}")
    if len(res.graph_history) != cfg.rounds:
        fail(f"{variant}: {len(res.graph_history)} graphs for "
             f"{cfg.rounds} rounds")
    prev = omega
    for t, g in enumerate(res.graph_history):
        g = np.asarray(g, bool)
        off = g & ~np.eye(N, dtype=bool)
        if not np.all(np.diag(g)):
            fail(f"{variant} round {t}: graph diagonal not set")
        if off.sum(axis=1).max() > B:
            fail(f"{variant} round {t}: a client selected more than {B} "
                 f"peers")
        if np.any(g & ~omega):
            fail(f"{variant} round {t}: graph leaves Omega")
        if part is not None and not np.array_equal(g[~part[t]],
                                                   prev[~part[t]]):
            fail(f"{variant} round {t}: an absent client's C_k changed")
        prev = g
    if res.best_flat.shape != (N, P) or not np.isfinite(res.best_flat).all():
        fail(f"{variant}: best_flat is not a finite (N, P) table")
    accs = np.concatenate([res.test_acc] + list(res.val_acc_history))
    if not np.isfinite(accs).all():
        fail(f"{variant}: non-finite accuracies")
    mean_acc = float(np.mean(res.test_acc))
    if mean_acc < LEARN_REF[variant] - LEARN_MARGIN:
        fail(f"{variant}: mean test accuracy {mean_acc:.4f} < "
             f"{LEARN_REF[variant] - LEARN_MARGIN:.4f} (JAX reference "
             f"{LEARN_REF[variant]} less {LEARN_MARGIN})")
    return mean_acc


def check_small_input(torch):
    """The same entry point on a small input (MLP, 6 clients), on the card
    and on the CPU, without a codec (dense and sparse), with top-k and
    int8, and, dense and sparse, under participation with sign flippers
    and the clipped rule, with label flippers and the trimmed rule, and
    with noisy free riders (their noise is the same bits on both): graphs
    and counters equal, models within fp noise. Returns the best_flat max
    abs difference per run."""
    import numpy as np

    from repro_torch.core.dpfl import DPFLConfig, run_dpfl
    from repro_torch.data import (ParticipationConfig,
                                  make_federated_classification)
    from repro_torch.fl.adversary import AdversaryConfig
    from repro_torch.fl.compress import CompressionConfig
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    data = make_federated_classification(
        seed=5, n_clients=6, n_clusters=2, partition="pathological",
        classes_per_client=3, feature_dim=8, n_train=16, n_val=16,
        n_test=16, noise=2.0, assign_level="cluster")
    run = dict(rounds=4, tau_init=2, tau_train=1, budget=3, seed=0)
    configs = {
        "dense": DPFLConfig(**run),
        "sparse": DPFLConfig(**run, graph_repr="sparse"),
        "topk": DPFLConfig(**run, compression=CompressionConfig("topk")),
        "int8": DPFLConfig(**run, compression=CompressionConfig("int8"))}
    robust = {
        "signflip-clipped": dict(
            participation=ParticipationConfig(rate=0.7, seed=3),
            adversary=AdversaryConfig("sign_flip", fraction=0.34, seed=1),
            mix_rule="clipped"),
        "labelflip-trimmed": dict(
            adversary=AdversaryConfig("label_flip", fraction=0.34, seed=1),
            mix_rule="trimmed"),
        "freerider": dict(
            adversary=AdversaryConfig("free_rider", fraction=0.5, seed=3,
                                      noise_scale=1.0))}
    for name, kw in robust.items():
        configs[f"dense {name}"] = DPFLConfig(**run, **kw)
        configs[f"sparse {name}"] = DPFLConfig(**run, **kw,
                                               graph_repr="sparse")
    engines = {dev: FLEngine(MLP(8, 16, 10), data, lr=0.05, batch_size=8,
                             device=dev) for dev in ("cuda", "cpu")}
    errs = {}
    for name, cfg in configs.items():
        gpu, cpu = (run_dpfl(engines[d], cfg) for d in ("cuda", "cpu"))
        if gpu.comm_downloads != cpu.comm_downloads or \
                gpu.comm_bytes != cpu.comm_bytes or \
                not all(np.array_equal(getattr(gpu, f), getattr(cpu, f))
                        for f in ("participation", "malicious")) or \
                not np.array_equal(gpu.omega, cpu.omega) or \
                not all(np.array_equal(a, b) for a, b in
                        zip(gpu.graph_history, cpu.graph_history)):
            fail(f"small input, {name}: card and CPU runs select "
                 f"different graphs or count differently")
        errs[name] = float(np.abs(gpu.best_flat - cpu.best_flat).max())
        if not np.allclose(gpu.best_flat, cpu.best_flat, rtol=1e-4,
                           atol=1e-5):
            fail(f"small input, {name}: best_flat differs by "
                 f"{errs[name]}")
    return errs


def check_normal(torch):
    """`prng.normal` on the card: NORMAL_DRAWS draws from PRNGKey(3), the
    same bits as on the CPU and as jax's (NORMAL_SHA256). Returns the
    card's seconds for the draw."""
    import hashlib

    from repro_torch import prng

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = prng.normal(prng.PRNGKey(3, device="cuda"), (NORMAL_DRAWS,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cpu = prng.normal(prng.PRNGKey(3), (NORMAL_DRAWS,))
    differ = int((card.cpu().view(torch.int32)
                  != cpu.view(torch.int32)).sum())
    if differ:
        fail(f"prng.normal: {differ} of {NORMAL_DRAWS} draws differ between "
             f"the card and the CPU")
    digest = hashlib.sha256(
        cpu.numpy().astype("<f4").tobytes()).hexdigest()
    if digest != NORMAL_SHA256:
        fail(f"prng.normal: the draws are not jax.random.normal's (SHA-256 "
             f"{digest})")
    return seconds


def run_baselines(torch, engine):
    """Each of BASELINE_RUNS once on ``engine`` through
    `repro_torch.fl.baselines.run_baseline`, with the kernel counts zeroed
    just before and read just after. Every round must run under the
    round engine's no-sync fence (sync debug mode "error", so a hidden
    sync raises); K1 launches once a round for pFedGraph and nowhere
    else; the per-client test accuracies are finite and their mean at
    least the JAX reference's less LEARN_MARGIN. Returns {name: (mean
    accuracy, wall seconds, launch counts)}."""
    import numpy as np

    from repro_torch.data import ParticipationConfig
    from repro_torch.fl import baselines
    from repro_torch.fl.compress import CompressionConfig

    N = SMOKE_DATA["n_clients"]
    fenced = []
    run_rounds = baselines.run_rounds

    def fenced_run_rounds(round_step, state, rounds, **kw):
        def step(st):
            if torch.cuda.get_sync_debug_mode() != 2:
                fail(f"round {st.t} of a baseline ran outside the no-sync "
                     f"fence")
            fenced.append(st.t)
            return round_step(st)
        return run_rounds(step, state, rounds, **kw)

    out = {}
    baselines.run_rounds = fenced_run_rounds
    try:
        for name, (method, part, codec) in BASELINE_RUNS.items():
            kw = dict(BASELINE_RUN)
            if part is not None:
                kw["participation"] = ParticipationConfig(**part)
            if codec is not None:
                kw["compression"] = CompressionConfig(codec,
                                                      topk_frac=TOPK_FRAC)
            fenced.clear()
            torch.cuda.synchronize()
            _zero_launches()
            t0 = time.perf_counter()
            res = baselines.run_baseline(method, engine, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _read_launches()
            rounds = BASELINE_RUN["rounds"]
            if fenced != list(range(rounds)):
                fail(f"baseline {name}: fenced rounds {fenced}, expected "
                     f"{rounds}")
            want = {k: 0 for k in launches}
            if method == "pfedgraph":
                want["graph_mix"] = rounds
            if launches != want:
                fail(f"baseline {name}: kernel launches {launches}, "
                     f"expected {want}")
            acc = np.asarray(res["test_acc"])
            if acc.shape != (N,) or not np.isfinite(acc).all():
                fail(f"baseline {name}: test_acc is not a finite ({N},) "
                     f"vector")
            mean_acc = float(acc.mean())
            if mean_acc < LEARN_REF[name] - LEARN_MARGIN:
                fail(f"baseline {name}: mean test accuracy {mean_acc:.4f} "
                     f"< {LEARN_REF[name] - LEARN_MARGIN:.4f} (JAX "
                     f"reference {LEARN_REF[name]} less {LEARN_MARGIN})")
            out[name] = (mean_acc, seconds, launches)
    finally:
        baselines.run_rounds = run_rounds
    return out


def transfer_probes(torch, device):
    """One deliberate transfer of each class `TRANSFER_FENCED` names, on
    CUDA ``device``: {name: a callable that makes it and returns}."""
    import numpy as np

    x = torch.arange(4.0, device=device)
    host = np.arange(4.0, dtype=np.float32)
    pinned = torch.arange(4.0).pin_memory()
    return {
        "item": lambda: x[0].item(),
        "cpu": lambda: x.cpu(),
        "as_tensor numpy": lambda: torch.as_tensor(host, device=device),
        "tensor scalar": lambda: torch.tensor(3.0, device=device),
        "python scalar operand": lambda: x + 1.0,
        "pinned non_blocking to cuda": lambda: pinned.to(device,
                                                         non_blocking=True)}


def run_guards(torch, engine, dense_counts):
    """The guards phase on one device at full width
    (`repro_torch.analysis.guards`): the dense run of VARIANTS again,
    warm, under ``recompile_sentinel(expect_new=0)`` over every kernel
    library, each of its rounds checked to run inside `run_rounds`'
    ``no_transfer`` fence, with the dense run's launches; each of
    `transfer_probes` inside ``no_transfer``, which must raise
    where `TRANSFER_FENCED` says and pass where it does not, and inside
    ``allow_transfers``, where it must pass; the `donation_report` of the
    full-width dense `dpfl_round_step`. Returns the warm run's
    launches."""
    from repro_torch.analysis import guards
    from repro_torch.core import dpfl

    fenced = []
    run_rounds = dpfl.run_rounds

    def fenced_run_rounds(round_step, state, rounds, **kw):
        def step(st):
            if torch.cuda.get_sync_debug_mode() != 2:
                fail(f"guards: round {st.t} of the warm dense run ran "
                     f"outside the no_transfer fence")
            fenced.append(st.t)
            return round_step(st)
        return run_rounds(step, state, rounds, **kw)

    dpfl.run_rounds = fenced_run_rounds
    try:
        with guards.recompile_sentinel(expect_new=0) as h:
            res, cfg, counts, seconds, _ = run_main_path(torch, engine,
                                                         "dense")
    finally:
        dpfl.run_rounds = run_rounds
    if fenced != list(range(cfg.rounds)):
        fail(f"guards: fenced rounds {fenced}")
    if counts != dense_counts:
        fail(f"guards: the warm dense run launched {counts}, the first "
             f"{dense_counts}")
    print(f"guards: the dense run again, warm, under "
          f"recompile_sentinel(expect_new=0) over {len(h.names)} kernel "
          f"libraries: {h.new_builds()} new builds, {h.new_loads()} new "
          f"loads; its {cfg.rounds} rounds inside run_rounds' no_transfer "
          f"fence; launches {_nonzero(counts)} as the first run's; "
          f"{seconds:.3f} s wall; comm_downloads {res.comm_downloads}")
    for name, probe in transfer_probes(torch, "cuda").items():
        torch.cuda.synchronize()
        raised = None
        with guards.no_transfer("cuda"):
            try:
                probe()
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                raised = str(e).splitlines()[0]
            with guards.allow_transfers():
                probe()
        torch.cuda.synchronize()
        if (raised is not None) != TRANSFER_FENCED[name]:
            fail(f"guards: {name} inside no_transfer "
                 f"{'raised' if raised else 'passed'}, the guards "
                 f"docstring says it "
                 f"{'raises' if TRANSFER_FENCED[name] else 'passes'}")
        print(f"guards: {name} inside no_transfer: "
              + (f"raised ({raised})" if raised else "passed, not fenced")
              + "; inside allow_transfers: passed; as TRANSFER_FENCED "
                "says")
    state, _ = dpfl.dpfl_initial_state(engine, cfg)
    rep = guards.donation_report(dpfl.dpfl_round_step(engine, cfg), state)
    del state
    if rep["blocked"]:
        fail(f"guards: round-state leaves not donatable: {rep['blocked']}")
    if rep["in_place"] != rep["donatable"]:
        fail(f"guards: the donating round left donatable leaves out of "
             f"place: {sorted(set(rep['donatable']) - set(rep['in_place']))}")
    print(f"guards: donation_report of the dense dpfl_round_step at "
          f"PaperCNN width (N {SMOKE_DATA['n_clients']}, P "
          f"{engine.n_params}): donatable {rep['donatable']} "
          f"({rep['donatable_bytes']} bytes), blocked {rep['blocked']}, "
          f"in place {rep['in_place']}")
    return counts


@contextlib.contextmanager
def plain_round_steps():
    """Inside the block `run_dpfl` runs a round step that does not donate
    (`dpfl_round_step(donate=False)`: it allocates its outputs)."""
    from repro_torch.core import dpfl

    real = dpfl.dpfl_round_step
    dpfl.dpfl_round_step = functools.partial(real, donate=False)
    try:
        yield
    finally:
        dpfl.dpfl_round_step = real


DONATION_ORDER = ("plain", "donating", "donating", "plain")


def run_donation(torch, engine, dense_counts):
    """The donation phase at full PaperCNN width: the dense run of
    VARIANTS with the round step's donation off and on (`run_dpfl`'s
    default) in turns (DONATION_ORDER), each with the counts zeroed just
    before and read just after (the dense run's launches), its peak of
    allocated memory from a `reset_peak_memory_stats`, the memory
    allocated when it starts and the bytes the allocator hands out during
    it; all four bit for bit (best models, Omega, every graph, the
    counters, the accuracies); and the `donation_report` of each step
    from the dense initial state (the donating step's in place list
    holding every donatable leaf). Returns {label: launches}."""
    from repro_torch.analysis import guards
    from repro_torch.core import dpfl

    def handed_out():
        return torch.cuda.memory_stats()["allocated_bytes.all.allocated"]

    runs = []
    for label in DONATION_ORDER:
        ctx = plain_round_steps() if label == "plain" else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        base, before = torch.cuda.memory_allocated(), handed_out()
        with ctx:
            res, cfg, counts, seconds, peak = run_main_path(torch, engine,
                                                            "dense")
        if counts != dense_counts:
            fail(f"donation: the {label} dense run launched {counts}, the "
                 f"first dense run {dense_counts}")
        if runs and not _same_run(runs[0][1], res):
            fail(f"donation: dense run {len(runs)} ({label}) differs from "
                 f"run 0 ({runs[0][0]})")
        runs.append((label, res, counts, seconds, base, peak,
                     handed_out() - before))
    state, _ = dpfl.dpfl_initial_state(engine, cfg)
    reps = {label: guards.donation_report(
        dpfl.dpfl_round_step(engine, cfg, donate=label == "donating"),
        state) for label in ("plain", "donating")}
    del state
    if reps["donating"]["in_place"] != reps["donating"]["donatable"] or \
            reps["donating"]["blocked"]:
        fail(f"donation: the donating step's report {reps['donating']}")
    for label in ("plain", "donating"):
        print(f"donation: donation_report of the {label} dense round step: "
              f"in place {reps[label]['in_place']} of donatable "
              f"{reps[label]['donatable']} "
              f"({reps[label]['donatable_bytes']} bytes), blocked "
              f"{reps[label]['blocked']}")
    for i, (label, res, counts, seconds, base, peak, nbytes) in \
            enumerate(runs):
        print(f"donation: dense run {i} at PaperCNN width (N "
              f"{SMOKE_DATA['n_clients']}, P {engine.n_params}, "
              f"{cfg.rounds} rounds), round step {label}: {seconds:.3f} s "
              f"wall, allocated at its start {base} bytes, "
              f"max_memory_allocated {peak} after reset_peak_memory_stats "
              f"({peak - base} above its start), {nbytes} bytes handed out "
              f"by the allocator during the run; launches "
              f"{_nonzero(counts)}")
    print(f"donation: the {len(runs)} dense runs ({', '.join(DONATION_ORDER)}"
          f") bit for bit (best_flat, Omega, "
          f"{len(runs[0][1].graph_history)} graphs, comm counters, test and "
          f"val accuracies); {SMI}")
    return {f"{label} {i}": counts
            for i, (label, _, counts, *_) in enumerate(runs)}


def run_label_flip(torch):
    """Fig. 4's label-flip run (LABEL_FLIP_DATA, LABEL_FLIP_MLP,
    LABEL_FLIP_RUN: tests/test_fl_e2e.py::test_label_flip_segregation)
    through `run_dpfl` on the card, with the counts zeroed just before
    and read just after (K1: ceil(N/B) BGGC batches, the preprocessing
    mix, and each round's greedy init and mix), and on the CPU. Each
    run's last graph must segregate: its benign-to-benign edge rate above
    its benign-to-malicious one. The two graphs need not be equal (the
    greedy's coin flips amplify ulps). Returns {device: (result, edge
    rates (within, cross))}, the card's launches and the benign mask."""
    import numpy as np

    from repro_torch.core.dpfl import DPFLConfig, run_dpfl
    from repro_torch.data import make_label_flip_data
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    data = make_label_flip_data(**LABEL_FLIP_DATA)
    cfg = DPFLConfig(**LABEL_FLIP_RUN)
    benign = data.cluster == 0
    N, B = data.n_clients, cfg.budget
    out = {}
    for dev in ("cuda", "cpu"):
        engine = FLEngine(MLP(*LABEL_FLIP_MLP), data, device=dev,
                          **LABEL_FLIP_ENGINE)
        _zero_launches()
        res = run_dpfl(engine, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _read_launches()
        adj = res.graph_history[-1].astype(float)
        cross = adj[np.ix_(benign, ~benign)].mean()
        within = (adj[np.ix_(benign, benign)].sum() - benign.sum()) / \
            (benign.sum() * (benign.sum() - 1))
        if not within > cross:
            fail(f"label flip on {dev}: benign-to-benign edge rate "
                 f"{within:.4f} not above benign-to-malicious {cross:.4f}; "
                 f"last graph {res.graph_history[-1].astype(int).tolist()}")
        if not np.isfinite(res.test_acc).all() or \
                len(res.graph_history) != cfg.rounds:
            fail(f"label flip on {dev}: test acc {res.test_acc}, "
                 f"{len(res.graph_history)} graphs")
        out[dev] = (res, (within, cross))
    want = {name: 0 for name in _kernel_modules()}
    want["graph_mix"] = math.ceil(N / B) + 1 + 2 * cfg.rounds
    if launches != want:
        fail(f"label flip: launches {launches}, expected {want}")
    return out, launches, benign


def check_serve_guards(torch, cfg, model, params, gen):
    """qwen3-0.6b's serve again, warm, under
    ``recompile_sentinel(expect_new=0)``, each decode step checked to run
    inside `generate`'s ``no_transfer`` fence, the tokens the first
    call's; then the repair of ``build_model(attn_window=)``: the same
    weights (no copy) in a model built with ``attn_window=REPAIR_WINDOW``,
    shorter than the prompt, served through `generate` (its rings
    REPAIR_WINDOW slots, K4 once a layer in the prefill), its prefill
    logits and greedy tokens held against the same model with K4
    replaced by its plain version (K4_TOL). Returns the windowed serve's
    launches."""
    from repro_torch.analysis import guards
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import build_model

    B, new = SERVE_RUN["batch"], SERVE_RUN["new_tokens"]
    S = SERVE_RUN["prompt_len"]
    prompts = make_prompts(cfg.vocab_size, B, S, 0, "cuda")
    fenced = []
    step = model.decode_step

    def fenced_step(*args, **kw):
        fenced.append(torch.cuda.get_sync_debug_mode() == 2)
        return step(*args, **kw)

    model.decode_step = fenced_step
    try:
        with guards.recompile_sentinel(expect_new=0) as h:
            warm = generate(model, params, prompts, new)
    finally:
        del model.decode_step
    if fenced != [True] * (new - 1):
        fail(f"serve guards: decode steps inside the fence {fenced}")
    if not torch.equal(warm.tokens, gen.tokens):
        fail("serve guards: the warm serve gave other tokens")
    print(f"serve {cfg.name} guards: warm serve (B {B}, prompt {S}, {new} "
          f"new) under recompile_sentinel(expect_new=0): "
          f"{h.new_builds()} new builds, {h.new_loads()} new loads; its "
          f"{new - 1} decode steps inside generate's no_transfer fence; "
          f"the first call's tokens")
    windowed = build_model(cfg, device="meta", attn_window=REPAIR_WINDOW)
    windowed.load_state_dict(params, assign=True)
    if windowed.window != REPAIR_WINDOW:
        fail(f"serve window: model.window {windowed.window}")
    torch.cuda.synchronize()
    _zero_launches()
    got = generate(windowed, None, prompts, new)
    torch.cuda.synchronize()
    counts = _read_launches()
    if counts != generate_kernels(cfg, new):
        fail(f"serve window: launches {counts}, expected "
             f"{generate_kernels(cfg, new)}")
    kernel = ops.flash_attention
    ops.flash_attention = lambda q, k, v, *, causal=True, window=None: \
        ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    try:
        plain = generate(windowed, None, prompts, new)
    finally:
        ops.flash_attention = kernel
    err = _close(torch, "serve window: prefill logits against K4's plain "
                 "version", got.prefill_logits, plain.prefill_logits,
                 K4_TOL["float32"])
    if not torch.equal(got.tokens, plain.tokens):
        fail("serve window: greedy tokens differ from K4's plain version")
    if torch.equal(got.prefill_logits, gen.prefill_logits):
        fail("serve window: the window changed no logit")
    print(f"serve {cfg.name} window: build_model(cfg, attn_window="
          f"{REPAIR_WINDOW}) under a {S}-token prompt: launches "
          f"{_nonzero(counts)}; prefill logits within {err:.3g} of the "
          f"same model with K4's plain version (K4_TOL "
          f"{K4_TOL['float32']}), the same {new} greedy tokens; "
          f"prefill {got.prefill_seconds * 1e3:.3f} ms, decode "
          f"{got.decode_seconds / (new - 1) * 1e3:.3f} ms/step; the "
          f"logits differ from the unwindowed model's by "
          f"{(got.prefill_logits - gen.prefill_logits).abs().max():.3g}")
    return counts


def shard_config(run):
    """The DPFLConfig of a sharded run: SHARD_RUNS' "<variant>-random" is
    that variant on the Fig.-3 random graph."""
    if run.endswith("-random"):
        return smoke_config(run[:-len("-random")], **SMOKE_RUN,
                            random_graph=True)
    return smoke_config(run, **SMOKE_RUN)


def shard_launches(run, N, B, rounds, shards):
    """Each rank's launches in a sharded run: the single-device counts
    (`expected_launches`), since a rank makes every launch of the
    single-device run on its row block (BGGC's phase 1 streams all N
    peers in batches of B either way), except that the rotation
    launches K2 once per visiting panel, ``shards`` times a mix. The
    random graph runs no greedy: the preprocessing mix and each round's
    mix only (K1, K2 or, for the rounds of top-k, K3)."""
    want = {name: 0 for name in _kernel_modules()}
    if run == "dense-random":
        want["graph_mix"] = 1 + rounds
        return want
    if run == "sparse-random":
        want["sparse_graph_mix"] = (1 + rounds) * shards
        return want
    if run == "topk-random":
        want.update(graph_mix=1, compressed_graph_mix=rounds)
        return want
    want = expected_launches(run, N, B, rounds)
    want["sparse_graph_mix"] *= shards
    return want


def _spy_sparse_mixes(torch, ops, calls):
    """Keep a copy of the inputs and the output of each sharded call of
    `ops.sparse_graph_mix` (the rotation) in ``calls``; returns undo."""
    orig = ops.sparse_graph_mix

    def spy(self_w, nbr_w, nbr_idx, W_self, W_peers=None, *,
            peer_parts=None, peer_decode=None, mesh=None,
            client_axes=None):
        out = orig(self_w, nbr_w, nbr_idx, W_self, W_peers,
                   peer_parts=peer_parts, peer_decode=peer_decode,
                   mesh=mesh, client_axes=client_axes)
        if mesh is not None:
            keep = [t.clone() for t in (self_w, nbr_w, nbr_idx, W_self)]
            if peer_parts is None:
                peer_parts = (W_self if W_peers is None else W_peers,)
            calls.append((keep, tuple(t.clone() for t in peer_parts),
                          peer_decode, mesh, client_axes, out.clone()))
        return out

    ops.sparse_graph_mix = spy
    return lambda: setattr(ops, "sparse_graph_mix", orig)


def rotation_error(call) -> float:
    """The largest |gap| of one rank's rotated K2 mix (a `_spy_sparse_mixes`
    record) from the plain mix (`ref.sparse_graph_mix_ref`) of the same
    inputs over the all-gathered, decoded peer table."""
    from repro_torch.kernels import ref
    from repro_torch.sharding import collectives as coll

    (sw, nw, idx, W_self), parts, decode, mesh, axes, out = call
    whole = [coll.all_gather_rows(t, mesh, axes) for t in parts]
    peers = whole[0] if decode is None else decode(*whole)
    want = ref.sparse_graph_mix_ref(sw, nw, idx, W_self, peers)
    return float((out.float() - want.float()).abs().max())


def rotation_case(torch, engine, mesh):
    """A seeded rotation at the sharded shapes (N clients, B slots, P
    PaperCNN weights, this rank's rows) through an int8 codec's parts
    and decode, lists with -1 slots and a row of none, and zero self
    weights on a quarter of the rows; returns its `_spy_sparse_mixes`
    record."""
    from repro_torch.kernels import ops

    N, B, P = engine.data.n_clients, SMOKE_RUN["budget"], engine.n_params
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(-1, N, (N, B), generator=gen, device="cuda")
    idx[0] = -1
    sw = torch.rand((N,), generator=gen, device="cuda")
    sw[1::4] = 0.0
    nw = torch.where(idx >= 0, torch.rand((N, B), generator=gen,
                                          device="cuda"), 0.0)
    denom = (sw + nw.sum(dim=1)).clamp_min(1e-12)
    sw, nw = sw / denom, nw / denom[:, None]
    W = torch.randn((N, P), generator=gen, device="cuda")
    q = torch.randint(-127, 128, (N, P), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((N,), generator=gen, device="cuda") / 127
    r = engine.rows
    calls = []
    undo = _spy_sparse_mixes(torch, ops, calls)
    try:
        ops.sparse_graph_mix(
            sw[r].contiguous(), nw[r].contiguous(),
            idx[r].to(torch.int32).contiguous(), W[r].contiguous(),
            peer_parts=(q[r].contiguous(), scale[r].contiguous()),
            peer_decode=lambda qq, ss: qq.float() * ss[:, None],
            mesh=mesh, client_axes=engine.client_axes)
    finally:
        undo()
    return calls[0]


def sharded_rank(mesh, device, runs):
    """One rank of the sharded phase: the engine of `make_engine` cut to
    this rank's clients, then each run of ``runs`` through `run_dpfl`
    with the kernel counts zeroed just before and read just after, every
    round checked to start under the no-sync fence and every greedy
    decision's |u - a/(a+b)| recorded, and each rotated K2 mix held
    against the plain mix of its inputs over the all-gathered table
    (`rotation_error`, after the run's counts are read), then one round
    of the run's config audited (`analysis.commaudit.audit_config`).
    Returns, whole on every rank: each run's results, every rank's
    launches and walls, the smallest margin, the collectives' calls and
    bytes, the largest rotation error over the ranks (per run, and of
    `rotation_case`), the audit's report and its slowest rank's seconds,
    and each rank's device, TF32 switches and cuDNN determinism."""
    import torch

    from repro_torch.analysis import commaudit
    from repro_torch.core import dpfl, graph
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives as coll

    engine = make_engine().shard_clients(mesh)
    state = torch.tensor([[torch.cuda.current_device(),
                           int(torch.backends.cuda.matmul.allow_tf32),
                           int(torch.backends.cudnn.allow_tf32),
                           int(torch.backends.cudnn.deterministic)]],
                         device=device)
    out = {"ranks": engine.whole(state).tolist(), "runs": {},
           "device_type": mesh.device_type}
    fenced = []
    run_rounds = dpfl.run_rounds

    def fenced_run_rounds(round_step, st, rounds, **kw):
        def step(s):
            if torch.cuda.get_sync_debug_mode() != 2:
                fail(f"round {s.t} of a sharded run ran outside the "
                     f"no-sync fence")
            fenced.append(s.t)
            return round_step(s)
        return run_rounds(step, st, rounds, **kw)

    dpfl.run_rounds = fenced_run_rounds
    calls = []
    undo_spy = _spy_sparse_mixes(torch, ops, calls)
    try:
        for run in runs:
            cfg = shard_config(run)
            margins, undo = _greedy_margins(
                torch, graph, {"greedy": None, "reward": None})
            fenced.clear()
            calls.clear()
            coll.reset_counts()
            torch.cuda.synchronize()
            _zero_launches()
            t0 = time.perf_counter()
            try:
                res = dpfl.run_dpfl(engine, cfg)
                torch.cuda.synchronize()
            finally:
                undo()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            if fenced != list(range(cfg.rounds)):
                fail(f"sharded {run}: fenced rounds {fenced}")
            names = sorted(launches)
            per_rank = engine.whole(torch.tensor(
                [[launches[k] for k in names]], device=device)).tolist()
            margin = torch.cat(margins).min()[None] if margins else \
                torch.ones(1, device=device)
            walls = engine.whole(torch.tensor([wall], device=device))
            out["runs"][run] = dict(
                res=res, wall=walls.tolist(),
                launches=[dict(zip(names, r)) for r in per_rank],
                margin=float(engine.whole(margin).min()),
                collectives={k: list(v) for k, v in coll.counts.items()})
            # every rank makes the same number of mixes
            errs = torch.tensor([[rotation_error(c) for c in calls]],
                                device=device)
            out["runs"][run]["rotation"] = (
                len(calls), float(engine.whole(errs).max())
                if calls else None)
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            records = []
            out["runs"][run]["audit"] = commaudit.audit_config(
                engine, cfg, records=records)
            out["runs"][run]["records"] = records
            torch.cuda.synchronize()
            out["runs"][run]["audit_s"] = float(engine.whole(torch.tensor(
                [time.perf_counter() - t0], device=device)).max())
            calls.clear()
    finally:
        undo_spy()
        dpfl.run_rounds = run_rounds
    err = torch.tensor([rotation_error(rotation_case(torch, engine, mesh))],
                       device=device)
    out["rotation_case"] = float(engine.whole(err).max())
    return out


def _same_run(a, b) -> bool:
    """Two DPFLResults bit for bit: models, accuracies, graphs, counters."""
    import numpy as np

    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "best_flat", "test_acc", "omega", "val_acc_history",
        "graph_history")) and all(getattr(a, k) == getattr(b, k) for k in (
            "comm_downloads", "comm_preprocess", "comm_bytes"))


def run_sharded(torch, engine, single, records=None):
    """The sharded phase (SHARD_MESHES x SHARD_RUNS), each mesh one
    `run_on_client_mesh` launch on the card; ``single`` holds the
    single-device card runs of VARIANTS. The single-device random-graph
    run is made twice (the same bits, with cuDNN's deterministic
    algorithms, which `FLEngine` turns on), and each run of
    SHARD_BITWISE once more per mesh with ``_client_chunk`` the shard's
    client count, which the sharded run must equal bit for bit; each
    rotated mix of a sharded run, and a seeded int8 rotation, must be
    within TOL["float32"] of the plain mix over the gathered table.
    Returns
    {run label: launches, summed over the ranks} for the kernels line;
    ``records`` (a dict) gains {(mesh name, run): every rank's
    `CallRecord`s of the audited round}."""
    import numpy as np

    from repro_torch.core.dpfl import run_dpfl
    from repro_torch.launch.mesh import run_on_client_mesh
    from repro_torch.sharding.collectives import TRANSPORT

    print(f"sharded phase: transport {{(backend, op): how a CUDA tensor "
          f"crosses ranks}} {TRANSPORT} (gloo takes CUDA tensors in "
          f"all_gather; its send/recv takes CPU ones, through pinned host "
          f"buffers); {SMI}")
    N, B, rounds = SMOKE_DATA["n_clients"], SMOKE_RUN["budget"], \
        SMOKE_RUN["rounds"]
    launches = {}

    def single_run(run, label, chunk=None):
        engine._client_chunk = chunk
        try:
            _zero_launches()
            res = run_dpfl(engine, shard_config(run))
            launches[label] = _read_launches()
        finally:
            engine._client_chunk = None
        return res

    plain = dict(single, **{run: single_run(run, f"single-device {run}")
                            for run in SHARD_RUNS if run.endswith("-random")})
    if not _same_run(plain["dense-random"], single_run(
            "dense-random", "single-device dense-random, repeated")):
        fail("the single-device dense-random run did not repeat its bits")
    print("single-device dense-random: the same bits on a repeat")
    for mesh_name, (pods, per_pod) in SHARD_MESHES.items():
        world = pods * per_pod
        n_loc = N // world
        twins = {run: single_run(run, f"single-device {run} client_chunk "
                                      f"{n_loc}", n_loc)
                 for run in SHARD_BITWISE}
        t0 = time.perf_counter()
        out = run_on_client_mesh(sharded_rank, world, pods=pods,
                                 device="cuda:0", args=(SHARD_RUNS,))
        launch_s = time.perf_counter() - t0
        print(f"sharded {mesh_name}: {world} ranks of {n_loc} clients on "
              f"a {out['device_type']} DeviceMesh, (current device, "
              f"matmul TF32, cuDNN TF32, cuDNN deterministic) per rank "
              f"{out['ranks']}; the launch incl. spawn, CUDA init and "
              f"every run {launch_s:.3f} s; {SMI}")
        if any(r[1:] != [0, 0, 1] for r in out["ranks"]):
            fail(f"sharded {mesh_name}: a rank left TF32 on or cuDNN's "
                 f"deterministic algorithms off")
        if not out["rotation_case"] <= TOL["float32"]:
            fail(f"sharded {mesh_name}: the seeded int8 rotation is "
                 f"{out['rotation_case']} from the plain mix over the "
                 f"gathered table (tolerance {TOL['float32']})")
        print(f"sharded {mesh_name}: a seeded rotation at ({n_loc}, {B}, "
              f"{PAPER_CNN_PARAMS}) a rank, int8 parts decoded on each "
              f"visiting panel, -1 slots, a row of none, zero self "
              f"weights: max abs err {out['rotation_case']:.3g} against "
              f"the plain mix over the gathered table (tolerance "
              f"{TOL['float32']})")
        for run in SHARD_RUNS:
            got = out["runs"][run]
            if records is not None:
                records[(mesh_name, run)] = got["records"]
            res, cfg, ref = got["res"], shard_config(run), plain[run]
            want = shard_launches(run, N, B, rounds, world)
            for r, counts in enumerate(got["launches"]):
                if counts != want:
                    fail(f"sharded {mesh_name} {run} rank {r}: launches "
                         f"{counts}, expected {want}")
            launches[f"sharded {mesh_name} {run}"] = {
                k: sum(c[k] for c in got["launches"]) for k in want}
            # each rotated mix against the plain mix of its own inputs
            mixes, rot_err = got["rotation"]
            if mixes != want["sparse_graph_mix"] // world:
                fail(f"sharded {mesh_name} {run}: {mixes} rotated mixes "
                     f"held, expected {want['sparse_graph_mix'] // world}")
            if mixes and not rot_err <= TOL["float32"]:
                fail(f"sharded {mesh_name} {run}: a rotated K2 mix is "
                     f"{rot_err} from the plain mix of its inputs over "
                     f"the gathered table (tolerance {TOL['float32']})")
            rotation = (f"its {mixes} rotated mixes within {rot_err:.3g} "
                        f"of the plain mix of their inputs over the "
                        f"gathered table (tolerance {TOL['float32']}); "
                        if mixes else "")
            if (res.comm_downloads, res.comm_preprocess, res.comm_bytes) \
                    != (ref.comm_downloads, ref.comm_preprocess,
                        ref.comm_bytes):
                fail(f"sharded {mesh_name} {run}: counters differ from "
                     f"the single-device run's")
            same_graphs = np.array_equal(res.omega, ref.omega) and all(
                np.array_equal(a, b) for a, b in zip(res.graph_history,
                                                     ref.graph_history))
            if run in twins:
                if not _same_run(res, twins[run]):
                    fail(f"sharded {mesh_name} {run}: not bit for bit the "
                         f"single-device run with client_chunk {n_loc}")
                twin = (f"bit for bit the single-device run with "
                        f"client_chunk {n_loc} (best_flat, test_acc, val "
                        f"acc history, Omega, graphs, counters)")
            elif "sparse" in run:
                twin = ("no single-device twin (the rotation adds in "
                        "visit order)")
            else:
                twin = "not held against a single-device twin"
            if run.endswith("-random"):
                # the random graph: Omega and every graph are fixed
                if not same_graphs:
                    fail(f"sharded {mesh_name} {run}: graphs differ from "
                         f"the single-device run's")
                mean_acc = float(np.mean(res.test_acc))
            else:
                mean_acc = check_main_path(res, engine, cfg, run, want,
                                           None, want=want)
            print(f"sharded {mesh_name} {run}: wall per rank (s) "
                  f"{[round(w, 3) for w in got['wall']]}; launches per "
                  f"rank {_nonzero(got['launches'][0])} as expected; "
                  f"{rotation}collectives of rank 0 (calls, bytes sent) "
                  f"{got['collectives']}; {twin}; against the plain "
                  f"single-device run: counters equal, Omega and graphs "
                  f"{'equal' if same_graphs else 'differ'}, best_flat max "
                  f"abs diff "
                  f"{np.abs(res.best_flat - ref.best_flat).max():.3g}, "
                  f"mean test acc {mean_acc:.4f} against "
                  f"{np.mean(ref.test_acc):.4f}; smallest greedy "
                  f"|u - a/(a+b)| {got['margin']:.3g}; {SMI}")
            check_audit(mesh_name, run, got["audit"], res, world)
            print(f"sharded {mesh_name} {run}: the audit of one round took "
                  f"{got['audit_s']:.3f} s (its slowest rank, the round's "
                  f"starting state built as run_dpfl builds it)")
    return launches


def check_audit(mesh_name, run, rep, res, world):
    """One sharded run's audit (`analysis.commaudit.audit_config` of one
    round): on the random graph exact, reconciled against the run's
    ``comm_bytes`` and W equal to AUDIT_WIRE's; on the greedy graph no
    UNEXPLAINED row and the mix's wire still N x bpm x (D - 1). Prints
    the table."""
    from repro_torch.analysis import commaudit

    N = SMOKE_DATA["n_clients"]
    label = f"sharded {mesh_name} {run}"
    print(f"{label}: audit\n{rep.table()}")
    if rep.n_devices != world or rep.n_clients != N:
        fail(f"{label}: the audit saw D={rep.n_devices} N={rep.n_clients}")
    if "UNEXPLAINED" in {r.classification for r in rep.rows}:
        fail(f"{label}: the audit found an unexplained call")
    if not rep.ok:
        fail(f"{label}: the audit failed: {rep.failures}")
    W = rep.wire_model_bytes
    if W != N * rep.bytes_per_model * (world - 1):
        fail(f"{label}: wire {W} != N x bpm x (D - 1)")
    if not run.endswith("-random"):
        print(f"{label}: structural audit ok (no UNEXPLAINED row; the "
              f"refresh's {rep.wire_refresh_bytes} bytes attributed, not "
              f"charged)")
        return
    want = AUDIT_WIRE[("topk" if "topk" in run else "fp32", mesh_name)]
    if W != want:
        fail(f"{label}: audit wire {W} bytes, expected {want}")
    try:
        commaudit.reconcile(rep, res.comm_bytes[0])
    except AssertionError as e:
        fail(f"{label}: {e}")
    E = rep.claimed_downloads
    print(f"{label}: W = {W} bytes a round (expected {want}); W x E = "
          f"{W * E} == claimed x N x (D - 1) = {res.comm_bytes[0]} x {N} x "
          f"{world - 1}: reconciled")


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def check_checkpoint(torch, engine, res):
    """The dense run's best models (``best_flat`` unflattened on the card)
    through the port's ``CheckpointManager.keep_best``; ``restore_best``
    must give them back on the card bit for bit. Returns the files'
    bytes."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    best = engine.unflatten(torch.from_numpy(res.best_flat).to("cuda"))
    mgr = CheckpointManager(str(CKPT_DIR))
    if not mgr.keep_best(float(res.test_acc.mean()), best,
                         {"acc_per_client": res.test_acc.tolist()}):
        fail("checkpoint: keep_best refused the first model")
    back = mgr.restore_best({k: torch.empty_like(v)
                             for k, v in best.items()})
    for k, v in best.items():
        if back[k].device != v.device or not torch.equal(back[k], v):
            fail(f"checkpoint: {k} did not come back bit for bit")
    return sum(f.stat().st_size for f in CKPT_DIR.iterdir())


def serve_kernels(cfg):
    """The launches of each port kernel that one prefill of ``cfg`` must
    make, counted from the config alone: one launch of each layer's
    kernel (`layer_kernels`); every other kernel none."""
    want = {name: 0 for name in _kernel_modules()}
    for kname in layer_kernels(cfg):
        want[kname] += 1
    return want


def decode_kernels(cfg, steps):
    """The launches of each port kernel that ``steps`` decode steps of
    ``cfg`` must make: an audio model's cross-attention, K4 once a
    decoder layer and step (the ring's self-attention is plain); no
    kernel in any other family's decode."""
    want = {name: 0 for name in _kernel_modules()}
    if cfg.family == "audio":
        want["flash_attention"] = steps * cfg.n_layers
    return want


def generate_kernels(cfg, new_tokens):
    """The launches of `generate` with ``new_tokens``: the prefill's
    (`serve_kernels`) and those of its new_tokens - 1 decode steps
    (`decode_kernels`)."""
    decode = decode_kernels(cfg, new_tokens - 1)
    return {k: n + decode[k] for k, n in serve_kernels(cfg).items()}


def cut_layers(cfg, params, n_layers):
    """``cfg`` and its state dict ``params`` cut to their first
    ``n_layers`` layers (an audio model's first n_layers encoder and
    decoder layers), the embedding, head and norms kept."""
    stacks = ("enc_layers", "dec_layers", "layers")
    cfg = cfg.replace(n_layers=n_layers, **(
        {"n_enc_layers": n_layers} if cfg.family == "audio" else {}))
    return cfg, {k: v for k, v in params.items()
                 if k.split(".")[0] not in stacks
                 or int(k.split(".")[1]) < n_layers}


def serve_model(torch, arch):
    """``arch`` (one of SERVE_ARCHS) at its published config in float32
    (cut to its first SERVE_LAYERS[arch] layers where it has an entry),
    built on "meta" and its weights drawn from seed 0 on the card (so
    they exist once); returns (cfg,
    model, params)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(dtype="float32")
    full_layers = cfg.n_layers
    layers = f"{cfg.n_layers} layers"
    if cfg.family == "audio":
        layers = (f"{cfg.n_enc_layers} encoder and {cfg.n_layers} decoder "
                  f"layers")
    if arch in SERVE_LAYERS:
        cfg = cfg.replace(n_layers=SERVE_LAYERS[arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    params = model.init(prng.PRNGKey(0, device="cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = sum(t.numel() for t in params.values())
    if cfg.family == "ssm":
        shape = (f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} SSM "
                 f"heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
                 f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk}")
    else:
        shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                 f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")
        if cfg.family == "hybrid":
            shape += (f", pattern {cfg.hybrid_pattern}, lru width "
                      f"{cfg.lru_width}, window {cfg.local_window}")
        if cfg.family == "moe":
            shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                     f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top "
                     f"{cfg.topk} of d_ff {cfg.d_expert_ff}")
        if cfg.family == "vlm":
            shape += f", {cfg.n_vision_tokens} vision positions"
        if cfg.family == "audio":
            shape += f", {cfg.n_audio_frames} frames"
    cut = "" if full_layers == cfg.n_layers else \
        f" (the first of its {full_layers})"
    print(f"{arch}: {layers}{cut}, d_model {cfg.d_model}, "
          f"{shape}, "
          f"vocab {cfg.vocab_size}: {n} float32 weights, drawn on the card "
          f"in {seconds:.2f} s; max_memory_allocated after init "
          f"{torch.cuda.max_memory_allocated()} bytes")
    return cfg, model, params


def make_vision(torch, cfg, batch, device="cuda"):
    """A vlm's vision embeddings (batch, n_vision_tokens, d_model), unit
    normals from VISION_SEED on ``device``; None for another family."""
    if cfg.family != "vlm":
        return None
    gen = torch.Generator(device=device).manual_seed(VISION_SEED)
    return torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                       generator=gen, device=device)


def make_frames(torch, cfg, batch, device="cuda"):
    """An audio model's frames (batch, n_audio_frames, d_model), unit
    normals from FRAMES_SEED on ``device``; None for another family."""
    if cfg.family != "audio":
        return None
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED)
    return torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                       generator=gen, device=device)


def moe_routing(torch, model, fn):
    """``fn()`` with a forward hook on every MoE block of ``model`` that
    keeps, on the device (no sync: decode runs under the no-sync fence),
    each call's token count, smallest gap between the k-th and (k+1)-th
    router probability and the copies its capacity drops (a forward
    recomputed under remat is a call too). Returns (fn's result, {"gap":
    the smallest gap, "prefill": (dropped, copies), "decode": (dropped,
    copies)}, summed over the layers and calls, a call of more than one
    token a prefill; None for a model without MoE blocks)."""
    from repro_torch.models import moe

    rec = []

    @torch.no_grad()   # saves nothing for a backward (or a recompute)
    def hook(mod, args, out):
        x, cfg = args[0], args[1]
        x2 = x.reshape(-1, x.shape[-1])
        probs = moe.router_probs(x2, mod.router)
        _, idx = moe.top_k(probs, cfg.topk)
        rec.append((x.shape[1], x2.shape[0] * cfg.topk,
                    moe.router_gap(probs, cfg.topk),
                    moe.dropped_copies(idx, cfg.n_experts)))
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, moe.MoE)]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    if not rec:
        return out, None
    stats = {"gap": min(float(r[2]) for r in rec)}
    for phase, keep in (("prefill", lambda s: s > 1),
                        ("decode", lambda s: s == 1)):
        rows = [r for r in rec if keep(r[0])]
        stats[phase] = (sum(int(r[3]) for r in rows),
                        sum(r[1] for r in rows))
    return out, stats


def run_serve(torch, cfg, model, params):
    """The serving path once through `generate` (a vlm's vision
    embeddings from `make_vision`, an audio model's frames from
    `make_frames`, its prompt SERVE_PROMPT's) with every kernel count
    zeroed just before and read just after (`generate_kernels`: one
    launch per layer of the layer's kernel, K4, K5 or K6, in the prefill
    and no other kernel; an audio model's K4 three times a layer pair in
    the prefill and once a decoder layer in each decode step); then
    `generate`'s prefill phase alone, counted the same way, so the decode
    loop's launches are the difference; then a second call, which
    must give the same tokens (and, for a moe model, the same logits bit
    for bit), and for a moe model a third, its routing observed
    (`moe_routing`). Returns (launches, each launched kernel's (prefill,
    decode) launches, the first call's Generation, the second's, the
    routing statistics or None)."""
    from repro_torch.launch.serve import generate, make_prompts, prefill

    B, new = SERVE_RUN["batch"], SERVE_RUN["new_tokens"]
    S = SERVE_PROMPT.get(cfg.name, SERVE_RUN["prompt_len"])
    want = generate_kernels(cfg, new)
    want_split = {k: (n, decode_kernels(cfg, new - 1)[k])
                  for k, n in serve_kernels(cfg).items() if want[k]}
    prompts = make_prompts(cfg.vocab_size, B, S, 0, "cuda")
    vision = make_vision(torch, cfg, B)
    frames = make_frames(torch, cfg, B)
    torch.cuda.synchronize()
    _zero_launches()
    gen = generate(model, params, prompts, new, vision=vision, frames=frames)
    torch.cuda.synchronize()
    launches = _read_launches()
    if launches != want:
        fail(f"serve {cfg.name}: kernel launches {launches}, expected "
             f"{want}")
    _zero_launches()
    prefill(model, prompts, new, vision, frames)
    torch.cuda.synchronize()
    n_prefill = _read_launches()
    split = {k: (n_prefill[k], launches[k] - n_prefill[k])
             for k, n in want.items() if n}
    if split != want_split:
        fail(f"serve {cfg.name}: launches (prefill, decode) {split}, "
             f"expected {want_split}")
    if tuple(gen.tokens.shape) != (B, new):
        fail(f"serve {cfg.name}: tokens {tuple(gen.tokens.shape)}, expected "
             f"{(B, new)}")
    if int(gen.tokens.min()) < 0 or int(gen.tokens.max()) >= cfg.vocab_size:
        fail(f"serve {cfg.name}: a token outside the vocabulary")
    for name in ("prefill_logits", "last_logits"):
        logits = getattr(gen, name)
        if tuple(logits.shape) != (B, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"serve {cfg.name}: {name} not a finite "
                 f"{(B, cfg.vocab_size)} table")
    again = generate(model, params, prompts, new, vision=vision,
                     frames=frames)
    if not torch.equal(again.tokens, gen.tokens):
        fail(f"serve {cfg.name}: a second call gave other tokens")
    if cfg.family == "moe" and not (
            torch.equal(again.prefill_logits, gen.prefill_logits)
            and torch.equal(again.last_logits, gen.last_logits)):
        fail(f"serve {cfg.name}: a second call gave other logits bits")
    # a third call, its MoE routing observed (`moe_routing`)
    _, routing = moe_routing(torch, model, lambda: generate(
        model, params, prompts, new, vision=vision, frames=frames))
    return launches, split, gen, again, routing


def check_cross(torch, cfg, model, params):
    """The same weights on the card and on the CPU (copied from the card:
    drawing 0.4-6.5 B threefry normals on the CPU is slow), batch 1: the
    greedy tokens equal and the last-position prefill logits within
    CROSS_TOL, so the family's kernels (K4, K5, K6) are held against the
    plain path inside the model. A model in CROSS_LAYERS runs cut to its
    first layers, on both sides, with its embedding, head and final norm.
    Returns (max abs logits difference, CPU seconds, layers run, the card
    side's routing statistics, `moe_routing`: None without MoE layers,
    the prompt's length)."""
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import build_model

    n_layers = CROSS_LAYERS.get(cfg.name, cfg.n_layers)
    if n_layers != cfg.n_layers:
        cfg, params = cut_layers(cfg, params, n_layers)
        model = build_model(cfg, device="meta")
    B, new = CROSS_RUN["batch"], CROSS_RUN["new_tokens"]
    S = CROSS_PROMPT.get(cfg.name, CROSS_RUN["prompt_len"])
    want = generate_kernels(cfg, new)
    prompts = make_prompts(cfg.vocab_size, B, S, 1, "cuda")
    vision = make_vision(torch, cfg, B)
    frames = make_frames(torch, cfg, B)
    _zero_launches()
    card, routing = moe_routing(torch, model, lambda: generate(
        model, params, prompts, new, vision=vision, frames=frames))
    torch.cuda.synchronize()
    n_card = _read_launches()
    t0 = time.perf_counter()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu = generate(build_model(cfg, device="meta"), cpu_params, prompts.cpu(),
                   new, vision=None if vision is None else vision.cpu(),
                   frames=None if frames is None else frames.cpu())
    seconds = time.perf_counter() - t0
    n_cpu = {k: v - n_card[k] for k, v in _read_launches().items()}
    if n_card != want or any(n_cpu.values()):
        fail(f"{cfg.name} card against CPU: launches {n_card} on the card "
             f"(expected {want}), {n_cpu} on the CPU")
    diff = (card.prefill_logits.cpu() - cpu.prefill_logits).abs().max().item()
    if not diff <= CROSS_TOL:
        fail(f"{cfg.name} card against CPU: prefill logits differ by {diff} "
             f"> {CROSS_TOL}")
    if not torch.equal(card.tokens.cpu(), cpu.tokens):
        fail(f"{cfg.name} card against CPU: tokens {card.tokens.tolist()} "
             f"!= {cpu.tokens.tolist()}")
    return diff, seconds, n_layers, routing, S


def layer_kernels(cfg):
    """Per layer of ``cfg``, in order, the port kernel its prefill runs:
    K4 (the attention of a dense, vlm or moe layer; a moe layer's experts
    are plain batched products), K5 (Mamba2) or K6 (RG-LRU); a hybrid
    model's layers follow its pattern unit cyclically (`repro`'s
    segments). An audio model's entries are its attentions, each a K4
    launch: one an encoder layer, then two a decoder layer (self and
    cross)."""
    if cfg.family == "audio":
        return ["flash_attention"] * (cfg.n_enc_layers + 2 * cfg.n_layers)
    if cfg.family == "ssm":
        return ["ssd"] * cfg.n_layers
    if cfg.family == "hybrid":
        unit = cfg.hybrid_pattern
        return ["rglru_scan" if unit[i % len(unit)] == "rec"
                else "flash_attention" for i in range(cfg.n_layers)]
    if cfg.family in ("dense", "vlm", "moe"):
        return ["flash_attention"] * cfg.n_layers
    fail(f"layer_kernels: no port path for the {cfg.family} family")


def train_launches(cfg, steps):
    """The launches of each port kernel that ``steps`` train steps of
    ``cfg`` must make, counted from its layer kinds (`layer_kernels`):
    under remat "full" each layer's forward runs twice a step (the loss,
    then its recompute in the backward pass), so its kernel's forward
    launches twice a layer and step and its backward once; every other
    kernel none."""
    want = {name: 0 for name in _kernel_modules()}
    for kname in layer_kernels(cfg):
        want[kname] += 2 * steps
        # a bf16 model's attention backward is the bf16 library's; its
        # scans run in fp32 (the models cast their inputs, as `repro`'s)
        bf16 = cfg.dtype == "bfloat16" and kname == "flash_attention"
        want[kname + ("_bwd_bf16" if bf16 else "_bwd")] += steps
    return want


@contextlib.contextmanager
def record_aux(model):
    """Within the block, ``model.loss`` (an attribute of the instance,
    which the train step looks up at each call) keeps each call's router
    loss, detached, on the device (no sync), in the list it yields. The
    wrapper is removed on leaving: it refers to the model, which refers
    to it, and that cycle would keep the weights on the card until the
    garbage collector ran."""
    seen = []
    loss = model.loss

    def wrapped(batch):
        out = loss(batch)
        seen.append(out[1]["aux"].detach())
        return out
    model.loss = wrapped
    try:
        yield seen
    finally:
        del model.loss


def run_train(torch, argv=None, cut=None):
    """The training path once, with every kernel count zeroed just before
    and read just after (`train_launches`): `repro_torch.launch.train.
    main(argv)`, or for ``cut`` (TRAIN_HYBRID, TRAIN_VLM, TRAIN_MOE,
    TRAIN_AUDIO, TRAIN_BF16) the config at ``cut``'s dtype (float32
    unless given) cut to its first ``n_layers`` layers, its init
    of PRNGKey(0) on the card and `launch.train.train` (a vlm's vision
    embeddings from `make_vision`, an audio model's frames from
    `make_frames`; a moe model's router loss of each step kept,
    `record_aux`); every loss finite and the last below the first.
    Then AdamW alone (its update and the weights' addition, on gradients
    of the weights' shapes) three times, by the host clock around
    synchronized calls. Returns a dict of the run's numbers."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    aux = None
    if cut is None:
        steps = int(argv[argv.index("--steps") + 1])
        batch, seq = (int(argv[argv.index(f) + 1])
                      for f in ("--batch", "--seq"))
        run = train.main(argv)
    else:
        steps, batch, seq = cut["steps"], cut["batch"], cut["seq"]
        cfg = get_config(cut["arch"]).replace(
            dtype=cut.get("dtype", "float32"))
        cfg = cfg.replace(n_layers=cut["n_layers"], **(
            {"n_enc_layers": cut["n_layers"]} if cfg.family == "audio"
            else {}))
        model = build_model(cfg, device="meta", loss_chunks=4)
        model.init(prng.PRNGKey(0, device="cuda"))
        print(f"arch={cfg.name} ({cfg.n_layers} layers) params="
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
        with (record_aux(model) if cfg.family == "moe"
              else contextlib.nullcontext()) as aux:
            run = train.train(model, train.lm_corpus(cfg, batch, seq),
                              steps=steps, batch=batch, lr=cut["lr"],
                              vision=make_vision(torch, cfg, batch),
                              frames=make_frames(torch, cfg, batch))
        del model
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    aux = None if aux is None else [float(a) for a in aux]
    peak = torch.cuda.max_memory_allocated()
    cfg = run.model.cfg
    want = train_launches(cfg, steps)
    if launches != want:
        fail(f"train {cfg.name}: kernel launches {launches}, expected {want}")
    if len(run.losses) != steps or \
            not all(math.isfinite(x) for x in run.losses):
        fail(f"train {cfg.name}: losses {run.losses}")
    if not run.losses[-1] < run.losses[0]:
        fail(f"train {cfg.name}: the last loss {run.losses[-1]} is not "
             f"below the first {run.losses[0]}")
    params = dict(run.model.named_parameters())
    grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
    opt_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        updates, run.opt_state = run.optimizer.update(grads, run.opt_state,
                                                      params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        torch.cuda.synchronize()
        opt_times.append(time.perf_counter() - t0)
        del updates
    del grads, params
    warm = statistics.median(run.step_seconds[2:])
    return dict(arch=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
                batch=batch, seq=seq,
                vision=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
                frames=cfg.n_audio_frames if cfg.family == "audio" else 0,
                n_params=run.n_params, steps=steps, losses=run.losses,
                step_seconds=run.step_seconds, warm_step_s=warm,
                optimizer_s=statistics.median(opt_times),
                optimizer_share=statistics.median(opt_times) / warm,
                peak_bytes=peak, launches=launches, seconds=seconds,
                aux=aux)


def print_train(tr):
    per_step = ", ".join(
        f"{n // tr['steps']} {k}" for k, n in tr["launches"].items() if n)
    layers = f"{tr['n_layers']}" + (" encoder and decoder" if tr["frames"]
                                    else "")
    print(f"train {tr['arch']} ({layers} layers) {tr['dtype']} "
          f"B={tr['batch']} S={tr['seq']}"
          + (f" + {tr['vision']} vision" if tr["vision"] else "")
          + (f" after {tr['frames']} frames" if tr["frames"] else "") +
          f", {tr['steps']} steps, "
          f"{tr['n_params']} weights: losses "
          f"{[round(x, 4) for x in tr['losses']]}, step walls (s) "
          f"{[round(x, 4) for x in tr['step_seconds']]}, warm step "
          f"{tr['warm_step_s']:.4f} s (median of steps 2-9), AdamW alone "
          f"{tr['optimizer_s']:.4f} s ({tr['optimizer_share']:.3f} of a "
          f"step), peak allocated {tr['peak_bytes']} bytes, launches "
          f"{tr['launches']} ({per_step} a step), run {tr['seconds']:.1f} "
          f"s with init and corpus" + ("" if tr["aux"] is None else
                                       f"; router loss of each step "
                                       f"{[round(a, 6) for a in tr['aux']]}"))


def cross_train_tols(cfg):
    """(loss, gradient) tolerances of a cut run at ``cfg``'s dtype."""
    if cfg.dtype == "bfloat16":
        return CROSS_TRAIN_BF16_LOSS_TOL, CROSS_TRAIN_BF16_GRAD_TOL
    return CROSS_TRAIN_LOSS_TOL, CROSS_TRAIN_GRAD_TOL


def check_cross_train(torch, name):
    """CROSS_TRAINS[name] on the card and by the port on the CPU (the
    card's init copied to the host before any step): the step-0
    gradients within `cross_train_tols`' (CROSS_TRAIN_GRAD_TOL, or
    CROSS_TRAIN_BF16_GRAD_TOL for the bf16 run) (each leaf as a share of its
    largest element), then 3 steps of the training loop
    (`launch.train.train`) on each, the card's launches `train_launches`
    and the CPU's none, the losses within `cross_train_tols`' of each
    other and of the JAX reference's (CROSS_TRAIN_JAX_LOSSES[name]).
    Returns (card losses, CPU losses, the largest gradient share, the
    card's launches, the card's trained weights, CPU seconds)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    c = CROSS_TRAINS[name]
    jax_losses = CROSS_TRAIN_JAX_LOSSES[name]
    if jax_losses is None or len(jax_losses) != c["steps"]:
        fail(f"no JAX reference losses for {name}: run "
             f"tools/jax_reference_smoke.py {name}")
    cfg = get_config(c["arch"])
    if c.get("reduced"):
        cfg = cfg.reduced()
    cfg = cfg.replace(dtype=c.get("dtype", "float32"), **{
        k: c[k] for k in ("n_layers", "n_enc_layers") if k in c})
    loss_tol, grad_tol = cross_train_tols(cfg)
    card = build_model(cfg, device="meta", loss_chunks=4)
    params = card.init(prng.PRNGKey(0, device="cuda"))
    cpu = build_model(cfg, device="meta", loss_chunks=4)
    cpu.load_state_dict({k: v.to("cpu", copy=True)
                         for k, v in params.items()}, assign=True)
    corpus = train.lm_corpus(cfg, c["batch"], c["seq"])
    first = corpus[train.batch_rows(corpus.shape[0], c["batch"], 1)[0]]
    grads = {}
    for side, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        batch = {"tokens": torch.from_numpy(first).to(dev)}
        if cfg.family == "vlm":   # `launch.train`'s zero vision embeddings
            batch["vision"] = torch.zeros(
                (c["batch"], cfg.n_vision_tokens, cfg.d_model), device=dev)
        if cfg.family == "audio":   # and its zero frames
            batch["frames"] = torch.zeros(
                (c["batch"], cfg.n_audio_frames, cfg.d_model), device=dev)

        def step0():
            loss, _ = model.loss(batch)
            return torch.autograd.grad(loss, list(model.parameters()))
        grads[side], routing = moe_routing(torch, model, step0)
        if side == "card" and routing is not None and \
                not routing["prefill"][0]:
            fail(f"{name}: the capacity dropped no copy at step 0")
    share = 0.0
    for (pname, _), g, w in zip(card.named_parameters(), grads["card"],
                                grads["cpu"]):
        g, w = g.cpu().float(), w.float()
        sh = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if not sh <= grad_tol:
            fail(f"{name} card against CPU: step-0 gradient of {pname} "
                 f"differs by {sh} of its largest element")
        share = max(share, sh)
    del grads
    kw = dict(steps=c["steps"], batch=c["batch"], lr=c["lr"], log_every=1)
    _zero_launches()
    on_card = train.train(card, corpus, **kw)
    torch.cuda.synchronize()
    n_card = _read_launches()
    t0 = time.perf_counter()
    on_cpu = train.train(cpu, corpus, **kw)
    seconds = time.perf_counter() - t0
    n_cpu = {k: v - n_card[k] for k, v in _read_launches().items()}
    want = train_launches(cfg, c["steps"])
    if n_card != want or any(n_cpu.values()):
        fail(f"{name} card against CPU: launches {n_card} on the card "
             f"(expected {want}), {n_cpu} on the CPU")
    for label, other in (("the CPU", on_cpu.losses), ("JAX", jax_losses)):
        diff = max(abs(a - b) for a, b in zip(on_card.losses, other))
        if not diff <= loss_tol:
            fail(f"{name} card against {label}: losses {on_card.losses} "
                 f"and {other} differ by {diff} > {loss_tol}")
    return (on_card.losses, on_cpu.losses, share, n_card,
            dict(card.named_parameters()), seconds)


def check_dpfl_mix(torch, params):
    """`make_dpfl_mix` on DPFL_MIX_CLIENTS client copies of ``params``
    (client c's copy plus 0.01 c seeded normal noise, so the mix moves
    them) under a seeded row-stochastic A, with the kernel counts zeroed
    just before and read just after: K1 once per leaf and nothing else,
    every leaf within TOL["float32"] of K1's plain version. Returns (the
    launches, the largest error, the mix's seconds)."""
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import make_dpfl_mix

    C = DPFL_MIX_CLIENTS
    gen = torch.Generator(device="cuda").manual_seed(7)
    A = torch.rand((C, C), generator=gen, device="cuda")
    A = A / A.sum(dim=1, keepdim=True)
    with torch.no_grad():
        stacked = {k: torch.stack([v + 0.01 * c * torch.randn(
            v.shape, generator=gen, device="cuda") for c in range(C)])
            for k, v in params.items()}
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    mixed = make_dpfl_mix(A)(stacked)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    want = {name: 0 for name in _kernel_modules()}
    want["graph_mix"] = len(stacked)
    if launches != want:
        fail(f"DPFL mix: launches {launches}, expected {want}")
    err = 0.0
    for k, w in stacked.items():
        plain = ref.graph_mix_ref(A, w.reshape(C, -1)).reshape(w.shape)
        err = max(err, _close(torch, f"DPFL mix {k}", mixed[k], plain,
                              TOL["float32"]))
    return launches, err, seconds


def check_k4_vmap(torch):
    """K4 under ``torch.func.vmap`` over the clients in every
    K4_VMAP_CASES case, through `ops.flash_attention` (the LM's call)
    without grad and under autograd: one forward launch per vmapped call
    and one backward call (the client axis folded into the batch axis);
    the output, and dq, dk and dv, bit for bit those of per-client
    launches; the output within TOL["float32"] of the plain version, and
    each gradient, as a share of its largest element (as check_k4_bwd
    holds them), within TOL["float32"] of the plain backward's. Returns
    per case (max abs err of the output, the largest gradient share)."""
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ops, ref

    def counts():
        return k4.flash_attention.launches, k4.flash_attention_bwd.launches

    gen = torch.Generator(device="cuda").manual_seed(13)
    vf = torch.func.vmap(ops.flash_attention)
    rows = []
    for name, N, B, S, Hq, Hkv, hd in K4_VMAP_CASES:
        def draw(H, scale):
            return torch.randn((N, B, S, H, hd), generator=gen,
                               device="cuda") * scale
        q, k, v, dout = draw(Hq, 0.5), draw(Hkv, 0.5), draw(Hkv, 1.0), \
            draw(Hq, 1.0)

        def fold(t):
            return t.flatten(0, 1)
        before = counts()
        with torch.no_grad():
            out = vf(q, k, v)
        torch.cuda.synchronize()
        if counts() != (before[0] + 1, before[1]):
            fail(f"K4 vmapped {name}: launches {counts()} from {before}, "
                 f"expected one forward")
        with torch.no_grad():
            each = torch.stack([ops.flash_attention(q[i], k[i], v[i])
                                for i in range(N)])
        if not torch.equal(out, each):
            fail(f"K4 vmapped {name}: not bit for bit the per-client "
                 f"launches")
        err = _close(torch, f"K4 vmapped {name}", out, ref.flash_attention_ref(
            fold(q), fold(k), fold(v)).unflatten(0, (N, B)), TOL["float32"])
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = counts()
        out_g = vf(*leaves)
        grads = torch.autograd.grad(out_g, leaves, dout)
        torch.cuda.synchronize()
        if counts() != (before[0] + 1, before[1] + 1):
            fail(f"K4 vmapped {name} under autograd: launches {counts()} "
                 f"from {before}, expected one forward and one backward")
        if not torch.equal(out_g, out):
            fail(f"K4 vmapped {name}: the forward with its LSE gave other "
                 f"bits than without")
        each = []
        for i in range(N):
            li = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
            each.append(torch.autograd.grad(ops.flash_attention(*li), li,
                                            dout[i]))
        plain = ref.flash_attention_bwd_ref(fold(q), fold(k), fold(v),
                                            fold(dout))
        share = 0.0
        for j, label in enumerate(("dq", "dk", "dv")):
            if not torch.equal(grads[j], torch.stack([e[j] for e in each])):
                fail(f"K4 vmapped {name}: {label} not bit for bit the "
                     f"per-client launches'")
            w = plain[j].unflatten(0, (N, B))
            scale = w.abs().max().clamp_min(1e-30)
            _close(torch, f"K4 vmapped {name} {label} / max |{label}|",
                   grads[j] / scale, w / scale, TOL["float32"])
            share = max(share, ((grads[j] - w).abs().max() / scale).item())
        rows.append((err, share))
    return rows


def lm_dpfl_launches(n_layers, N, nb, cfg):
    """The launches of one `run_dpfl` of the LM example over N clients of
    ``n_layers`` attention layers, ``nb`` minibatches an epoch: every
    vmapped call over the clients launches K4 once a layer on the folded
    batch. Local steps (nb a local epoch: tau_init, then tau_train a
    round) run its forward and backward; the reward (one vmapped forward
    of the 4N probe models per greedy position: N positions in BGGC and
    in each round's GGC) and the evaluations (accuracy and loss each:
    eval_val every round, eval_test once) its forward. K1 as in the dense
    PaperCNN run (`expected_launches`)."""
    steps = nb * (cfg.tau_init + cfg.rounds * cfg.tau_train)
    forwards = steps + N * (1 + cfg.rounds) + 2 * (cfg.rounds + 1)
    want = expected_launches("dense", N, cfg.budget, cfg.rounds)
    want.update(flash_attention=n_layers * forwards,
                flash_attention_bwd=n_layers * steps)
    return want


def _spans(torch, timed):
    """``(start, end)`` CUDA events around a call, appended to ``timed``
    (no sync: read after the run with `_span_ms`); a no-op off the card."""
    def around(fn, *args, **kw):
        if timed is None:
            return fn(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        timed.append((start, end))
        return out
    return around


def _span_ms(spans):
    return sum(a.elapsed_time(b) for a, b in spans)


def _greedy_margins(torch, graph, spans):
    """Patch ``graph.greedy_decision_step`` so that every decision records
    |u - a/(a+b)| a client (the coin flip against its probability; 1
    where a + b = 0, which is no coin flip), as device tensors, and, on
    the card, the span of each decision step and of its reward call into
    ``spans["greedy"]`` and ``spans["reward"]``; returns (the list the
    margins go to, the function that undoes the patch)."""
    inner = graph.greedy_decision_step
    margins = []

    def recording(reward_fn):
        last = {}

        def reward(probes, k_idx):
            last["r"] = _spans(torch, spans["reward"])(reward_fn, probes,
                                                      k_idx)
            return last["r"]
        step = inner(reward)

        def rec_step(carry, j, w_j, *, u, **kw):
            out = _spans(torch, spans["greedy"])(step, carry, j, w_j, u=u,
                                                 **kw)
            r = last["r"]
            a = (r[:, 1] - r[:, 0]).clamp_min(0.0)
            b = (r[:, 3] - r[:, 2]).clamp_min(0.0)
            margins.append(torch.where(a + b > 0, (u - a / (a + b)).abs(),
                                       1.0))
            return out
        return rec_step

    graph.greedy_decision_step = recording

    def undo():
        graph.greedy_decision_step = inner
    return margins, undo


def run_lm_dpfl(torch, cfg, n_clients, device):
    """The LM example (`examples/lm_dpfl_torch.py`: its corpus, engine and
    `DPFLConfig`) over ``n_clients`` clients of ``cfg`` on ``device`` once,
    with the kernel counts zeroed just before and read just after, every
    round under the no-sync fence (a hidden sync raises; a round outside
    the fence fails), each local step's (N,) losses and each greedy
    decision's |u - a/(a+b)| recorded, and on the card the device spans
    (CUDA events, read after the run) of the local steps, the greedy's
    decision steps and their reward calls, the memory allocated when the
    run starts ("base") and the peak of allocated memory before the first
    round, in each round and after the last ("segments", the allocator's
    statistics read and reset between rounds, where no kernel waits).
    Returns a dict of the run."""
    import lm_dpfl_torch as ex

    from repro_torch.analysis.guards import allow_transfers
    from repro_torch.core import DPFLConfig, dpfl, graph

    engine, cluster_of = ex.lm_engine(cfg, n_clients, device)
    run = DPFLConfig(**ex.RUN)
    losses, fenced = [], []
    spans = {k: [] if device == "cuda" else None
             for k in ("local steps", "greedy", "reward")}
    loss_and_grads = engine._loss_and_grads

    def recording(params, batch, loss_fn):
        loss, grads = _spans(torch, spans["local steps"])(
            loss_and_grads, params, batch, loss_fn)
        losses.append(loss)
        return loss, grads

    engine._loss_and_grads = recording
    run_rounds = dpfl.run_rounds

    def fenced_run_rounds(round_step, state, rounds, **kw):
        def step(st):
            if device == "cuda" and torch.cuda.get_sync_debug_mode() != 2:
                fail(f"round {st.t} of lm-dpfl ran outside the no-sync "
                     f"fence")
            fenced.append(st.t)
            return round_step(st)
        return run_rounds(step, state, rounds, **kw)

    segments = []

    def segment():
        # the peak since the last reset, then a new segment
        if device == "cuda":
            with allow_transfers():
                segments.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()

    def segmented_run_rounds(round_step, state, rounds, **kw):
        def step(st):
            segment()
            return round_step(st)
        return fenced_run_rounds(step, state, rounds, **kw)

    dpfl.run_rounds = segmented_run_rounds
    margins, undo = _greedy_margins(torch, graph, spans)
    try:
        base = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        _zero_launches()
        t0 = time.perf_counter()
        res = dpfl.run_dpfl(engine, run)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        segment()
    finally:
        dpfl.run_rounds = run_rounds
        undo()
    if fenced != list(range(run.rounds)):
        fail(f"lm-dpfl {cfg.name} on {device}: fenced rounds {fenced}")
    nb = engine.data.train_x.shape[1] // engine.batch_size
    return dict(
        res=res, run=run, engine=engine, cluster_of=cluster_of,
        split=ex.graph_split(res.graph_history[-1], cluster_of),
        launches=launches, seconds=seconds, nb=nb,
        want=lm_dpfl_launches(cfg.n_layers, n_clients, nb, run),
        losses=torch.stack(losses).cpu(),
        margin=torch.cat(margins).min().item(),
        peak=max(segments, default=0), base=base, segments=segments,
        span_ms={k: _span_ms(v) for k, v in spans.items() if v is not None})


def check_lm_dpfl_cross(torch):
    """The LM example's own setting (its reduced qwen3, 6 clients) on the
    card and on the CPU: the same Omega and graphs (a greedy near-tie
    that split them would show as a small |u - a/(a+b)|, printed before
    failing), equal test and validation accuracies, the best models'
    validation losses within CROSS_TRAIN_LOSS_TOL (the card-against-
    reference loss tolerance of the training runs), the card's launches
    `lm_dpfl_launches` and the CPU's none. Returns (card run, CPU run),
    the card's with the losses' largest difference as "val_loss_err"."""
    import lm_dpfl_torch as ex
    import numpy as np

    card = run_lm_dpfl(torch, ex.example_config(), ex.CLIENTS, "cuda")
    cpu = run_lm_dpfl(torch, ex.example_config(), ex.CLIENTS, "cpu")
    if card["launches"] != card["want"] or any(cpu["launches"].values()):
        fail(f"lm-dpfl card against CPU: launches {card['launches']} on the "
             f"card (expected {card['want']}), {cpu['launches']} on the CPU")
    a, b = card["res"], cpu["res"]
    same = np.array_equal(a.omega, b.omega) and \
        len(a.graph_history) == len(b.graph_history) and \
        all(np.array_equal(x, y) for x, y in zip(a.graph_history,
                                                 b.graph_history))
    if not same:
        fail(f"lm-dpfl card against CPU: other graphs; smallest greedy "
             f"|u - a/(a+b)| card {card['margin']:.3g}, CPU "
             f"{cpu['margin']:.3g}")
    # accuracies are fractions of counts: equal
    if not np.array_equal(a.test_acc, b.test_acc) or \
            len(a.val_acc_history) != len(b.val_acc_history) or \
            not all(np.array_equal(x, y) for x, y in
                    zip(a.val_acc_history, b.val_acc_history)):
        fail(f"lm-dpfl card against CPU: test acc {a.test_acc} and "
             f"{b.test_acc}, val acc {a.val_acc_history} and "
             f"{b.val_acc_history}")
    val_loss = [r["engine"].eval_val(r["engine"].unflatten(torch.as_tensor(
        r["res"].best_flat, device=r["engine"].device)))[1].cpu()
        for r in (card, cpu)]
    card["val_loss_err"] = (val_loss[0] - val_loss[1]).abs().max().item()
    if not card["val_loss_err"] <= CROSS_TRAIN_LOSS_TOL:
        fail(f"lm-dpfl card against CPU: the best models' validation "
             f"losses {val_loss[0].tolist()} and {val_loss[1].tolist()} "
             f"differ by {card['val_loss_err']:.3g} (tol "
             f"{CROSS_TRAIN_LOSS_TOL})")
    return card, cpu


def check_lm_dpfl_full(torch):
    """lm-dpfl at LM_DPFL_FULL (full width, 2 layers, 4 clients) on the
    card: launches `lm_dpfl_launches`, finite local losses and the mean
    loss of the first step after tau_init below the first step's, Omega
    and every round's graph within the budget (self edge included, each
    graph inside Omega). Returns the run (`run_lm_dpfl`)."""
    import numpy as np

    from repro_torch.configs import get_config

    c = LM_DPFL_FULL
    cfg = get_config(c["arch"]).replace(n_layers=c["n_layers"],
                                        dtype="float32")
    out = run_lm_dpfl(torch, cfg, c["clients"], "cuda")
    res, run, losses = out["res"], out["run"], out["losses"]
    if out["launches"] != out["want"]:
        fail(f"lm-dpfl {cfg.name}: launches {out['launches']}, expected "
             f"{out['want']}")
    first = out["nb"] * run.tau_init
    if not torch.isfinite(losses).all() or \
            not losses[first].mean() < losses[0].mean():
        fail(f"lm-dpfl {cfg.name}: step losses {losses.mean(1).tolist()} "
             f"(the mean after tau_init, step {first}, must be below the "
             f"first step's)")
    N = c["clients"]
    for label, adj in [("Omega", res.omega)] + [
            (f"round {t}", g) for t, g in enumerate(res.graph_history)]:
        adj = np.asarray(adj, bool)
        if adj.shape != (N, N) or not adj.diagonal().all() or \
                (adj.sum(1) > run.budget + 1).any() or \
                (adj & ~np.asarray(res.omega, bool)).any():
            fail(f"lm-dpfl {cfg.name}: {label}'s graph {adj.astype(int)} "
                 f"is not within the budget {run.budget} and Omega")
    if not np.isfinite(res.test_acc).all():
        fail(f"lm-dpfl {cfg.name}: test accuracies {res.test_acc}")
    return out


def check_lm_dpfl_turns(torch, full):
    """lm-dpfl at LM_DPFL_FULL again after the donating run ``full``
    (`check_lm_dpfl_full`), with a round step that does not donate
    (`plain_round_steps`): its launches, Omega, every graph and test
    accuracies ``full``'s. Each run's peaks before its first round and in
    each round show where donation moves the peak (a plain round keeps
    the caller's round-start state beside its own output from round 1
    on). Returns [(label, run)] of the two runs in order
    (`run_lm_dpfl`)."""
    import numpy as np

    from repro_torch.configs import get_config

    c = LM_DPFL_FULL
    cfg = get_config(c["arch"]).replace(n_layers=c["n_layers"],
                                        dtype="float32")
    turns = [("donating", full)]
    for label in ("plain",):
        ctx = plain_round_steps() if label == "plain" else \
            contextlib.nullcontext()
        with ctx:
            out = run_lm_dpfl(torch, cfg, c["clients"], "cuda")
        a, b = full["res"], out["res"]
        if out["launches"] != full["launches"] or \
                not np.array_equal(a.omega, b.omega) or \
                not all(np.array_equal(x, y) for x, y in
                        zip(a.graph_history, b.graph_history)) \
                or not np.array_equal(a.test_acc, b.test_acc):
            fail(f"lm-dpfl {cfg.name}: run {len(turns)} ({label}; launches "
                 f"{out['launches']}, test acc {b.test_acc}) differs from "
                 f"the first ({full['launches']}, {a.test_acc})")
        turns.append((label, out))
    return turns


def run_personalized(torch):
    """Personalized serving at PERSONALIZED_RUN (`examples/
    serve_personalized_torch.py` on the whole published model): the
    stacked init, then `serve_personalized` with the kernel counts zeroed
    just before and read just after (one K4 launch per layer, all in the
    prefill: `personalized_prefill` alone is counted the same way, so
    decode's are the difference, none), a second call with the same
    tokens, requests 0 and 2 apart, and each request's tokens equal to
    `generate` on its own client's weights alone. Returns a dict."""
    import serve_personalized_torch as ex

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import build_model

    c = PERSONALIZED_RUN
    cfg = get_config(c["arch"]).replace(dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta", remat="none")
    stacked = ex.stacked_init(model, ex.CLIENTS, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    client_ids = torch.tensor([r for r, _ in ex.REQUESTS], device="cuda")
    R, S, new = len(ex.REQUESTS), c["prompt_len"], c["new_tokens"]
    prompts = make_prompts(cfg.vocab_size, R, S, c["seed"], "cuda")
    want = serve_kernels(cfg)
    _zero_launches()
    first = ex.serve_personalized(model, stacked, client_ids, prompts, new)
    torch.cuda.synchronize()
    launches = _read_launches()
    _zero_launches()
    params = {k: v[client_ids] for k, v in stacked.items()}
    ex.personalized_prefill(model, params, prompts, new)
    torch.cuda.synchronize()
    n_prefill = _read_launches()
    del params
    if launches != want or n_prefill != want:
        fail(f"personalized {cfg.name}: launches {launches}, in the prefill "
             f"alone {n_prefill}, expected {want} in the prefill and none "
             f"in decode")
    again = ex.serve_personalized(model, stacked, client_ids, prompts, new)
    if tuple(first.tokens.shape) != (R, new) or \
            not torch.isfinite(first.prefill_logits).all():
        fail(f"personalized {cfg.name}: tokens {tuple(first.tokens.shape)}")
    if not torch.equal(again.tokens, first.tokens):
        fail(f"personalized {cfg.name}: a second call gave other tokens")
    if torch.equal(first.tokens[0], first.tokens[2]):
        fail(f"personalized {cfg.name}: requests 0 and 2 (clients 0 and 2) "
             f"gave the same tokens")
    alone = build_model(cfg, device="meta")
    for r, cid in enumerate(client_ids.tolist()):
        own = {k: v[cid] for k, v in stacked.items()}
        gen = generate(alone, own, prompts[r:r + 1], new)
        if not torch.equal(gen.tokens[0], first.tokens[r]):
            fail(f"personalized {cfg.name}: request {r} gave "
                 f"{first.tokens[r].tolist()}, generate on client {cid}'s "
                 f"weights alone {gen.tokens[0].tolist()}")
    return dict(cfg=cfg, launches=launches, first=first, again=again,
                init_s=init_s, n_weights=sum(v[0].numel()
                                             for v in stacked.values()),
                peak=torch.cuda.max_memory_allocated())


def mesh_config(arch, layers):
    """``arch``'s published config in float32, cut to its first
    ``layers`` layers."""
    from repro_torch.configs import get_config

    return get_config(arch).replace(dtype="float32", n_layers=layers)


def _stepped(torch, model):
    """Keep the logits of every `decode_step` of ``model`` (device
    tensors) and whether each step began under the no-sync fence.
    Returns (logits, fenced, undo)."""
    inner = model.decode_step
    logits, fenced = [], []

    def step(caches, token, pos):
        fenced.append(torch.cuda.get_sync_debug_mode() == 2)
        out, caches = inner(caches, token, pos)
        logits.append(out.clone())
        return out, caches

    model.decode_step = step
    return logits, fenced, lambda: delattr(model, "decode_step")


def _routing_hooks(torch, model, shards, mesh=None):
    """Forward hooks on the MoE blocks of ``model`` keeping, on the device
    (decode runs under the no-sync fence), each call's phase (more than
    one token: the prefill), the copies its capacity drops on each of
    ``shards`` equal blocks of experts (with a mesh: on the rank's own
    block alone), its aux loss and, in the prefill, its router
    probabilities and top-k picks. Returns (records, undo)."""
    from repro_torch.models import moe

    rec = []

    @torch.no_grad()
    def hook(mod, args, out):
        x, cfg = args[0], args[1]
        E = cfg.n_experts
        probs = moe.router_probs(x.reshape(-1, x.shape[-1]), mod.router)
        idx = moe.top_k(probs, cfg.topk)[1]
        blocks = [moe.expert_block(cfg, mesh)] if mesh is not None else \
            [(i * E // shards, E // shards) for i in range(shards)]
        prefill = x.shape[1] > 1
        rec.append((prefill, torch.stack([moe.dropped_copies(
            idx, E, first_expert=f, n_local=n) for f, n in blocks]),
            out[1].detach(), (probs, idx) if prefill else None))
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, moe.MoE)]
    return rec, lambda: [h.remove() for h in hooks]


def _routing_summary(torch, rec):
    """{"prefill": copies dropped on each expert block summed over the
    prefill's calls, "decode": over the decode steps', "aux": the
    prefill's aux loss a layer, "router": its router probabilities and
    top-k picks a layer} as host values; None without MoE."""
    if not rec:
        return None
    out = {}
    for phase, keep in (("prefill", True), ("decode", False)):
        rows = [r[1] for r in rec if r[0] == keep]
        out[phase] = torch.stack(rows).sum(0).tolist() if rows else \
            [0] * len(rec[0][1])
    out["aux"] = [float(r[2]) for r in rec if r[0]]
    out["router"] = [(r[3][0].cpu(), r[3][1].cpu()) for r in rec if r[0]]
    return out


def aux_of_blocks(torch, blocks):
    """The aux loss a layer of the data blocks' single-device prefills
    together (each a `_routing_summary`), the value the model mesh's
    ranks must each hold: one block's own `load_balance_loss`, or
    `load_balance_loss` over the blocks' router probabilities and top-k
    picks concatenated, in the batch's order. Neither goes through
    `moe.router_stats` or `moe.load_balance_from_stats`, the formula the
    mesh path applies to its psum."""
    from repro_torch.models import moe

    if len(blocks) == 1:
        return blocks[0]["aux"]
    return [float(moe.load_balance_loss(
        torch.cat([p for p, _ in layer]), torch.cat([i for _, i in layer]),
        layer[0][0].shape[1]))
        for layer in zip(*(b["router"] for b in blocks))]


def mesh_reference(torch, model, cfg, shards, rows=slice(None)):
    """The single-device run the model-mesh ranks are held to: `generate`
    on ``rows`` of SERVE_RUN's prompts (seed 0, the serve run's), every
    step's logits kept (the prefill's first) and the MoE routing on
    ``shards`` expert blocks (`_routing_hooks`). Returns {"logits" (B,
    new, V), "tokens" (B, new): numpy, "routing": `_routing_summary`,
    "layers": the model's depth}."""
    from repro_torch.launch.serve import generate, make_prompts

    B, S, new = (SERVE_RUN[k] for k in ("batch", "prompt_len",
                                        "new_tokens"))
    prompts = make_prompts(cfg.vocab_size, B, S, 0, "cuda")[rows]
    steps, _, undo = _stepped(torch, model)
    rec, unhook = _routing_hooks(torch, model, shards)
    try:
        gen = generate(model, None, prompts, new)
    finally:
        undo()
        unhook()
    logits = torch.stack([gen.prefill_logits] + steps, 1)
    return {"logits": logits.cpu().numpy(),
            "tokens": gen.tokens.cpu().numpy(),
            "routing": _routing_summary(torch, rec), "layers": cfg.n_layers}


def _ranks(torch, x, mesh):
    """Every rank's ``x`` (a tensor), stacked in rank order."""
    from repro_torch.sharding import collectives as coll

    return coll.all_gather_rows(x[None].contiguous(), mesh,
                                tuple(mesh.mesh_dim_names))


def model_mesh_rank(mesh, device, run):
    """One rank of the model-mesh phase's run ``run`` (MODEL_MESH_RUNS):
    the model built on the mesh (its attention rings and a moe model's
    experts split over "model") and drawn from seed 0 on the card (a rank
    draws only its experts), then `generate` on SERVE_RUN's whole prompts
    (the rank serves its rows of the batch) with the kernel counts and
    the collectives' zeroed just before and read just after, every decode
    step's logits and fence kept, the collectives' counts read again at
    the first decode step (what the decode steps spend in them is the
    difference), and the MoE routing of the rank's experts observed.
    Returns, on rank 0: the logits and tokens gathered whole, and every
    rank's seconds, peak, launches, collectives and routing."""
    import torch

    from repro_torch import prng
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as coll

    arch, layers, _ = MODEL_MESH_RUNS[run]
    cfg = mesh_config(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta", mesh=mesh,
                        decode_cache_seqshard=True)
    n_weights = sum(t.numel() for t in model.init(
        prng.PRNGKey(0, device=device)).values())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, new = (SERVE_RUN[k] for k in ("batch", "prompt_len",
                                        "new_tokens"))
    prompts = make_prompts(cfg.vocab_size, B, S, 0, device)
    steps, fenced, undo = _stepped(torch, model)
    stepped, at_decode = model.decode_step, []

    def first_step(*args):
        if not at_decode:
            at_decode.append({k: list(v) for k, v in coll.counts.items()})
        return stepped(*args)
    model.decode_step = first_step
    rec, unhook = _routing_hooks(torch, model, 1, mesh)
    coll.reset_counts()
    torch.cuda.synchronize()
    _zero_launches()
    try:
        gen = generate(model, None, prompts, new)
        torch.cuda.synchronize()
    finally:
        undo()
        unhook()
    launches = _read_launches()
    counts = {k: list(v) for k, v in coll.counts.items()}
    names = sorted(launches)
    logits = torch.stack([gen.prefill_logits] + steps, 1)
    routing = _routing_summary(torch, rec)
    # the decode steps' collectives: calls and seconds
    decode_coll = [sum(counts[op][j] - at_decode[0][op][j] for op in counts)
                   for j in (0, 2)]
    row = [init_s, gen.prefill_seconds, gen.decode_seconds,
           torch.cuda.max_memory_allocated(), n_weights, len(steps),
           float(all(fenced))] + [launches[k] for k in names] + \
        [v for op in sorted(counts) for v in counts[op]] + decode_coll
    stats = _ranks(torch, torch.tensor(row, dtype=torch.float64,
                                       device=device), mesh)
    out = {"logits": coll.all_gather_rows(logits, mesh, ("data",)),
           "tokens": coll.all_gather_rows(gen.tokens, mesh, ("data",)),
           "stats": stats, "names": names, "ops": sorted(counts)}
    if routing is not None:
        out["routing"] = _ranks(torch, torch.tensor(
            routing["prefill"] + routing["decode"] + routing["aux"],
            dtype=torch.float64, device=device), mesh)
    out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    return dict(out, device_type=mesh.device_type)


def _compare_steps(want, got):
    """(max abs err of the logits over the steps up to the first step
    whose greedy token differs in some row (all of them where none does),
    that step or None, the smallest top-2 gap of the reference's logits
    in the rows that part there)."""
    import numpy as np

    diff = (want["tokens"] != got["tokens"]).any(axis=0)
    t = int(np.argmax(diff)) if diff.any() else None
    upto = want["logits"].shape[1] if t is None else t + 1
    err = float(np.abs(got["logits"][:, :upto] -
                       want["logits"][:, :upto]).max())
    gap = None
    if t is not None:
        rows = np.flatnonzero(want["tokens"][:, t] != got["tokens"][:, t])
        top = np.sort(want["logits"][rows, t], axis=-1)[:, -2:]
        gap = float((top[:, 1] - top[:, 0]).min())
    return err, t, gap


def run_model_mesh(torch):
    """The model-mesh phase (MODEL_MESH_RUNS), each run one `run_on_mesh`
    launch on the card after its single-device reference was made here
    and freed (each data block alone: a moe block's capacity is the
    block's). Each
    rank must launch K4 once a layer and nothing else, run every decode
    step under the no-sync fence, make its expected collectives (one
    pmax and two psums a layer a decode step; a moe layer's psum over
    model, and over data where it is longer than 1, a call), give every
    step's logits within MESH_LOGITS_TOL of its rows of the reference
    (the same greedy tokens, or a parting where the reference's top-2 gap
    is under MESH_GAP), and a moe rank drop the reference's copies on its
    experts, its aux losses within MESH_AUX_TOL of the whole batch's
    (`aux_of_blocks`, from the blocks' single-device runs). Returns {run:
    launches summed over the ranks}."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.collectives import TRANSPORT

    print(f"model-mesh phase: transport {TRANSPORT}; {SMI}")
    B, S, new = (SERVE_RUN[k] for k in ("batch", "prompt_len",
                                        "new_tokens"))
    launches = {}
    for run, (arch, layers, (D, M)) in MODEL_MESH_RUNS.items():
        cfg = mesh_config(arch, layers)
        L, moe_layers = cfg.n_layers, cfg.n_layers * (cfg.family == "moe")
        t0 = time.perf_counter()
        model = build_model(cfg, device="meta")
        model.init(prng.PRNGKey(0, device="cuda"))
        blocks = [mesh_reference(torch, model, cfg, M,
                                 slice(b * B // D, (b + 1) * B // D))
                  for b in range(D)]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run_on_mesh(model_mesh_rank, (D, M), ("data", "model"),
                          device="cuda:0", args=(run,))
        launch_s = time.perf_counter() - t0
        names, ops = out["names"], out["ops"]
        stats = out["stats"]
        nk = len(names)
        per_rank = [dict(zip(names, map(int, r[7:7 + nk]))) for r in stats]
        coll = [{op: (int(r[7 + nk + 3 * j]), int(r[8 + nk + 3 * j]))
                 for j, op in enumerate(ops)} for r in stats]
        # the decode steps' collective calls and seconds, per rank
        at = 7 + nk + 3 * len(ops)
        dec_calls, dec_coll_s = stats[:, at], stats[:, at + 1]
        want = {k: 0 for k in names}
        want["flash_attention"] = L
        want_coll = {"pmax": (new - 1) * L * (M > 1),
                     "psum": (new - 1) * 2 * L * (M > 1)
                     + new * moe_layers * ((M > 1) + (D > 1))}
        want_dec_calls = sum(want_coll.values()) - \
            moe_layers * ((M > 1) + (D > 1))
        for r, (got, c, row) in enumerate(zip(per_rank, coll, stats)):
            if got != want:
                fail(f"model mesh {run} rank {r}: launches {got}, expected "
                     f"{want}")
            if row[5] != new - 1 or row[6] != 1.0:
                fail(f"model mesh {run} rank {r}: {int(row[5])} decode "
                     f"steps, not all under the no-sync fence")
            if {op: c[op][0] for op in want_coll} != want_coll:
                fail(f"model mesh {run} rank {r}: collectives {c}, "
                     f"expected calls {want_coll}")
            if dec_calls[r] != want_dec_calls:
                fail(f"model mesh {run} rank {r}: {int(dec_calls[r])} "
                     f"collectives in the decode steps, expected "
                     f"{want_dec_calls}")
        launches[f"model mesh {run}"] = {
            k: sum(p[k] for p in per_rank) for k in names}
        got = {"logits": out["logits"], "tokens": out["tokens"]}
        want_whole = {k: np.concatenate([b[k] for b in blocks])
                      for k in ("logits", "tokens")}
        if got["logits"].shape != (B, new, cfg.vocab_size) or \
                not np.isfinite(got["logits"]).all():
            fail(f"model mesh {run}: logits {got['logits'].shape} not a "
                 f"finite {(B, new, cfg.vocab_size)} table")
        err, part, gap = _compare_steps(want_whole, got)
        if not err <= MESH_LOGITS_TOL:
            fail(f"model mesh {run}: logits {err} from the single-device "
                 f"run's rows (tolerance {MESH_LOGITS_TOL})")
        if part is not None and not gap < MESH_GAP:
            fail(f"model mesh {run}: greedy tokens part at step {part} "
                 f"where the reference's top-2 gap is {gap}")
        tokens = ("the same greedy tokens" if part is None else
                  f"greedy tokens parting at step {part}, the reference's "
                  f"top-2 gap there {gap:.3g} (under {MESH_GAP})")
        routing = ""
        if "routing" in out:
            per = out["routing"]
            for r, row in enumerate(per):
                b, i = divmod(r, M)
                twin = blocks[b]["routing"]
                if [row[0], row[1]] != [twin["prefill"][i],
                                        twin["decode"][i]]:
                    fail(f"model mesh {run} rank {r}: dropped copies "
                         f"(prefill, decode) {row[:2].tolist()}, its "
                         f"block's single-device run "
                         f"{[twin['prefill'][i], twin['decode'][i]]}")
            whole_aux = aux_of_blocks(torch, [b["routing"] for b in blocks])
            aux_err = float(np.abs(per[:, 2:] - np.asarray(whole_aux)).max())
            if not aux_err <= MESH_AUX_TOL:
                fail(f"model mesh {run}: aux losses {aux_err} from the "
                     f"whole batch's (tolerance {MESH_AUX_TOL})")
            routing = (f"; copies dropped per rank (prefill, decode) "
                       f"{per[:, :2].astype(int).tolist()}, each its data "
                       f"block's single-device run's on its experts; the "
                       f"prefill's aux losses a layer {np.round(whole_aux, 6).tolist()}, "
                       f"every rank's within {aux_err:.3g} of the whole "
                       f"batch's (`load_balance_loss` of the blocks' "
                       f"single-device routing; tolerance {MESH_AUX_TOL})")
        print(f"model mesh {run}: {arch} on {L} layers, mesh (data {D}, "
              f"model {M}) of {D * M} ranks on a {out['device_type']} "
              f"DeviceMesh, B {B} (B/D {B // D} a rank), prompt {S}, {new} "
              f"new, rings of {S + new} slots ({(S + new) // M} a rank); "
              f"weights a rank {stats[:, 4].astype(int).tolist()}; "
              f"single-device reference {ref_s:.3f} s, the launch incl. "
              f"spawn, CUDA init, the draws and the run {launch_s:.3f} s; "
              f"per rank: init (s) {np.round(stats[:, 0], 3).tolist()}, "
              f"prefill (ms) {np.round(stats[:, 1] * 1e3, 3).tolist()}, "
              f"decode (ms/step) "
              f"{np.round(stats[:, 2] * 1e3 / (new - 1), 3).tolist()}, "
              f"peak allocated {stats[:, 3].astype(int).tolist()}, "
              f"decode's collectives (their calls, each timed from the "
              f"device reaching it to its return) "
              f"{np.round(dec_coll_s * 1e3 / (new - 1), 3).tolist()} ms a "
              f"step, {np.round(dec_coll_s / stats[:, 2], 4).tolist()} of "
              f"the decode wall ({int(dec_calls[0]) // (new - 1)} calls a "
              f"step), "
              f"launches {_nonzero(per_rank[0])}, collectives (calls, "
              f"bytes sent) of rank 0 {coll[0]}; every decode step under "
              f"the no-sync fence; logits of every step within {err:.3g} "
              f"of the single-device run's rows (tolerance "
              f"{MESH_LOGITS_TOL}), {tokens}{routing}; {SMI}")
    return launches


def lm_client_rank(mesh, device):
    """One rank of the LM example's run on the client mesh: its engine
    (reduced qwen3 clients, `DPFLConfig(**RUN)`) sharded over ``mesh``,
    `run_dpfl` with the kernel counts and the collectives zeroed just
    before and read just after, every round checked to start under the
    no-sync fence. Returns the result and every rank's launches, wall and
    peak, and rank 0's collectives."""
    import lm_dpfl_torch as ex
    import torch

    from repro_torch.core import DPFLConfig, dpfl
    from repro_torch.sharding import collectives as coll

    engine, _ = ex.lm_engine(ex.example_config(), ex.CLIENTS, device)
    engine.shard_clients(mesh)
    run = DPFLConfig(**ex.RUN)
    fenced, run_rounds = [], dpfl.run_rounds

    def fenced_run_rounds(round_step, st, rounds, **kw):
        def step(s):
            fenced.append(torch.cuda.get_sync_debug_mode() == 2)
            return round_step(s)
        return run_rounds(step, st, rounds, **kw)

    dpfl.run_rounds = fenced_run_rounds
    try:
        coll.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        res = dpfl.run_dpfl(engine, run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dpfl.run_rounds = run_rounds
    launches = _read_launches()
    names = sorted(launches)
    stats = _ranks(torch, torch.tensor(
        [wall, torch.cuda.max_memory_allocated(), float(len(fenced)),
         float(all(fenced))] + [launches[k] for k in names],
        dtype=torch.float64, device=device), mesh)
    return {"res": res, "stats": stats.cpu().numpy(), "names": names,
            "rows": (engine.rows.start, engine.rows.stop),
            "collectives": {k: list(v) for k, v in coll.counts.items()}}


def run_lm_client_mesh(torch, card):
    """LM clients on the client mesh (LM_CLIENT_MESHES), each mesh one
    `run_on_client_mesh` launch on the card: the run must equal bit for
    bit the single-device card run whose forwards and backwards take the
    shard's client count (``_client_chunk``), select the plain card run's
    (``card``, check_lm_dpfl_cross's) Omega, graphs and downloads, make
    on every rank the single-device run's launches (`lm_dpfl_launches`:
    a rank makes every vmapped call on its rows) and run every round
    under the no-sync fence. Returns {run: launches summed over the
    ranks}."""
    import lm_dpfl_torch as ex
    import numpy as np

    from repro_torch.core import DPFLConfig, run_dpfl
    from repro_torch.launch.mesh import run_on_client_mesh

    plain, want = card["res"], card["want"]
    launches = {}
    for name, world in LM_CLIENT_MESHES.items():
        n_loc = ex.CLIENTS // world
        engine, _ = ex.lm_engine(ex.example_config(), ex.CLIENTS, "cuda")
        engine._client_chunk = n_loc
        _zero_launches()
        twin = run_dpfl(engine, DPFLConfig(**ex.RUN))
        launches[f"lm-dpfl client_chunk {n_loc}"] = _read_launches()
        del engine
        t0 = time.perf_counter()
        out = run_on_client_mesh(lm_client_rank, world, device="cuda:0")
        launch_s = time.perf_counter() - t0
        res, stats, names = out["res"], out["stats"], out["names"]
        per_rank = [dict(zip(names, map(int, r[4:]))) for r in stats]
        for r, (got, row) in enumerate(zip(per_rank, stats)):
            if got != want:
                fail(f"lm clients {name} rank {r}: launches {got}, "
                     f"expected {want}")
            if row[2] != ex.RUN["rounds"] or row[3] != 1.0:
                fail(f"lm clients {name} rank {r}: {int(row[2])} rounds, "
                     f"not all under the no-sync fence")
        launches[f"lm clients {name}"] = {
            k: sum(p[k] for p in per_rank) for k in names}
        if not _same_run(res, twin):
            fail(f"lm clients {name}: not bit for bit the single-device "
                 f"run with client_chunk {n_loc}")
        if not (np.array_equal(res.omega, plain.omega) and all(
                np.array_equal(a, b) for a, b in zip(
                    res.graph_history, plain.graph_history))
                and res.comm_downloads == plain.comm_downloads):
            fail(f"lm clients {name}: Omega, graphs or downloads differ "
                 f"from the plain single-device card run's")
        print(f"lm clients {name}: the LM example (reduced qwen3, "
              f"{ex.CLIENTS} clients, {n_loc} a rank) on {world} ranks, "
              f"the launch incl. spawn and CUDA init {launch_s:.3f} s; "
              f"per rank: wall (s) {np.round(stats[:, 0], 3).tolist()}, "
              f"peak allocated {stats[:, 1].astype(int).tolist()}, "
              f"launches {_nonzero(per_rank[0])} as the single-device "
              f"run's, every round under the no-sync fence; collectives "
              f"of rank 0 (calls, bytes sent) {out['collectives']}; bit "
              f"for bit the single-device run with client_chunk {n_loc}; "
              f"Omega, graphs and downloads the plain card run's; test "
              f"acc {res.test_acc.tolist()}; {SMI}")
    return launches


# ---------------------------------------------------------- the dry run

#: the dry run's predicted peak (`roofline.count_step` on "meta" tensors)
#: against the card's: each anchor's measured peak within this share
DRYRUN_PEAK_TOL = 0.10
#: the anchors' train steps (fp32, remat "full", the loss over 4 chunks
#: as `launch.train.main` builds it; whisper-medium whole after 1,500
#: frames, TRAIN_AUDIO's step: a model of modules, where a counter's
#: module hooks would hold its activations) and serve run
DRYRUN_TRAINS = {"qwen3-0.6b": dict(batch=8, seq=512),
                 "mamba2-370m": dict(batch=8, seq=512),
                 "whisper-medium": dict(batch=8, seq=448),
                 "qwen3-0.6b bf16": dict(arch="qwen3-0.6b", batch=8,
                                         seq=512, dtype="bfloat16")}
#: the bf16 train step's anchor is held closer: within this share
DRYRUN_BF16_PEAK_TOL = 0.01
DRYRUN_SERVE = dict(arch="qwen3-0.6b", batch=4, prompt_len=512,
                    new_tokens=8)


def meta_twin(torch, t):
    """A "meta" tensor of ``t``'s shape, strides and dtype (anything
    else, as it is)."""
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                               device="meta")


def _card_alloc(torch, fn):
    """(the rise of max_memory_allocated over ``fn()``, the rise of the
    allocator's peak requested bytes): what its launches allocate."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    req = torch.cuda.memory_stats()["requested_bytes.all.peak"] - requested
    del out
    return rise, req


def _meta_alloc(fn, sms):
    """(``fn()``'s peak on "meta" tensors in 512-byte blocks, and in bytes
    as requested)."""
    from repro_torch.kernels import meta as kmeta
    from repro_torch.roofline.analysis import PeakTracker

    with kmeta.target(sms), PeakTracker(512) as blocks, \
            PeakTracker(1) as exact:
        fn()
    return blocks.peak, exact.peak


def kernel_alloc_cases(torch, k1_in, k2_in, k3_in, k4_in, k4b_in, k5_in,
                       k6_in, k5b_in, k6b_in, k4b16_in):
    """(name, card call, meta call) of each kernel and backward at its
    first timed shape (PERF.md §6), the meta call on `meta_twin`s."""
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import rglru_scan as k6
    from repro_torch.kernels import sparse_graph_mix as k2
    from repro_torch.kernels import ssd as k5

    def twin(*ts):
        return [meta_twin(torch, t) for t in ts]

    def pair(name, fn, *args, **kw):
        return (name, functools.partial(fn, *args, **kw),
                functools.partial(fn, *twin(*args),
                                  **dict(zip(kw, twin(*kw.values())))))
    cases = []
    M, N, P, dt, A, W = k1_in[0]
    cases.append(pair("graph_mix", k1.graph_mix, A, W))
    name, dt, sw, nw, idx, W, Wp = next(c for c in k2_in
                                        if c[0].startswith("main"))
    meta_k2 = twin(sw, nw, idx, W)
    meta_k2.append(meta_k2[-1] if Wp is W else meta_twin(torch, Wp))
    cases.append(("sparse_graph_mix",
                  functools.partial(k2.sparse_graph_mix, sw, nw, idx, W, Wp),
                  functools.partial(k2.sparse_graph_mix, *meta_k2)))
    name, A, vals, idx, P = next(c for c in k3_in if c[0] == "main")
    meta_k3 = twin(A, vals, idx)
    cases.append(("compressed_graph_mix",
                  functools.partial(k3.compressed_graph_mix, A, vals, idx,
                                    P),
                  functools.partial(k3.compressed_graph_mix, *meta_k3, P)))
    name, dt, causal, window, q, k, v = next(
        c for c in k4_in if "serve" in c[0] and c[1] == "float32")
    cases.append(pair("flash_attention", k4.flash_attention, q, k, v,
                      causal=causal, window=window))
    name, causal, window, q, k, v, dout = next(
        c for c in k4b_in if c[0] in K4_BWD_TIMED)
    out, lse = k4.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    cases.append(pair("flash_attention_bwd", k4.flash_attention_bwd, q, k,
                      v, out, lse, dout, causal=causal, window=window))
    name, causal, window, q, k, v, dout = k4b16_in[0]
    out, lse = k4.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    cases.append(pair("flash_attention_bwd_bf16", k4.flash_attention_bwd, q,
                      k, v, out, lse, dout, causal=causal, window=window))
    name, chunk, x, dlogA, B, C, h0 = next(c for c in k5_in
                                           if c[0] in K5_TIMED)
    cases.append(pair("ssd", k5.ssd, x, dlogA, B, C, chunk=chunk, h0=h0))
    name, a, b, h0 = next(c for c in k6_in if c[0] == "serve")
    cases.append(pair("rglru_scan", k6.rglru_scan, a, b, h0))
    name, chunk, x, dlogA, B, C, h0, dy, dhl = next(
        c for c in k5b_in if c[0] in K5_BWD_TIMED)
    _, _, cum, states = k5.ssd_with_work(x, dlogA, B, C, chunk=chunk, h0=h0)
    cases.append(pair("ssd_bwd", k5.ssd_bwd, x, dlogA, B, C, chunk, h0, dy,
                      dhl, cum, states))
    name, a, b, h0, dy, dhl = next(c for c in k6b_in
                                   if c[0] in K6_BWD_TIMED)
    h, _ = k6.rglru_scan(a, b, h0)
    cases.append(pair("rglru_scan_bwd", k6.rglru_scan_bwd, a, h, h0, dy,
                      dhl))
    return cases


def check_kernel_allocs(torch, cases, sms):
    """Each kernel's launch allocates what its meta path allocates (its
    plan for a card of ``sms`` SMs, the hardware table's): the bytes the
    launch asks the caching allocator for (its peak requested bytes)
    equal the meta path's exactly, and its max_memory_allocated rise is
    at least the meta path's in 512-byte blocks (the allocator hands a
    large request a larger block where a segment's rest is too small to
    split, so the rise is not the request rounded). Returns {name:
    (requested, card rise, meta blocks)}."""
    out = {}
    for name, card, meta in cases:
        rise, req = _card_alloc(torch, card)
        blocks, exact = _meta_alloc(meta, sms)
        print(f"  {name}: the launch asks for {req} bytes (max_memory_"
              f"allocated rise {rise}), the meta path {exact} ({blocks} in "
              f"512-byte blocks)")
        if req != exact or rise < blocks:
            fail(f"dry run: {name}'s launch allocates {req} bytes (rise "
                 f"{rise}), its meta path {exact} ({blocks} in blocks)")
        out[name] = (req, rise, blocks)
    return out


def _peak_gap(torch, label, card_fn, meta_fn, hw, tol=DRYRUN_PEAK_TOL):
    """``card_fn()``'s measured peak (max_memory_allocated after a reset,
    less what was allocated before it) against the dry run's prediction
    of ``meta_fn`` on "meta" tensors (`roofline.count_step`'s peak, the
    instrument behind the dry run's records); fails beyond
    ``tol`` (DRYRUN_PEAK_TOL). Returns (predicted, measured, gap)."""
    from repro_torch.roofline import count_step

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    card_fn()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - before
    predicted = count_step(meta_fn, hw=hw).peak_bytes
    gap = (predicted - measured) / measured
    print(f"  {label}: predicted peak {predicted} bytes, measured "
          f"{measured} (gap {gap:+.4f}, tolerance {tol}); {SMI}")
    if abs(gap) > tol:
        fail(f"dry run: {label}'s predicted peak {predicted} is {gap:+.4f} "
             f"off the measured {measured}")
    return predicted, measured, gap


def _lm_pair(torch, arch, dtype="float32"):
    """(a card model with seeded weights, its "meta" twin): the whole
    ``arch`` at ``dtype``, the loss over 4 chunks (`launch.train.main`'s)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(dtype=dtype)
    model = build_model(cfg, device="meta", loss_chunks=4).to_empty(
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return cfg, model, build_model(cfg, device="meta", loss_chunks=4)


def run_dryrun(torch, engine, kernel_cases, records):
    """The dry-run phase: each kernel's meta allocation against its
    launch's; the predicted peak of one dense round (N 32), the
    qwen3-0.6b, mamba2-370m and whisper-medium train steps, qwen3-0.6b's
    bf16 train step (within DRYRUN_BF16_PEAK_TOL) and
    qwen3-0.6b's serve against the card's; the `ShapeMesh` records of the sharded phase's audited rounds
    against the real ones, rank by rank. Returns the anchors' (predicted,
    measured, gap) by label."""
    import dataclasses

    from repro_torch.core.dpfl import (abstract_round_state,
                                       dpfl_initial_state, dpfl_round_step)
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import AXES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.classifier import PaperCNN
    from repro_torch.optim import adamw
    from repro_torch.roofline import CARDS, HW
    from repro_torch.sharding import collectives as coll

    hw = HW(next(k for k in CARDS if k in torch.cuda.get_device_name(0)))
    print("dry run: each kernel's launch against its meta path:")
    check_kernel_allocs(torch, kernel_cases, hw.card.sms)
    gaps = {}
    print(f"dry run: predicted peaks against the card's (modelled on "
          f"'meta' tensors; measured: max_memory_allocated less what was "
          f"allocated before the run):")
    data = make_federated_classification(**SMOKE_DATA)
    cfg = smoke_config("dense", **SMOKE_RUN)
    state, _ = dpfl_initial_state(engine, cfg)
    step = dpfl_round_step(engine, cfg)
    meta_engine = FLEngine(engine.model, data, lr=SMOKE_LR,
                           batch_size=SMOKE_BATCH, device="meta")
    meta_state = abstract_round_state(meta_engine, cfg)
    meta_step = dpfl_round_step(meta_engine, cfg)
    gaps["dense round N 32"] = _peak_gap(
        torch, f"one dense round (PaperCNN, N {SMOKE_DATA['n_clients']})",
        lambda: step(state), lambda: meta_step(meta_state), hw)
    del state, step
    for label, run in DRYRUN_TRAINS.items():
        arch = run.get("arch", label)
        cfg_lm, model, twin = _lm_pair(torch, arch,
                                       run.get("dtype", "float32"))
        opt = adamw(3e-4)
        st = opt.init(dict(model.named_parameters()))
        train = make_train_step(model, opt)
        gen = torch.Generator(device="cuda").manual_seed(8)
        batch = {"tokens": torch.randint(
            0, cfg_lm.vocab_size, (run["batch"], run["seq"] + 1),
            generator=gen, device="cuda")}
        if cfg_lm.family == "audio":
            batch["frames"] = make_frames(torch, cfg_lm, run["batch"])
        st, _ = train(st, batch)      # the cuBLAS workspaces, warm
        meta_st = opt.init(dict(twin.named_parameters()))
        meta_train = make_train_step(twin, opt)
        meta_batch = {k: meta_twin(torch, v) for k, v in batch.items()}
        gaps[f"train {label}"] = _peak_gap(
            torch, f"{arch} {cfg_lm.dtype} train step (B {run['batch']}, S "
                   f"{run['seq']})",
            lambda: train(st, batch), lambda: meta_train(meta_st,
                                                         meta_batch), hw,
            DRYRUN_BF16_PEAK_TOL if cfg_lm.dtype == "bfloat16"
            else DRYRUN_PEAK_TOL)
        del model, twin, st, train, batch
        gc.collect()
        torch.cuda.empty_cache()
    r = DRYRUN_SERVE
    cfg_lm, model, twin = _lm_pair(torch, r["arch"])
    gen = torch.Generator(device="cuda").manual_seed(9)
    prompts = torch.randint(0, cfg_lm.vocab_size,
                            (r["batch"], r["prompt_len"]), generator=gen,
                            device="cuda")
    serve.generate(model, None, prompts, r["new_tokens"])
    meta_prompts = meta_twin(torch, prompts)
    gaps[f"serve {r['arch']}"] = _peak_gap(
        torch, f"{r['arch']} serve (B {r['batch']}, prompt "
               f"{r['prompt_len']}, {r['new_tokens']} new)",
        lambda: serve.generate(model, None, prompts, r["new_tokens"]),
        lambda: serve.generate(twin, None, meta_prompts, r["new_tokens"]),
        hw)
    del model, twin
    gc.collect()
    torch.cuda.empty_cache()
    n = 0
    for mesh_name, (pods, per_pod) in SHARD_MESHES.items():
        world = pods * per_pod
        for rank in range(world):
            eng = meta_engine.shard_clients(
                coll.ShapeMesh((pods, per_pod), AXES, rank))
            # the random-graph runs on every rank, the greedy ones (about
            # 1 s a meta round) on rank 0: the CPU tests hold every
            # rank's greedy records against the gloo meshes'
            # (tests/test_torch_dryrun.py)
            for run in (SHARD_RUNS if rank == 0 else
                        [r for r in SHARD_RUNS if r.endswith("-random")]):
                cfg = shard_config(run)
                st = abstract_round_state(eng, cfg)
                with coll.recording() as recs:
                    dpfl_round_step(eng, cfg)(st)
                want = [dataclasses.astuple(c)
                        for c in records[(mesh_name, run)][rank]]
                got = [dataclasses.astuple(c) for c in recs]
                if got != want:
                    fail(f"dry run: sharded {mesh_name} {run} rank {rank}: "
                         f"the ShapeMesh round's records {got} differ from "
                         f"the card's {want}")
                n += len(got)
    print(f"dry run: the ShapeMesh rounds' {n} CallRecords equal the "
          f"sharded phase's audited rounds', op by op (op, shape, dtype, "
          f"bytes, group size, site, region), on {list(SHARD_MESHES)}: "
          f"every rank for {[r for r in SHARD_RUNS if r.endswith('-random')]}"
          f", rank 0 for the others")
    return gaps


def _kernel_row(name, source, replaces, launches, rows):
    main = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "float32"),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows}


def stamp(started, done):
    """Print the seconds since ``started`` as ``done`` ends (the phases'
    share of the script's time)."""
    print(f"[{time.perf_counter() - started:.1f} s] done: {done}")


def main():
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "examples"))
    # the plain versions and the yardstick matmul run in IEEE fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    global SMI
    SMI = smi
    device_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {device_name}  count {torch.cuda.device_count()}")
    rates = card_rates(device_name)

    # ---- 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    report_build(built)

    # ---- 3. each kernel against its plain version
    k1_in = k1_inputs(torch)
    k1_errs, k1_widths = check_k1(torch, k1_in)
    print(f"K1 agrees with its plain version at {len(k1_in)} shapes, the "
          f"same bits on a repeated call (max abs err {max(k1_errs):.3g}); "
          f"vector widths (dtype, columns): P " + ", ".join(
              f"{k}: {v}" for k, v in sorted(k1_widths.items())))
    k2_in = k2_inputs(torch)
    k2_errs = check_k2(torch, k2_in)
    print(f"K2 agrees with its plain version in {len(k2_in)} cases, the "
          f"same bits on a repeated call (max abs err {max(k2_errs):.3g})")
    k3_in = k3_inputs(torch)
    k3_errs = check_k3(torch, k3_in)
    print(f"K3 agrees with its plain version in {len(k3_in) + 1} cases, the "
          f"same bits on a repeated call, its bucketing pass exactly its "
          f"plain version's (max abs err {max(k3_errs):.3g})")
    k4_in = k4_inputs(torch)
    k4_errs, k4_fp32 = check_k4(torch, k4_in)
    k4_max = {dt: max(e for e, c in zip(k4_errs, K4_CASES) if c[-1] == dt)
              for dt in K4_TOL}
    print(f"K4 agrees with its plain version in {len(k4_in)} cases, the "
          f"same bits on a repeated call (max abs "
          f"err {k4_max['float32']:.3g} fp32, {k4_max['bfloat16']:.3g} bf16)")
    for case, err, tight in zip(K4_CASES, k4_errs, k4_fp32):
        print(f"  K4 {case[0]} {case[-1]}: max abs err {err:.3g}" + (
            "" if tight is None else f"; against fp32 {tight[0]:.3g}, "
            f"{tight[1]:.3f} of its limit"))
    print(f"K4 bf16 against the fp32 plain version: within atol "
          f"{K4_BF16_FP32_TOL[0]} rtol {K4_BF16_FP32_TOL[1]} in every case, "
          f"at most {max(t[1] for t in k4_fp32 if t):.3f} of the limit")
    k4b_in = k4_bwd_inputs(torch)
    k4b_errs = check_k4_bwd(torch, k4b_in)
    print(f"K4 backward agrees with its plain version in {len(k4b_in)} "
          f"cases (dq, dk, dv within {K4_BWD_TOL} of each one's largest "
          f"element), the same bits on a repeated call; the forward with "
          f"its LSE gives the same out bits as without, its LSE within "
          f"{K4_LSE_TOL} of torch.logsumexp of the plain scores")
    for case, (err, share, lse_err, splits, slabs) in zip(K4_BWD_CASES,
                                                          k4b_errs):
        print(f"  K4 backward {case[0]}: max abs err {err:.3g} "
              f"({share:.3g} of the largest element); LSE max abs err "
              f"{lse_err:.3g}; {splits} head splits, {slabs} slabs")
    k4b16_in = k4_bwd_bf16_inputs(torch)
    k4b16_errs = check_k4_bwd_bf16(torch, k4b16_in)
    print(f"K4 bf16 backward agrees with its plain version in bf16 in "
          f"{len(k4b16_in)} cases (dq, dk, dv within {K4_BWD_BF16_TOL} of "
          f"each one's largest element), one launch of the bf16 library a "
          f"call, the same bits on a repeated call and through autograd")
    for case, (err, share, shares) in zip(K4_BWD_BF16_CASES, k4b16_errs):
        print(f"  K4 bf16 backward {case[0]}: max abs err {err:.3g} "
              f"({share:.3g} of the largest element; " + ", ".join(
                  f"{label} {x:.3g}" for label, x in shares.items()) + ")")
    for (name, N, B, S, Hq, Hkv, hd), (err, share) in zip(
            K4_VMAP_CASES, check_k4_vmap(torch)):
        print(f"K4 under torch.func.vmap, {name} ({N} clients x ({B}, {S}, "
              f"{Hq}, {Hkv}, {hd}) fp32): one forward launch and one backward "
              f"call on the folded batch, bit for bit the per-client "
              f"launches; against the plain version max abs err {err:.3g}, "
              f"gradients within {share:.3g} of their largest element (tol "
              f"{TOL['float32']})")
    k5_in = k5_inputs(torch)
    k5_errs = check_k5(torch, k5_in)
    print(f"K5 agrees with its plain version in {len(k5_in)} cases (max abs "
          f"err {max(k5_errs):.3g}, atol {K5_TOL['atol']} rtol "
          f"{K5_TOL['rtol']})")
    for case, err in zip(K5_CASES, k5_errs):
        print(f"  K5 {case[0]}: max abs err {err:.3g}")
    k6_in = k6_inputs(torch)
    k6_errs, k6_bitwise = check_k6(torch, k6_in)
    print(f"K6 agrees with its plain version in {len(k6_in)} cases (max abs "
          f"err {max(k6_errs):.3g}, atol {K6_TOL}; bit for bit in "
          f"{k6_bitwise} of them)")
    for case, err in zip(K6_CASES, k6_errs):
        print(f"  K6 {case[0]}: max abs err {err:.3g}")
    k5b_in = k5_bwd_inputs(torch)
    k5b_errs = check_k5_bwd(torch, k5b_in)
    print(f"K5 backward agrees with its plain version in {len(k5b_in)} "
          f"cases (dx, d dlogA, dB, dC, dh0 within {K5_BWD_TOL} of each "
          f"one's largest element), the same bits on a repeated call")
    for case, (err, share) in zip(K5_BWD_CASES, k5b_errs):
        print(f"  K5 backward {case[0]}: max abs err {err:.3g} ({share:.3g} "
              f"of the largest element)")
    k6b_in = k6_bwd_inputs(torch)
    k6b_errs = check_k6_bwd(torch, k6b_in)
    print(f"K6 backward agrees with its plain version bit for bit in "
          f"{len(k6b_in)} cases (" + ", ".join(c[0] for c in K6_BWD_CASES) +
          ")")
    k7_in = k7_inputs(torch)
    k7_errs = check_k7(torch, k7_in)
    print(f"K7 agrees with its plain version in float64 in {len(k7_in)} "
          f"cases (within {K7_TOL} of the largest feature), the same bits "
          f"on a repeated call and for a model launched alone")
    for (label, _), err in zip(k7_in, k7_errs):
        print(f"  K7 {label}: max abs err {err:.3g} of the largest feature")
    normal_s = check_normal(torch)
    print(f"prng.normal: {NORMAL_DRAWS} draws from PRNGKey(3) on the card in "
          f"{normal_s:.3f} s, the CPU's bits and jax.random.normal's")

    stamp(started, "the kernels' checks")

    # ---- 4. the main paths
    import numpy as np

    from repro_torch.fl.adversary import segregation_history

    engine = make_engine()
    launches = {}
    single = {}
    omega_dense = None
    for variant in VARIANTS:
        res, cfg, counts, seconds, peak = run_main_path(torch, engine,
                                                        variant)
        mean_acc = check_main_path(res, engine, cfg, variant, counts,
                                   omega_dense)
        if omega_dense is None:
            omega_dense = res.omega.astype(bool)
            dense_res = res
        launches[variant] = counts
        if variant in SHARD_RUNS:
            single[variant] = res
        if res.malicious is not None:
            seg = segregation_history(res.graph_history, res.malicious)
            print(f"run_dpfl {variant}: malicious clients "
                  f"{np.flatnonzero(res.malicious).tolist()}; edge rates "
                  f"per round (benign to malicious, benign to benign) " +
                  ", ".join(f"({c:.4f}, {w:.4f})" for c, w in zip(
                      seg["benign_to_malicious"], seg["benign_to_benign"])))
        if res.participation is not None:
            print(f"run_dpfl {variant}: available clients per round "
                  f"{res.participation.sum(axis=1).tolist()}")
        print(f"run_dpfl {variant}: PaperCNN P={engine.n_params} N="
              f"{SMOKE_DATA['n_clients']} rounds={cfg.rounds}: "
              f"{seconds:.3f} s wall incl. preprocessing "
              f"({cfg.rounds / seconds:.4f} rounds/s), peak device memory "
              f"{peak} bytes, launches {counts}, "
              f"comm_downloads {res.comm_downloads}, comm_bytes "
              f"{res.comm_bytes}, mean test acc {mean_acc:.4f} (JAX "
              f"reference {LEARN_REF[variant]}), mean val acc per round "
              f"{[round(float(v.mean()), 4) for v in res.val_acc_history]}")
    t0 = time.perf_counter()
    launches["guards dense (warm)"] = run_guards(torch, engine,
                                                 launches["dense"])
    print(f"guards phase: {time.perf_counter() - t0:.3f} s; {SMI}")
    t0 = time.perf_counter()
    for label, counts in run_donation(torch, engine,
                                      launches["dense"]).items():
        launches[f"donation dense ({label})"] = counts
    flip, launches["label flip"], benign = run_label_flip(torch)
    for dev, (res, (within, cross)) in flip.items():
        print(f"label flip (Fig. 4) on {dev}: {LABEL_FLIP_DATA['n_clients']} "
              f"clients, malicious {np.flatnonzero(~benign).tolist()}, "
              f"{LABEL_FLIP_RUN}: last graph "
              f"{res.graph_history[-1].astype(int).tolist()}; benign-to-"
              f"benign edge rate {within:.4f} above benign-to-malicious "
              f"{cross:.4f}; Omega {res.omega.astype(int).tolist()}; mean "
              f"test acc {float(res.test_acc.mean()):.4f}"
              + (f"; launches {_nonzero(launches['label flip'])}"
                 if dev == "cuda" else ""))
    same = all(np.array_equal(a, b) for a, b in zip(
        flip["cuda"][0].graph_history, flip["cpu"][0].graph_history))
    print(f"label flip: the card's and the CPU's graphs "
          f"{'the same in every round' if same else 'differ'} (not "
          f"required: the greedy's coin flips amplify ulps)")
    del flip
    print(f"donation and label-flip phase: {time.perf_counter() - t0:.3f} "
          f"s; {SMI}")
    nbytes = check_checkpoint(torch, engine, dense_res)
    print(f"checkpoint: the dense run's best models ({engine.n_params} "
          f"parameters x {SMOKE_DATA['n_clients']} clients) through "
          f"CheckpointManager.keep_best ({nbytes} bytes under "
          f"{CKPT_DIR.relative_to(ROOT)}), restore_best bit for bit")
    small = check_small_input(torch)
    print(f"small input: card and CPU select the same graphs (best_flat "
          f"max abs diff {small})")
    for name, (mean_acc, seconds, counts) in run_baselines(
            torch, engine).items():
        launches[f"baseline {name}"] = counts
        print(f"baseline {name}: PaperCNN P={engine.n_params} N="
              f"{SMOKE_DATA['n_clients']} rounds={BASELINE_RUN['rounds']} "
              f"tau={BASELINE_RUN['tau']}: {seconds:.3f} s wall, mean test "
              f"acc {mean_acc:.4f} (JAX reference {LEARN_REF[name]}), "
              f"launches {counts}, every round under the no-sync fence")
    stamp(started, "the DPFL runs, guards and baselines")
    sharded_records = {}
    launches.update(run_sharded(torch, engine, single, sharded_records))
    del single
    B, new = SERVE_RUN["batch"], SERVE_RUN["new_tokens"]
    walls = {}
    for arch in SERVE_ARCHS:
        # one model on the card at a time
        cfg, model, params = serve_model(torch, arch)
        run = f"serve {arch}"
        launches[run], split, gen, again, routing = run_serve(
            torch, cfg, model, params)
        S = SERVE_PROMPT.get(arch, SERVE_RUN["prompt_len"])
        Nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
        T = cfg.n_audio_frames if cfg.family == "audio" else 0
        for label, g in (("first call", gen), ("second call", again)):
            print(f"serve {arch} float32 B={B} S={S}"
                  + (f" + {Nv} vision" if Nv else "")
                  + (f" after {T} frames" if T else "") +
                  f" new={new} ({label}): "
                  f"prefill {g.prefill_seconds * 1e3:.3f} ms wall "
                  f"({B * S / g.prefill_seconds:.1f} prompt tok/s), decode "
                  f"{new - 1} steps {g.decode_seconds * 1e3:.3f} ms wall "
                  f"({g.decode_seconds / (new - 1) * 1e3:.3f} ms/step, "
                  f"{(new - 1) * B / g.decode_seconds:.1f} tok/s)")
        walls[arch] = (again.prefill_seconds * 1e3,
                       again.decode_seconds / (new - 1) * 1e3)
        if arch == "qwen3-0.6b":
            launches[f"serve {arch} window {REPAIR_WINDOW}"] = \
                check_serve_guards(torch, cfg, model, params, gen)
        print(f"serve {arch}: launches {launches[run]}, (prefill, decode) "
              f"{split}, same tokens on a second call"
              + (" (and the same logits bits)" if cfg.family == "moe"
                 else "") + f"; sample "
              f"{gen.tokens[0, :8].tolist()}; max_memory_allocated after "
              f"the serve runs {torch.cuda.max_memory_allocated()} bytes")
        if T:
            # `repro`'s decode recomputes the cross-attention's K and V
            # from the encoder's output at every step: 2 (B T d)(2 H hd)
            # flops a decoder layer
            cross_kv = 2 * B * T * cfg.d_model * 2 * cfg.n_heads * \
                cfg.resolved_head_dim * cfg.n_layers
            step_ms = again.decode_seconds / (new - 1) * 1e3
            print(f"serve {arch}: the cross K/V recompute of a decode step "
                  f"is {cross_kv} flops, {cross_kv / rates[1] * 1e3:.3f} ms "
                  f"at the card's fp32 rate against {step_ms:.3f} ms a "
                  f"step; the encoder's output and the rings stay on the "
                  f"card between steps")
        if routing is not None:
            print(f"serve {arch} routing: smallest gap between the "
                  f"{cfg.topk}th and {cfg.topk + 1}th router probability "
                  f"{routing['gap']:.3g}; copies dropped by the capacity "
                  + ", ".join(f"{ph} {d} of {n} ({d / n:.4f})" for ph, (d, n)
                              in ((k, routing[k]) for k in
                                  ("prefill", "decode"))) +
                  " over its layers; decode under the no-sync fence")
        diff, cpu_s, layers, routing, cross_S = check_cross(torch, cfg, model,
                                                            params)
        print(f"card against CPU ({arch}, {layers} of {cfg.n_layers} "
              + ("encoder and decoder " if T else "") +
              f"layers, B={CROSS_RUN['batch']} S={cross_S} "
              f"new={CROSS_RUN['new_tokens']}): same tokens, prefill logits "
              f"max abs diff {diff:.3g} (tol {CROSS_TOL}), CPU side "
              f"{cpu_s:.1f} s" + ("" if routing is None else
                                  f"; smallest router gap on the card "
                                  f"{routing['gap']:.3g}"))
        del model, params, gen, again
        torch.cuda.empty_cache()
    print("serve walls, second call (prefill ms, decode ms/step): " +
          ", ".join(f"{a} {p:.3f}, {d:.3f}" for a, (p, d) in walls.items()))
    stamp(started, "the sharded phase and the serve runs")
    trains = {}
    for kw in (dict(argv=TRAIN_ARGV), dict(cut=TRAIN_BF16),
               dict(argv=TRAIN_SSM_ARGV), dict(cut=TRAIN_HYBRID),
               dict(cut=TRAIN_VLM), dict(cut=TRAIN_MOE),
               dict(cut=TRAIN_AUDIO)):
        tr = run_train(torch, **kw)
        label = tr["arch"] + (" bf16" if tr["dtype"] == "bfloat16" else "")
        launches[f"train {label}"] = tr["launches"]
        trains[label] = {k: tr[k] for k in ("warm_step_s", "optimizer_s",
                                            "optimizer_share", "peak_bytes")}
        print_train(tr)
        if tr["dtype"] == "bfloat16":
            f32 = trains[tr["arch"]]
            n_bf16 = tr["launches"]["flash_attention_bwd_bf16"]
            print(f"train {tr['arch']} bf16 beside float32 (B "
                  f"{tr['batch']}, S {tr['seq']}, {tr['n_layers']} layers, "
                  f"remat full): warm step {tr['warm_step_s']:.4f} s against "
                  f"{f32['warm_step_s']:.4f} s; AdamW alone "
                  f"{tr['optimizer_s']:.4f} s ({tr['optimizer_share']:.3f} "
                  f"of a step) against {f32['optimizer_s']:.4f} s "
                  f"({f32['optimizer_share']:.3f}); peak allocated "
                  f"{tr['peak_bytes']} against {f32['peak_bytes']} bytes; "
                  f"K4's bf16 backward launched {n_bf16} times "
                  f"({n_bf16 // tr['steps']} a step); {SMI}")
        # the first model trained under activation recompute stays in a
        # reference cycle (frames of torch.utils.checkpoint's first call)
        # until the collector runs: free its weights before the next run
        gc.collect()
        torch.cuda.empty_cache()
    stamp(started, "the train runs")
    for name in CROSS_TRAINS:
        (card_losses, cpu_losses, grad_share, n_cross, params,
         cpu_s) = check_cross_train(torch, name)
        launches[f"{name} (card)"] = n_cross
        loss_tol, grad_tol = CROSS_TRAIN_LOSS_TOL, CROSS_TRAIN_GRAD_TOL
        if CROSS_TRAINS[name].get("dtype") == "bfloat16":
            loss_tol = CROSS_TRAIN_BF16_LOSS_TOL
            grad_tol = CROSS_TRAIN_BF16_GRAD_TOL
        print(f"{name} card against CPU and JAX ({CROSS_TRAINS[name]}): "
              f"losses card {card_losses}, CPU {cpu_losses}, JAX "
              f"{CROSS_TRAIN_JAX_LOSSES[name]} (tol {loss_tol}); "
              f"step-0 gradients within {grad_share:.3g} of each leaf's "
              f"largest element (tol {grad_tol}); launches "
              f"{n_cross}; CPU side {cpu_s:.1f} s")
        if name == "train-cross":
            cross_params = params
        del params
        torch.cuda.empty_cache()
    n_mix, mix_err, mix_s = check_dpfl_mix(torch, cross_params)
    launches["dpfl mix"] = n_mix
    print(f"DPFL mix: make_dpfl_mix of {DPFL_MIX_CLIENTS} client copies of "
          f"that model ({len(cross_params)} leaves) in {mix_s * 1e3:.3f} ms, "
          f"K1 launches {n_mix['graph_mix']} (one a leaf), max abs err "
          f"{mix_err:.3g} against K1's plain version")
    del cross_params
    gc.collect()
    torch.cuda.empty_cache()
    stamp(started, "the cut runs and the DPFL mix")
    card, cpu = check_lm_dpfl_cross(torch)
    launches["lm-dpfl (card)"] = card["launches"]
    print(f"lm-dpfl card against CPU (the example: reduced qwen3, "
          f"{len(card['cluster_of'])} clients, {card['run']}): the same "
          f"Omega and graphs; smallest greedy |u - a/(a+b)| card "
          f"{card['margin']:.3g}, CPU {cpu['margin']:.3g}; the same test "
          f"acc {card['res'].test_acc.tolist()} and val acc history; best "
          f"models' val losses {card['val_loss_err']:.3g} apart (tol "
          f"{CROSS_TRAIN_LOSS_TOL}); launches {card['launches']}; "
          f"card {card['seconds']:.3f} s, CPU {cpu['seconds']:.3f} s")
    lm_card = {k: card[k] for k in ("res", "want")}
    del card, cpu
    full = check_lm_dpfl_full(torch)
    launches["lm-dpfl full width"] = full["launches"]
    same, cross = full["split"]
    print(f"lm-dpfl {LM_DPFL_FULL}: P={full['engine'].n_params} per client, "
          f"{full['run']}: {full['seconds']:.3f} s wall incl. init and "
          f"preprocessing, peak allocated {full['peak']} bytes, launches "
          f"{full['launches']}; mean step losses "
          f"{[round(x, 4) for x in full['losses'].mean(1).tolist()]}; "
          f"Omega {full['res'].omega.astype(int).tolist()}; graph edges "
          f"within corpus-cluster {same:.2f} vs across {cross:.2f}; next-"
          f"token test acc {full['res'].test_acc.tolist()}; smallest greedy "
          f"|u - a/(a+b)| {full['margin']:.3g}; every round under the "
          f"no-sync fence; device spans (ms, CUDA events): " + ", ".join(
              f"{k} {v:.3f}" for k, v in full["span_ms"].items()))
    for i, (label, run) in enumerate(check_lm_dpfl_turns(torch, full)):
        if i:
            launches[f"lm-dpfl full width ({label} {i})"] = run["launches"]
        print(f"lm-dpfl {LM_DPFL_FULL} run {i}, round step {label}: "
              f"{run['seconds']:.3f} s wall; allocated at its start "
              f"{run['base']} bytes, peak {run['peak']} ("
              f"{run['peak'] - run['base']} above its start; "
              f"{LM_DPFL_FULL_PLAIN_PEAK_GB} GB kept in PERF.md from before "
              f"the round steps donated); peaks before the first round, in "
              f"rounds 0-{len(run['segments']) - 3} and in the last round "
              f"with the results {run['segments']}; Omega, graphs and test "
              f"acc run 0's; {SMI}")
    del full, run
    torch.cuda.empty_cache()
    pers = run_personalized(torch)
    launches["serve personalized"] = pers["launches"]
    R = pers["first"].tokens.shape[0]
    n_new = PERSONALIZED_RUN["new_tokens"]
    for label, g in (("first call", pers["first"]),
                     ("second call", pers["again"])):
        print(f"serve personalized {PERSONALIZED_RUN['arch']} float32 "
              f"({pers['n_weights']} weights x 3 clients, drawn in "
              f"{pers['init_s']:.2f} s) R={R} S="
              f"{PERSONALIZED_RUN['prompt_len']} new={n_new} ({label}): "
              f"the requests' weights gathered in "
              f"{g.gather_seconds * 1e3:.3f} ms, prefill "
              f"{g.prefill_seconds * 1e3:.3f} ms wall, decode {n_new - 1} "
              f"steps {g.decode_seconds * 1e3:.3f} ms wall "
              f"({g.decode_seconds / (n_new - 1) * 1e3:.3f} ms/step)")
    print(f"serve personalized: launches {pers['launches']} (all in the "
          f"prefill), the same tokens on a second call, each request's "
          f"tokens those of generate on its client's weights alone, "
          f"requests 0 and 2 apart; sample "
          f"{pers['first'].tokens[:, :6].tolist()}; peak allocated "
          f"{pers['peak']} bytes")
    del pers
    torch.cuda.empty_cache()
    stamp(started, "the LM examples")
    t0 = time.perf_counter()
    launches.update(run_model_mesh(torch))
    launches.update(run_lm_client_mesh(torch, lm_card))
    print(f"model-mesh phase and LM clients on the client mesh: "
          f"{time.perf_counter() - t0:.3f} s; {SMI}")
    t0 = time.perf_counter()
    run_dryrun(torch, engine, kernel_alloc_cases(
        torch, k1_in, k2_in, k3_in, k4_in, k4b_in, k5_in, k6_in, k5b_in,
        k6b_in, k4b16_in), sharded_records)
    del sharded_records
    print(f"dry-run phase: {time.perf_counter() - t0:.3f} s; {SMI}")

    stamp(started, "the model mesh and the dry run")
    # ---- 5. the kernels timed, after the main path has brought the
    # card's clocks up from idle
    k1_rows = time_k1(torch, k1_in, k1_errs, rates)
    k2_rows = time_k2(torch, k2_in, k2_errs, rates)
    k3_rows = time_k3(torch, k3_in, k3_errs, rates)
    k4_rows = time_k4(torch, k4_in, k4_errs, rates)
    k4b_rows = time_k4_bwd(torch, k4b_in, k4b_errs, rates)
    k4b16_rows = time_k4_bwd_bf16(torch, k4b16_in, k4b16_errs, rates)
    del k4b16_in
    k5_rows = time_k5(torch, k5_in, k5_errs, rates)
    k6_rows = time_k6(torch, k6_in, k6_errs, rates)
    k5b_rows = time_k5_bwd(torch, k5b_in, k5b_errs, rates)
    k6b_rows = time_k6_bwd(torch, k6b_in, k6b_errs, rates)
    del k5b_in, k6b_in
    k7_rows = time_k7(torch, k7_in, k7_errs, rates)
    del k7_in
    print("clocks.sm, power.draw after timing: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())

    # ---- 6. results: launches summed over the main-path runs (the eight
    # DPFL runs, the guards, donation and label-flip runs, the twelve
    # baseline runs, the sharded runs summed over their ranks, the serve
    # runs, the train runs, the card sides of the cross train runs, the
    # DPFL mix, the three lm-dpfl runs on the card and the personalized
    # serve), with each run's counts beside them
    def total(kname):
        return sum(c.get(kname, 0) for c in launches.values())

    rows = [
        _kernel_row("graph_mix", "src/repro_torch/kernels/csrc/graph_mix.cu",
                    "src/repro/kernels/graph_mix.py:35",
                    total("graph_mix"), k1_rows),
        _kernel_row("sparse_graph_mix",
                    "src/repro_torch/kernels/csrc/sparse_graph_mix.cu",
                    "src/repro/kernels/sparse_graph_mix.py:71",
                    total("sparse_graph_mix"), k2_rows),
        _kernel_row("compressed_graph_mix",
                    "src/repro_torch/kernels/csrc/compressed_graph_mix.cu",
                    "src/repro/kernels/compressed_graph_mix.py:66",
                    total("compressed_graph_mix"), k3_rows),
        _kernel_row("flash_attention",
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:96",
                    total("flash_attention"), k4_rows),
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:96 (its "
                     "function's gradient; no Pallas counterpart)",
         "launches": total("flash_attention_bwd"),
         "max_abs_err": max(e[0] for e in k4b_errs),
         "ms": k4b_rows[0]["ms"], "plain_ms": k4b_rows[0]["plain_ms"],
         "bound_ms": k4b_rows[0]["bound_ms"],
         "bound_by": k4b_rows[0]["bound_by"],
         "library_ms": k4b_rows[0]["library_ms"], "shapes": k4b_rows},
        {"name": "flash_attention_bwd_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
         "replaces": "src/repro/kernels/flash_attention.py:96 (its "
                     "function's gradient at bf16, repro's cast points; no "
                     "Pallas counterpart)",
         "launches": total("flash_attention_bwd_bf16"),
         "max_abs_err": max(e[0] for e in k4b16_errs),
         "ms": k4b16_rows[0]["ms"], "plain_ms": k4b16_rows[0]["plain_ms"],
         "bound_ms": k4b16_rows[0]["bound_ms"],
         "bound_by": k4b16_rows[0]["bound_by"],
         "library_ms": k4b16_rows[0]["library_ms"], "shapes": k4b16_rows},
        _kernel_row("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
                    "src/repro/kernels/ssd.py:83", total("ssd"), k5_rows),
        _kernel_row("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
                    "src/repro/kernels/rglru_scan.py:60",
                    total("rglru_scan"), k6_rows),
        _kernel_row("ssd_bwd", "src/repro_torch/kernels/csrc/ssd_bwd.cu",
                    "src/repro/kernels/ssd.py:83 (its function's gradient; "
                    "no Pallas counterpart)", total("ssd_bwd"), k5b_rows),
        _kernel_row("rglru_scan_bwd",
                    "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
                    "src/repro/kernels/rglru_scan.py:60 (its function's "
                    "gradient; no Pallas counterpart)",
                    total("rglru_scan_bwd"), k6b_rows),
        _kernel_row("cnn_features",
                    "src/repro_torch/kernels/csrc/cnn_features.cu",
                    "none (repro leaves PaperCNN's convolutions to XLA: "
                    "src/repro/models/classifier.py PaperCNN.features)",
                    total("cnn_features"), k7_rows)]
    # the backwards' errors over every case, not the timed one's alone
    rows[-3]["max_abs_err"] = max(e[0] for e in k5b_errs)
    rows[-2]["max_abs_err"] = max(k6b_errs)
    rows[-1]["max_abs_err"] = max(k7_errs)
    for row in rows:
        row["launches_by_run"] = {v: c.get(row["name"], 0)
                                  for v, c in launches.items()}
    print(f"chip_smoke.py: {time.perf_counter() - started:.1f} s from start "
          f"to the results; {SMI}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
