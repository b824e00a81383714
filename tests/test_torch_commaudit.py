"""The port's wire-bytes audit (`repro_torch.analysis.commaudit`) on the
CPU, mirroring `repro`'s tests/test_commaudit.py with synthetic call
records (`sharding.collectives.CallRecord`, one list a rank) in place of
synthetic HLO: payload classification against the codec catalogue,
refresh, training and rng attribution, the N·bpm·(D-1) wire identity and
the exact cross-multiplied reconciliation. Then the pieces `repro` and
the port share, equal in ints on a grid of (N, D, P, codec), and real
client-mesh runs (gloo ranks on the CPU, as tests/test_torch_sharded.py
runs them): random-graph dense, sparse and top-k rounds on D 2 and 4
reconcile exactly, with `repro`'s expected wire, and the greedy runs
show no unexplained call.

The counterpart of `repro`'s subprocess check: `repro`'s own
`audit_config` on 4 forced host devices (a subprocess, with
tests/test_torch_common.py's jax 0.9 patch) on the same setting gives
the port's wire, but for the neighbor-list rotation on the (2, 2) mesh:
there `repro` chains two single-axis ppermutes at the pod boundary and
moves N x bpm x D, one panel a round more than its own contract, where
the port composes the step into one exchange."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from repro.analysis import commaudit as jaudit  # noqa: E402
from repro.core import DPFLConfig as JConfig  # noqa: E402
from repro.fl.compress import CompressionConfig as JCodec  # noqa: E402
from repro.roofline.hlo import Collective as JCollective  # noqa: E402
from repro_torch.analysis import commaudit  # noqa: E402
from repro_torch.core.dpfl import DPFLConfig  # noqa: E402
from repro_torch.fl.compress import (CompressionConfig,  # noqa: E402
                                     bytes_per_model, topk_k)
from repro_torch.launch.mesh import run_on_client_mesh  # noqa: E402
from repro_torch.sharding.collectives import CallRecord  # noqa: E402

N, D, P = 16, 8, 1000          # S = N/D = 2 rows per rank
BPM = 4 * P                    # lossless fp32
E = N * 4                      # random graph, budget 4
MIX = "repro_torch/kernels/ops.py:graph_mix"
ROT = "repro_torch/kernels/ops.py:rotate"
PROBE = "repro_torch/core/graph.py:_graph_inputs"


def call(op, nbytes, site=MIX, region=None, group=D, dtype="torch.float32"):
    return CallRecord(op, (nbytes // 4,), dtype, nbytes, group, site,
                      region)


PAYLOAD_AG = call("all_gather", 2 * 4 * P)
TRAIN_AG = call("all_gather", 2 * 4 * P,
                site="repro_torch/models/classifier.py:forward")
RNG_AR = call("psum", 4 * 992096, site="repro_torch/prng.py:uniform",
              dtype="torch.int32")
CONTROL = call("psum", 4 * 16, site="repro_torch/core/dpfl.py:aggregate")


def ranks(*calls, devices=D):
    """The same calls on every rank (the SPMD round)."""
    return [list(calls) for _ in range(devices)]


def audit(records, *, compression=None, graph_repr="dense", devices=D,
          claimed=E):
    return commaudit.audit_records(
        records, n_clients=N, n_devices=devices, n_params=P,
        compression=compression, graph_repr=graph_repr,
        claimed_downloads=claimed)


def test_dense_payload_reconciles_exactly():
    rep = audit(ranks(PAYLOAD_AG, CONTROL))
    assert rep.ok, rep.failures
    # all-gather: S*4P operand x (G-1)=7 recv x 8 ranks = N*bpm*(D-1)
    assert rep.wire_model_bytes == N * BPM * (D - 1) == 448000
    assert rep.replication_factor == (N * (D - 1), E)
    commaudit.reconcile(rep, E * BPM)        # must not raise


def test_sparse_rotation_reconciles_exactly():
    steps = [call("ppermute", 2 * 4 * P, site=ROT)] * (D - 1)
    rep = audit(ranks(*steps), graph_repr="sparse")
    assert rep.ok, rep.failures
    # permute: S*4P operand x 8 ranks x (D-1) steps — same total
    assert rep.wire_model_bytes == N * BPM * (D - 1)
    assert [r.mult for r in rep.rows] == [D - 1] * D
    commaudit.reconcile(rep, E * BPM)


def test_rotation_with_a_step_too_many_fails():
    """A rotation that shifts a panel twice in one step (chained
    single-axis shifts at a carry) moves more than N*bpm*(D-1)."""
    steps = [call("ppermute", 2 * 4 * P, site=ROT)] * D
    rep = audit(ranks(*steps), graph_repr="sparse")
    assert not rep.ok
    assert any("part-exchange" in f for f in rep.failures)
    with pytest.raises(AssertionError):
        commaudit.reconcile(rep, E * BPM)


def test_training_and_rng_sites_never_fail():
    rep = audit(ranks(PAYLOAD_AG, TRAIN_AG, RNG_AR))
    assert rep.ok, rep.failures
    cls = sorted({r.classification for r in rep.rows})
    assert cls == ["payload:fp32", "rng", "training"]
    assert rep.wire_model_bytes == N * BPM * (D - 1)
    assert rep.wire_training_bytes > 0


def test_unexplained_model_sized_call_fails():
    # a model-sized all-reduce from exchange code: no catalogue entry
    rogue = call("psum", 4 * P, site="repro_torch/core/dpfl.py:aggregate")
    rep = audit(ranks(PAYLOAD_AG, rogue))
    assert not rep.ok
    assert any("unexplained" in f for f in rep.failures)
    assert any(r.classification == "UNEXPLAINED" for r in rep.rows)
    # a second payload-sized gather counts as a duplicate exchange,
    # caught by the part-exchange count and the wire total
    rep = audit(ranks(PAYLOAD_AG, call("all_gather", 2 * 4 * P,
                                       site="repro_torch/core/dpfl.py:x")))
    assert any("part-exchange" in f for f in rep.failures)
    assert any("wire model bytes" in f for f in rep.failures)


def test_refresh_attributed_not_charged():
    probe = call("all_gather", 2 * 4 * P, site=PROBE, region="refresh")
    rep = audit(ranks(probe, PAYLOAD_AG))
    assert rep.ok, rep.failures
    assert rep.wire_model_bytes == N * BPM * (D - 1)
    assert rep.wire_refresh_bytes == N * BPM * (D - 1)
    assert {r.classification for r in rep.rows} == {"refresh:fp32",
                                                    "payload:fp32"}
    assert all(r.path[1:] == ("refresh",) for r in rep.rows
               if r.classification.startswith("refresh"))


def test_refresh_of_decoded_peers_under_a_codec():
    """Under top-k the refresh probes the decoded peers, an fp32 panel:
    a refresh part; the same panel outside the refresh is unexplained."""
    comp = CompressionConfig(codec="topk", topk_frac=0.1)
    K = topk_k(comp, P)
    parts = [call("all_gather", 2 * 4 * K, dtype=dt)
             for dt in ("torch.float32", "torch.int32")]
    probe = call("all_gather", 2 * 4 * P, site=PROBE, region="refresh")
    rep = audit(ranks(probe, *parts), compression=comp)
    assert rep.ok, rep.failures
    assert "refresh:decoded" in {r.classification for r in rep.rows}
    leak = call("all_gather", 2 * 4 * P, site=PROBE)
    rep = audit(ranks(leak, *parts), compression=comp)
    assert not rep.ok
    assert any(r.classification == "UNEXPLAINED" for r in rep.rows)


def test_topk_ambiguous_parts_count_part_exchanges():
    comp = CompressionConfig(codec="topk", topk_frac=0.1)
    K = topk_k(comp, P)
    part = 2 * 4 * K            # S rows x 4 bytes x K — vals AND idx
    vals = call("all_gather", part,
                site="repro_torch/kernels/ops.py:compressed_graph_mix")
    idx = call("all_gather", part, dtype="torch.int32",
               site="repro_torch/kernels/ops.py:compressed_graph_mix")
    rep = audit(ranks(vals, idx), compression=comp)
    assert rep.ok, rep.failures
    bpm = bytes_per_model(comp, P)
    assert rep.wire_model_bytes == N * bpm * (D - 1)
    assert all(r.classification == "payload:vals|idx" for r in rep.rows)
    commaudit.reconcile(rep, E * bpm)
    # one part alone is half an exchange set
    rep = audit(ranks(vals), compression=comp)
    assert any("part-exchange" in f for f in rep.failures)


def test_single_device_means_zero_wire():
    rep = audit([[]], devices=1)
    assert rep.ok and rep.wire_model_bytes == 0
    commaudit.reconcile(rep, E * BPM)   # wire x E == claimed x N*0 == 0
    with pytest.raises(ValueError, match="ranks' records"):
        audit([[], []], devices=1)


def test_reconcile_rejects_wrong_claim():
    rep = audit(ranks(PAYLOAD_AG))
    with pytest.raises(AssertionError):
        commaudit.reconcile(rep, E * BPM + 1)
    with pytest.raises(ValueError, match="static E"):
        commaudit.reconcile(audit(ranks(PAYLOAD_AG), claimed=None), E * BPM)


def test_static_downloads_random_graph_only():
    cfg = DPFLConfig(rounds=1, budget=4, random_graph=True)
    assert commaudit.static_downloads_per_round(cfg, N) == N * 4
    assert commaudit.static_downloads_per_round(
        DPFLConfig(rounds=1, budget=4), N) is None


def test_payload_catalogue_sums_to_shard_bpm():
    for comp in [None, CompressionConfig(codec="topk", topk_frac=0.1),
                 CompressionConfig(codec="int8", quant_bits=8)]:
        parts = commaudit.payload_catalogue(comp, N, D, P)
        assert sum(b for _, b in parts) == (N // D) * bytes_per_model(
            comp, P)


def test_table_names_every_row():
    rep = audit(ranks(PAYLOAD_AG, TRAIN_AG))
    text = rep.table()
    assert text.count("payload:fp32 @ rank") == D
    assert f"expected N*bpm*(D-1) = {N * BPM * (D - 1)}" in text
    assert "R = N(D-1)/E" in text


# ---- parity with `repro`'s audit ------------------------------------------

CODECS = {"none": None, "topk-0.1": dict(codec="topk", topk_frac=0.1),
          "topk-0.3": dict(codec="topk", topk_frac=0.3),
          "int8": dict(codec="int8", quant_bits=8),
          "identity": dict(codec="identity")}
GRID = [(n, d, p) for n in (8, 32, 64) for d in (1, 2, 4, 8)
        for p in (586, 62006) if n % d == 0]


@pytest.mark.parametrize("codec", list(CODECS))
def test_shared_pieces_equal_repro(codec):
    kw = CODECS[codec]
    comp = None if kw is None else CompressionConfig(**kw)
    jcomp = None if kw is None else JCodec(**kw)
    for n, d, p in GRID:
        assert commaudit.payload_catalogue(comp, n, d, p) == \
            jaudit.payload_catalogue(jcomp, n, d, p)
        for kind, op in (("all-gather", "all_gather"),
                         ("collective-permute", "ppermute"),
                         ("all-reduce", "psum"), ("all-reduce", "pmax")):
            for nbytes in (4, 4 * p, 12345):
                for mult in (1, 3):
                    jc = JCollective(kind, "x", nbytes, mult, (), d, "")
                    c = call(op, nbytes, site="x", group=d)
                    # repro's HLO collective stands for all d devices
                    assert d * commaudit.wire_bytes(c, mult) == \
                        jaudit.wire_bytes(jc, d)
        for budget in (None, 1, 4, n + 3):
            for random_graph in (True, False):
                assert commaudit.static_downloads_per_round(
                    DPFLConfig(budget=budget, random_graph=random_graph),
                    n) == jaudit.static_downloads_per_round(
                        JConfig(budget=budget, random_graph=random_graph),
                        n)
        # reconcile accepts and refuses the same claims
        bpm = bytes_per_model(comp, p)
        e = n * min(4, n - 1)
        for wire in (n * bpm * (d - 1), n * bpm * (d - 1) + 1):
            for claim in (e * bpm, e * bpm + 8):
                got = []
                for mod, rep in (
                        (commaudit, commaudit.AuditReport(
                            n, d, p, "x", "dense", bpm,
                            wire_model_bytes=wire, claimed_downloads=e)),
                        (jaudit, jaudit.AuditReport(
                            n, d, p, "x", "dense", bpm,
                            wire_model_bytes=wire, claimed_downloads=e))):
                    try:
                        mod.reconcile(rep, claim)
                        got.append(True)
                    except AssertionError:
                        got.append(False)
                assert got[0] == got[1], (n, d, p, wire, claim)


# ---- real client-mesh runs ---------------------------------------------

DATA = dict(common.SMALL_DATA, n_clients=8)
BASE = dict(tau_init=1, tau_train=1, budget=3, seed=0, rounds=2)
TOPK = dict(codec="topk", topk_frac=0.3)
RUNS = {"dense-random": dict(BASE, random_graph=True),
        "sparse-random": dict(BASE, random_graph=True, graph_repr="sparse"),
        "topk-random": dict(BASE, random_graph=True, compression=TOPK),
        "dense": dict(BASE),
        "sparse": dict(BASE, graph_repr="sparse"),
        "topk": dict(BASE, compression=TOPK)}
MESHES = {"1x2": (2, 1), "1x4": (4, 1), "2x2": (4, 2)}
_AUDITS = {}


def _port_cfg(kw):
    kw = dict(kw)
    if "compression" in kw:
        kw["compression"] = CompressionConfig(**kw["compression"])
    return kw


def _audits(mesh, tmp_path_factory):
    if mesh not in _AUDITS:
        world, pods = MESHES[mesh]
        store = tmp_path_factory.mktemp(f"audit-{mesh}") / "store"
        _AUDITS[mesh] = run_on_client_mesh(
            workers.audit_runs, world, pods=pods, device="cpu",
            init_file=str(store), timeout=600, args=(
                DATA, common.SMALL_MLP, common.SMALL_ENGINE,
                [(n, _port_cfg(kw)) for n, kw in RUNS.items()]))
    return _AUDITS[mesh]


@pytest.mark.parametrize("run", ["dense-random", "sparse-random",
                                 "topk-random"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_random_graph_rounds_reconcile_exactly(mesh, run,
                                               tmp_path_factory):
    comm_bytes, rep = _audits(mesh, tmp_path_factory)[run]
    world = MESHES[mesh][0]
    assert rep.n_devices == world and rep.exact
    assert rep.ok, rep.table()
    commaudit.reconcile(rep, comm_bytes[0])
    kw = RUNS[run]
    jcomp = JCodec(**kw["compression"]) if "compression" in kw else None
    jrep = jaudit.audit_hlo_text(
        "HloModule m\n\nENTRY %main () -> f32[] {\n"
        "  ROOT %c = f32[] constant(0)\n}\n",
        n_clients=DATA["n_clients"], n_devices=world,
        n_params=rep.n_params, compression=jcomp,
        graph_repr=kw.get("graph_repr", "dense"),
        claimed_downloads=rep.claimed_downloads)
    assert rep.wire_model_bytes == jrep.expected_wire_model_bytes
    assert rep.bytes_per_model == jrep.bytes_per_model
    assert rep.claimed_downloads == jaudit.static_downloads_per_round(
        JConfig(**{k: v for k, v in kw.items() if k != "compression"}),
        DATA["n_clients"])
    # each payload call is the codec's part on this rank's rows
    kinds = {r.kind for r in rep.rows if r.classification.startswith(
        "payload")}
    assert kinds == {"ppermute" if "sparse" in run else "all_gather"}


@pytest.mark.parametrize("run", ["dense", "sparse", "topk"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_greedy_rounds_have_no_unexplained_call(mesh, run,
                                                tmp_path_factory):
    """The greedy's rounds: E is data-dependent (no exact count), every
    call is a payload or the refresh's probe, and the probe is
    attributed, not charged: the mix's wire is still N*bpm*(D-1)."""
    _, rep = _audits(mesh, tmp_path_factory)[run]
    assert not rep.exact and rep.claimed_downloads is None
    assert rep.ok, rep.table()
    assert "UNEXPLAINED" not in {r.classification for r in rep.rows}
    assert rep.wire_refresh_bytes > 0
    assert rep.wire_model_bytes == rep.expected_wire_model_bytes


def test_single_device_round_moves_no_wire():
    """`audit_config` on an engine without a mesh: no collective at all."""
    engine = workers._engine("cpu", DATA, common.SMALL_MLP,
                             common.SMALL_ENGINE, None)
    for kw in (RUNS["dense-random"], RUNS["sparse"]):
        rep = commaudit.audit_config(engine, DPFLConfig(**kw))
        assert rep.n_devices == 1 and rep.rows == [] and rep.ok
    rep = commaudit.audit_config(engine, DPFLConfig(**RUNS["dense-random"]))
    commaudit.reconcile(rep, rep.claimed_downloads * rep.bytes_per_model)


# `repro`'s audit_config of the same random-graph rounds, on forced host
# devices: {"<world>x<pods> <run>": (wire model bytes, failures)}
_REPRO_AUDIT = r"""
import json, sys
from jax.interpreters import batching
if not hasattr(type(batching.primitive_batchers), "__contains__"):
    type(batching.primitive_batchers).__contains__ = (
        lambda self, p: p in batching.fancy_primitive_batchers)
from repro.analysis import commaudit
from repro.core import DPFLConfig
from repro.data import make_federated_classification
from repro.fl.compress import CompressionConfig
from repro.fl.engine import FLEngine
from repro.launch.mesh import make_client_mesh
from repro.models.classifier import MLP
data, mlp, eng, runs, meshes = json.loads(sys.argv[1])
out = {}
for name, (world, pods) in meshes.items():
    engine = FLEngine(MLP(*mlp), make_federated_classification(**data),
                      mesh=make_client_mesh(world, pods=pods), **eng)
    for run, kw in runs.items():
        kw = dict(kw)
        if "compression" in kw:
            kw["compression"] = CompressionConfig(**kw["compression"])
        rep = commaudit.audit_config(engine, DPFLConfig(**kw))
        out[f"{name} {run}"] = (rep.wire_model_bytes, rep.failures)
print(json.dumps(out))
"""


def test_wire_equals_repro_audit_config_subprocess(tmp_path_factory):
    random_runs = {k: v for k, v in RUNS.items() if "random" in k}
    env = dict(os.environ, PYTHONPATH=str(common.ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", _REPRO_AUDIT, json.dumps(
            [DATA, common.SMALL_MLP, common.SMALL_ENGINE, random_runs,
             MESHES])],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    theirs = json.loads(r.stdout.strip().splitlines()[-1])
    for mesh, (world, pods) in MESHES.items():
        for run in random_runs:
            _, rep = _audits(mesh, tmp_path_factory)[run]
            wire, failures = theirs[f"{mesh} {run}"]
            if run == "sparse-random" and pods > 1:
                # a carry step: `repro` shifts twice, the port once
                n_bpm = rep.n_clients * rep.bytes_per_model
                assert wire == n_bpm * world and failures
                assert rep.wire_model_bytes == n_bpm * (world - 1)
            else:
                assert (wire, failures) == (rep.wire_model_bytes, []), \
                    (mesh, run)
