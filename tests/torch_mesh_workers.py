"""Rank functions of the port's client-mesh tests (tests/test_torch_sharded.py
and the ``gpu`` ones in tests/test_torch_cuda.py).

`repro_torch.launch.mesh.run_on_client_mesh` pickles the function it runs
by module and name and each spawned rank imports it, so they live here,
in a module that imports neither jax nor `repro` (a rank would pay for
the import and gain nothing). Each takes ``(mesh, device, ...)``, runs on
its rank's rows and returns whole results, which every rank holds; the
launcher returns rank 0's.
"""
import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.sharding import collectives as coll


def _rows_of(mesh, n_total):
    n_loc = n_total // coll.num_shards(mesh)
    lo = coll.shard_index(mesh) * n_loc
    return slice(lo, lo + n_loc)


def _t(x, device):
    return torch.as_tensor(np.asarray(x)).to(device)


def op_case(N, P, B, K, seed=0):
    """Numpy inputs of the sharded ops: a row-stochastic (N, N) A, an
    (N, P) table W, its top-K payload (vals, idx), (N, B) lists with -1
    slots and their weights, and int8 parts (q, scale) near 1."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, P)).astype(np.float32)
    idx = np.argsort(-np.abs(W), axis=1)[:, :K].astype(np.int32)
    A = rng.random((N, N)).astype(np.float32)
    return dict(A=A / A.sum(axis=1, keepdims=True), W=W,
                vals=np.take_along_axis(W, idx, axis=1), idx=idx, p_dim=P,
                sw=rng.standard_normal(N).astype(np.float32),
                nw=rng.standard_normal((N, B)).astype(np.float32),
                nbr=rng.integers(-1, N, (N, B)).astype(np.int32),
                q=rng.integers(-127, 128, (N, P)).astype(np.int8),
                scale=(rng.random(N) / 127).astype(np.float32))


def _launches():
    from repro_torch.kernels import compressed_graph_mix as k3
    from repro_torch.kernels import graph_mix as k1
    from repro_torch.kernels import sparse_graph_mix as k2

    return [k1.graph_mix.launches, k2.sparse_graph_mix.launches,
            k3.compressed_graph_mix.launches]


def mix_ops(mesh, device, cases):
    """Each case's sharded ops on this rank's rows, gathered whole:
    ``cases`` is a list of `op_case` dicts. Returns, per case, the
    outputs, and the collectives' calls and bytes of each op with every
    rank's K1, K2 and K3 launches (`ops` runs the plain versions on CPU
    tensors, which launch nothing)."""
    out = []
    for c in cases:
        r = _rows_of(mesh, c["W"].shape[0])
        W = _t(c["W"], device)
        coll.reset_counts()
        before = _launches()
        got = {
            "graph_mix": ops.graph_mix(_t(c["A"], device)[r], W[r],
                                       mesh=mesh),
            "compressed_graph_mix": ops.compressed_graph_mix(
                _t(c["A"], device)[r], _t(c["vals"], device)[r],
                _t(c["idx"], device)[r], c["p_dim"], mesh=mesh),
            "sparse_graph_mix": ops.sparse_graph_mix(
                _t(c["sw"], device)[r], _t(c["nw"], device)[r],
                _t(c["nbr"], device)[r], W[r], mesh=mesh),
        }
        gathers = coll.counts["all_gather"][0]
        q, scale = _t(c["q"], device), _t(c["scale"], device)
        got["sparse_graph_mix_int8"] = ops.sparse_graph_mix(
            _t(c["sw"], device)[r], _t(c["nw"], device)[r],
            _t(c["nbr"], device)[r], W[r], peer_parts=(q[r], scale[r]),
            peer_decode=lambda qq, ss: qq.float() * ss[:, None], mesh=mesh)
        got["peer_rows"] = ops.sparse_peer_rows(_t(c["nbr"], device)[r],
                                                W[r], mesh=mesh)
        counts = {k: list(v) for k, v in coll.counts.items()}
        launched = torch.tensor([[a - b for a, b in zip(_launches(),
                                                          before)]])
        out.append(({k: coll.all_gather_rows(v, mesh).cpu().numpy()
                     for k, v in got.items()},
                    dict(counts, gathers_of_dense_ops=gathers,
                         launches=coll.all_gather_rows(
                             launched, mesh).tolist())))
    return out


def _engine(device, data_kw, mlp, eng_kw, mesh, client_chunk=None):
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    engine = FLEngine(MLP(*mlp), make_federated_classification(**data_kw),
                      **eng_kw, device=device)
    engine._client_chunk = client_chunk
    return engine if mesh is None else engine.shard_clients(mesh)


def _carry(engine, init):
    """Start every run from ``init`` (numpy (N, ...) leaves: `repro`'s
    init, carried across): the engine's rows of it."""
    if init is not None:
        engine.init_clients = lambda key: {
            k: torch.tensor(np.array(v[engine.rows])).to(engine.device)
            for k, v in init.items()}


def result_dict(res):
    """The fields of a `DPFLResult` the tests compare, as numpy / ints."""
    return {"test_acc": np.asarray(res.test_acc),
            "best_flat": np.asarray(res.best_flat),
            "omega": np.asarray(res.omega),
            "graph_history": np.asarray(res.graph_history),
            "val_acc_history": np.asarray(res.val_acc_history),
            "comm_downloads": list(res.comm_downloads),
            "comm_preprocess": res.comm_preprocess,
            "comm_bytes": list(res.comm_bytes),
            "comm_bytes_preprocess": res.comm_bytes_preprocess,
            "participation": res.participation,
            "malicious": res.malicious}


def dpfl_runs(mesh, device, data_kw, mlp, eng_kw, init, settings):
    """`run_dpfl` of every (name, DPFLConfig keywords) of ``settings`` on
    the sharded engine; returns {name: `result_dict`} and the
    collectives' calls and bytes of each run."""
    from repro_torch.core.dpfl import DPFLConfig, run_dpfl

    engine = _engine(device, data_kw, mlp, eng_kw, mesh)
    _carry(engine, init)
    out = {}
    for name, kw in settings:
        coll.reset_counts()
        res = run_dpfl(engine, DPFLConfig(**kw))
        out[name] = (result_dict(res),
                     {k: list(v) for k, v in coll.counts.items()})
    return out


def baseline_runs(mesh, device, data_kw, mlp, eng_kw, names, run_kw):
    """The named baselines on the sharded engine: {name: test_acc}."""
    from repro_torch.fl.baselines import BASELINES

    engine = _engine(device, data_kw, mlp, eng_kw, mesh)
    return {n: BASELINES[n](engine, **run_kw)["test_acc"] for n in names}


def shard_refusal(mesh, device, data_kw, mlp, eng_kw):
    """The message of `FLEngine.shard_clients`'s ValueError on data whose
    N does not divide over the mesh (None if it does not raise)."""
    try:
        _engine(device, data_kw, mlp, eng_kw, mesh)
    except ValueError as e:
        return str(e)
    return None


def all_runs(mesh, device, cases, data_kw, mlp, eng_kw, init, settings,
             baselines, baseline_kw, bad_data_kw):
    """What the CPU tests hold of one mesh, in one launch: `mix_ops`,
    `dpfl_runs`, `baseline_runs` and `shard_refusal`."""
    return {"ops": mix_ops(mesh, device, cases),
            "dpfl": dpfl_runs(mesh, device, data_kw, mlp, eng_kw, init,
                              settings),
            "baselines": baseline_runs(mesh, device, data_kw, mlp, eng_kw,
                                       baselines, baseline_kw),
            "refusal": shard_refusal(mesh, device, bad_data_kw, mlp,
                                     eng_kw)}


def fail_on_rank(mesh, device, rank):
    """Raise on rank ``rank`` before any collective."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"deliberate failure on rank {rank}")
    return dist.get_rank()
