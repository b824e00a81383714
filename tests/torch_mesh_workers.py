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


def audit_runs(mesh, device, data_kw, mlp, eng_kw, settings):
    """For each (name, DPFLConfig keywords) of ``settings``: `run_dpfl` on
    the sharded engine (its claimed ``comm_bytes``) and
    `analysis.commaudit.audit_config` of one round. Returns {name:
    (comm_bytes, the report)}; every rank's report must be the same, or
    this raises."""
    import torch.distributed as dist

    from repro_torch.analysis import commaudit
    from repro_torch.core.dpfl import DPFLConfig, run_dpfl

    engine = _engine(device, data_kw, mlp, eng_kw, mesh)
    out = {}
    for name, kw in settings:
        cfg = DPFLConfig(**kw)
        res = run_dpfl(engine, cfg)
        rep = commaudit.audit_config(engine, cfg)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rep)
        if any(r != rep for r in every):
            raise AssertionError(f"{name}: the ranks' reports differ")
        out[name] = (list(res.comm_bytes), rep)
    return out


def fail_on_rank(mesh, device, rank):
    """Raise on rank ``rank`` before any collective."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"deliberate failure on rank {rank}")
    return dist.get_rank()


# ------------------------------------------------------- the model axis


def _gather(x, mesh, axes, dim=0):
    """``x`` whole along ``dim`` over ``axes`` (an all-gather)."""
    return coll.all_gather_rows(x.movedim(dim, 0).contiguous(), mesh,
                                axes).movedim(0, dim)


def _world(x, mesh):
    """Every rank's ``x`` stacked in rank order."""
    return coll.all_gather_rows(x[None].contiguous(), mesh,
                                tuple(mesh.mesh_dim_names))


def kept_copies(topk_idx, n_experts, first_expert=0, n_local=None,
                capacity_factor=1.25):
    """(T, k) bool: the routed copies the port's ``_moe_capacity`` keeps
    over experts [first_expert, first_expert + n_local) (default: all):
    each expert's first ``capacity`` copies in token order."""
    from repro_torch.models import moe

    T, k = topk_idx.shape
    n_local = n_experts if n_local is None else n_local
    order, sorted_le, _, pos = moe._dispatch(topk_idx, first_expert,
                                             n_local)
    keep = (pos < moe.capacity(T, k, n_experts, capacity_factor)) & \
        (sorted_le < n_local)
    return torch.zeros_like(keep).scatter_(0, order, keep).reshape(T, k)


def moe_cases(mesh, device, cases):
    """`moe_apply` with ``mesh`` on each case (a dict: numpy ``x`` (B, S,
    d) whole, the four whole weights, ``cfg`` keywords of an
    ArchConfig-like namespace, ``impl``), without gradients: this rank's
    rows of the batch and its experts. Returns, per case, the output
    gathered whole, the aux loss of every rank, every rank's kept-copy
    mask (T_l, k) and dropped count over its experts, and the
    collectives' calls."""
    import types

    from repro_torch.models import moe

    out = []
    for c in cases:
        cfg = types.SimpleNamespace(**c["cfg"])
        first, E_l = moe.expert_block(cfg, mesh)
        p = types.SimpleNamespace(
            router=_t(c["router"], device),
            **{k: _t(c[k][first:first + E_l], device)
               for k in ("we_gate", "we_up", "we_down")})
        axes = ("data",)
        x = _t(c["x"], device)
        n = x.shape[0] // coll.axes_size(mesh, axes)
        x = x[coll.shard_index(mesh, axes) * n:][:n]
        coll.reset_counts()
        with torch.no_grad():
            y, aux = moe.moe_apply(p, x, cfg, mesh=mesh, impl=c["impl"])
        counts = {k: list(v) for k, v in coll.counts.items()}
        idx = moe.top_k(moe.router_probs(x.reshape(-1, x.shape[-1]),
                                         p.router), cfg.topk)[1]
        kept = kept_copies(idx, cfg.n_experts, first, E_l)
        dropped = moe.dropped_copies(idx, cfg.n_experts, first_expert=first,
                                     n_local=E_l)
        out.append({"y": _gather(y, mesh, axes).cpu().numpy(),
                    "aux": _world(aux, mesh).cpu().numpy(),
                    "kept": _world(kept, mesh).cpu().numpy(),
                    "dropped": _world(dropped, mesh).cpu().numpy(),
                    "counts": counts})
    return out


def _lm(arch, params, mesh, device):
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_jax
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="meta", mesh=mesh,
                        decode_cache_seqshard=True)
    model.load_state_dict(lm_params_from_jax(params, cfg, device, mesh=mesh),
                          assign=True)
    return model


def _whole_caches(caches, mesh, axes, seq_axes):
    out = []
    for c in caches:
        out.append({k: _gather(_gather(v, mesh, axes, 0), mesh, seq_axes,
                               1).cpu().numpy() for k, v in c.items()})
    return out


def seqshard_decodes(mesh, device, cases):
    """Each case (arch, `repro`'s params as numpy, tokens (B, T) whole,
    the ring's cache_len, prompt length P): `DecoderLM` on ``mesh`` (the
    rings sharded on ``model``); a prefill of the first P tokens (P > 0)
    or `init_cache`, then a greedy-free decode of the remaining tokens
    one at a time. Returns, per case, the logits of every step (the
    prefill's first) gathered whole, the caches gathered whole, each
    rank's cache block shape, and the collectives' calls of the last
    decode step."""
    axes = ("data",)
    out = []
    for arch, params, tokens, cache_len, P in cases:
        model = _lm(arch, params, mesh, device)
        toks = _t(tokens, device).long()
        B, T = toks.shape
        n = B // coll.axes_size(mesh, axes)
        rows = toks[coll.shard_index(mesh, axes) * n:][:n]
        logits = []
        with torch.inference_mode():
            if P:
                lg, caches = model.prefill(toks[:, :P], cache_len=cache_len)
                logits.append(lg)
            else:
                caches = model.init_cache(B, cache_len)
            for t in range(P, T):
                coll.reset_counts()
                lg, caches = model.decode_step(caches, rows[:, t:t + 1], t)
                logits.append(lg)
        counts = {k: list(v) for k, v in coll.counts.items()}
        out.append({
            "logits": _gather(torch.stack(logits, 1), mesh, axes
                              ).cpu().numpy(),
            "caches": _whole_caches(caches, mesh, axes, ("model",)),
            "block": tuple(caches[0]["k"].shape), "counts": counts})
    return out


def split_refusals(mesh, device, arch, params):
    """The messages of `DecoderLM`'s ValueErrors for a batch and a ring
    that do not split over ``mesh``."""
    model = _lm(arch, params, mesh, device)
    msgs = []
    for batch, cache_len in ((3, 16), (4, 17)):
        try:
            model.init_cache(batch, cache_len)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def reductions(mesh, device, shape=(3, 5)):
    """`coll.psum` and `coll.pmax` over every non-empty subset of the
    mesh's axes, of a (3, 5) float32 tensor drawn from a generator seeded
    with the rank. Returns {axes: (every rank's psum, every rank's pmax)}
    in rank order, and the calls each op made."""
    import itertools

    import torch.distributed as dist

    gen = torch.Generator().manual_seed(dist.get_rank())
    x = torch.randn(shape, generator=gen).to(device)
    names = tuple(mesh.mesh_dim_names)
    out = {}
    coll.reset_counts()
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            out[axes] = (_world(coll.psum(x, mesh, axes), mesh).cpu().numpy(),
                         _world(coll.pmax(x, mesh, axes), mesh).cpu().numpy())
    calls = {op: coll.counts[op][0] for op in ("psum", "pmax")}
    return out, calls


def expert_blocks(mesh, device, arch, params):
    """A moe model's weights on this rank, two ways: `repro`'s whole
    ``params`` carried by `lm_params_from_jax(mesh=)`, and the port's
    `DecoderLM.init` on the mesh. Returns, per way, whether each leaf is
    the rank's block of the whole (the expert leaves their E / M rows at
    `expert_block`, the others whole, bit for bit), and the expert leaves'
    shapes."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_jax
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_block

    cfg = get_config(arch).reduced()
    first, n = expert_block(cfg, mesh)

    def same(part, whole):
        return all(torch.equal(v, whole[k][first:first + n]
                               if k.rsplit(".", 1)[-1].startswith("we_")
                               else whole[k]) for k, v in part.items())
    key = prng.PRNGKey(0, device=device)
    carried = lm_params_from_jax(params, cfg, device, mesh=mesh)
    drawn = build_model(cfg, device="meta", mesh=mesh).init(key)
    return {"carried": same(carried, lm_params_from_jax(params, cfg,
                                                        device)),
            "drawn": same(drawn, build_model(cfg, device="meta").init(key)),
            "shape": tuple(drawn["layers.0.moe.we_gate"].shape)}


def model_mesh_runs(mesh, device, moe, decodes, refusal, experts):
    """What the CPU tests hold of one model mesh, in one launch."""
    return {"moe": moe_cases(mesh, device, moe),
            "decode": seqshard_decodes(mesh, device, decodes),
            "refusal": split_refusals(mesh, device, *refusal),
            "reductions": reductions(mesh, device),
            "experts": expert_blocks(mesh, device, *experts)}


def card_seqshard(mesh, device, arch, cache_len, steps, seed=0):
    """The seqshard decode of reduced ``arch`` on ``mesh`` from the
    port's init of PRNGKey(0) on ``device``, tokens from a generator
    seeded with ``seed``: every step's logits gathered whole, and the
    collectives' calls of the last step."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="meta", mesh=mesh,
                        decode_cache_seqshard=True)
    model.init(prng.PRNGKey(0, device=device))
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (4, steps), generator=gen)
    axes = ("data",)
    n = 4 // coll.axes_size(mesh, axes)
    rows = toks[coll.shard_index(mesh, axes) * n:][:n].to(device)
    logits = []
    with torch.inference_mode():
        caches = model.init_cache(4, cache_len)
        for t in range(steps):
            coll.reset_counts()
            lg, caches = model.decode_step(caches, rows[:, t:t + 1], t)
            logits.append(lg)
    return (_gather(torch.stack(logits, 1), mesh, axes).cpu().numpy(),
            {k: list(v) for k, v in coll.counts.items()})


# --------------------------------------------------- LM clients, sharded


def lm_example():
    """examples/lm_dpfl_torch.py as a module (the ranks load it by path)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "lm_dpfl_torch.py"
    spec = importlib.util.spec_from_file_location("lm_dpfl_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_client_runs(mesh, device):
    """`run_dpfl` of the LM example's setting (reduced qwen3 clients,
    `DPFLConfig(**RUN)`) on the engine sharded over the client mesh.
    Returns the `result_dict`, the collectives' calls and bytes, and
    each rank's client rows."""
    from repro_torch.core import DPFLConfig, run_dpfl

    ex = lm_example()
    engine, _ = ex.lm_engine(ex.example_config(), ex.CLIENTS, device)
    engine.shard_clients(mesh)
    coll.reset_counts()
    res = run_dpfl(engine, DPFLConfig(**ex.RUN))
    rows = _world(torch.tensor([engine.rows.start, engine.rows.stop]), mesh)
    return {"res": result_dict(res),
            "counts": {k: list(v) for k, v in coll.counts.items()},
            "rows": rows.tolist()}


# ------------------------------------------------------------- the dry run


#: the dry run's gradient checks dispatch dropless: a rank's capacity
#: counts its own tokens, so the capacity path drops other copies on a
#: split batch than on the whole one
GRAD_KW = dict(loss_chunks=2, moe_impl="ragged")


def _whole_params(arch, seed):
    """The reduced ``arch``'s init from PRNGKey(seed) on the CPU, whole."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(dtype="float32")
    return cfg, build_model(cfg, device="meta", **GRAD_KW).init(
        prng.PRNGKey(seed))


def train_grads(mesh, device, cases):
    """Each case (arch, seed, tokens (B, T + 1) whole): the reduced
    ``arch`` on ``mesh`` (a ("data", "model") mesh: the rank's experts,
    dispatched dropless, `GRAD_KW`),
    its weights the rank's block of the whole init, one step of
    `launch.steps.make_train_step` on the whole batch with an optimizer
    that keeps the gradients it is given. Returns, per case, the loss
    and every gradient with the expert leaves gathered over ``model``
    (rank 0's), and whether every rank's non-expert gradients equal
    rank 0's."""
    import torch.distributed as dist

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.moe import expert_block
    from repro_torch.optim import Optimizer

    out = []
    for arch, seed, tokens in cases:
        cfg, whole = _whole_params(arch, seed)
        first, n = (expert_block(cfg, mesh) if cfg.family == "moe"
                    else (0, 0))
        model = build_model(cfg, device="meta", mesh=mesh, **GRAD_KW)
        model.load_state_dict(
            {k: (v[first:first + n] if ".we_" in k else v).clone().to(device)
             for k, v in whole.items()}, assign=True)
        kept = {}

        def update(grads, state, params):
            kept.update(grads)
            return {k: torch.zeros_like(g) for k, g in grads.items()}, state
        step = make_train_step(model, Optimizer(lambda p: {}, update))
        _, loss = step({}, {"tokens": _t(tokens, device).long()})
        grads = {k: (_gather(g, mesh, ("model",)) if ".we_" in k else g
                     ).cpu().numpy() for k, g in kept.items()}
        mine = [g.cpu() for k, g in sorted(kept.items()) if ".we_" not in k]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        same = all(all(torch.equal(a, b) for a, b in zip(r, every[0]))
                   for r in every)
        out.append({"loss": float(loss), "grads": grads, "same": same})
    return out


def _every_rank(x):
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, x)
    return every


def state_leaves(state):
    """{path: (shape, dtype)} of a `RoundState`'s tensors."""
    from repro_torch.analysis.guards import _leaves

    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _leaves(state).items()}


def round_records(mesh, device, data_kw, mlp, eng_kw, settings):
    """For each (name, DPFLConfig keywords) of ``settings``: one round of
    `core.dpfl.dpfl_round_step` from `dpfl_initial_state` on the sharded
    engine, its collectives recorded. Returns {name: (every rank's
    `CallRecord`s, every rank's initial `state_leaves`), each in rank
    order}."""
    from repro_torch.core.dpfl import (DPFLConfig, dpfl_initial_state,
                                       dpfl_round_step)

    engine = _engine(device, data_kw, mlp, eng_kw, mesh)
    out = {}
    for name, kw in settings:
        cfg = DPFLConfig(**kw)
        state, _ = dpfl_initial_state(engine, cfg)
        leaves = state_leaves(state)
        step = dpfl_round_step(engine, cfg)
        with coll.recording() as recs:
            step(state)
        out[name] = (_every_rank(list(recs)), _every_rank(leaves))
    return out


def decode_records(mesh, device, arch, seed, batch, cache_len, pos):
    """One decode step of the reduced ``arch`` on ``mesh`` (the rings on
    ``model``) at position ``pos`` from `init_cache`, its collectives
    recorded. Returns every rank's `CallRecord`s, in rank order."""
    from repro_torch.models import build_model

    cfg, whole = _whole_params(arch, seed)
    model = build_model(cfg, device="meta", mesh=mesh,
                        decode_cache_seqshard=True)
    model.load_state_dict({k: v.to(device) for k, v in whole.items()},
                          assign=True)
    n = batch // coll.axes_size(mesh, "data")
    with torch.inference_mode(), coll.recording() as recs:
        caches = model.init_cache(batch, cache_len)
        model.decode_step(caches, torch.zeros((n, 1), dtype=torch.int64,
                                              device=device), pos)
    return _every_rank(list(recs))


def dryrun_mesh_runs(mesh, device, grads=(), rounds=None, decode=None):
    """What the dry run's CPU tests hold of one mesh, in one launch."""
    out = {}
    if grads:
        out["grads"] = train_grads(mesh, device, grads)
    if rounds is not None:
        out["rounds"] = round_records(mesh, device, *rounds)
    if decode is not None:
        out["decode"] = decode_records(mesh, device, *decode)
    return out
