"""The paper's eleven comparison baselines (Table 1) on the stacked-client
engine, port of `repro.fl.baselines`. Each returns a dict with the
per-client test accuracy of the best-on-validation models (the paper's
evaluation protocol).

Every method's round loop runs on the port's round engine (`_loop`):
APFL's personal branch and Ditto's personal models ride in the engine's
``aux`` dict, the evaluated model is ``eval_flat``'s, and `run_rounds`
fences the rounds with `repro_torch.analysis.guards.no_transfer`, so no
round makes a device-to-host sync. From the same seed every method draws `repro`'s
init and `repro`'s keys (`prng` is bitwise ``jax.random``).

One argument of `repro`'s ``_loop`` is not here: ``cache_key``
memoizes `repro`'s jitted round step on the engine; the port compiles
nothing, so there is nothing to keep. ``aux_specs`` names the
client-stacked aux leaves (APFL's and Ditto's personal models and the
residuals, built from the engine's rows); the schedules and keys are
whole on every rank. Every round step donates the state (as `repro`'s):
a round writes the new models into the old ones' storage.

Every method runs on an engine sharded over a client mesh
(`FLEngine.shard_clients`): a rank trains and evaluates its rows, and
what needs every client all-gathers the panel and reduces it as one
device does, in the same order (a rank-local partial sum would change
the bits): FedAvg's and the personalized methods' server average,
FedRep's body average, pFedGraph's similarities and its K1 mix. Every
rank returns the whole (N,) accuracies.

Simplifications against the original papers are `repro`'s (DESIGN.md);
every method keeps its defining mechanism:
  Local, FedAvg, FedAvg+FT, FedProx(+FT), APFL, PerFedAvg (FO-MAML),
  Ditto, FedRep, kNN-Per, pFedGraph (cosine-similarity inferred graph).
pFedGraph mixes through `core.graph.mix_flat`, the K1 graph_mix kernel;
the FedAvg server average is a plain reduction, as in `repro`.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .. import prng
from ..analysis.registry import exchange_site
from ..core.graph import mix_flat
from ..data.availability import schedule_for_data
from ..sharding.rows import eye_rows
from . import compress as _compress
from .engine import FLEngine
from .round_engine import init_round_state, make_round_step, run_rounds


# "unaccounted": Table-1 baselines are compared on accuracy, not bytes;
# their server exchange is deliberately outside the comm accounting
@exchange_site(charges="unaccounted")
def _global_avg(flat, p, active=None, engine=None):
    """FedAvg server average, broadcast to every row. Under partial
    participation (``active`` (N,) bool) only the participating clients'
    models enter the average and their weights renormalize; the divisor
    is clamped as a 0-dim tensor, so the call never syncs. ``engine``
    (a sharded one) gathers its rows' panel first and broadcasts to
    them."""
    rows = flat.shape
    if engine is not None:
        flat = engine.whole(flat)
    if active is None:
        g = torch.einsum("n,np->p", p, flat)  # p sums to 1
    else:
        w = p * active
        g = torch.einsum("n,np->p", w, flat) / torch.clamp_min(w.sum(),
                                                               1e-12)
    return g[None].expand(rows).contiguous()


def _accs(engine, acc):
    return {"test_acc": engine.whole(acc).cpu().numpy()}


def _finish(engine, best_flat):
    acc, _ = engine.eval_test(engine.unflatten(best_flat))
    return _accs(engine, acc)


def _loop(engine, rounds, tau, seed, aggregate, *, local_train=None,
          eval_flat=None, make_aux=None, aux_specs=None, participation=None,
          compression=None):
    """Generic round loop: local train -> aggregate -> track best-val.

    ``aggregate(flat, aux, t) -> (flat, aux)`` is the round's exchange
    (None: local training only); ``make_aux(flat0, key)`` builds the side
    state it carries; ``eval_flat(flat, aux)`` picks the validated and
    kept model; ``aux_specs`` marks the client-stacked leaves of
    ``make_aux``'s dict (axis 0; every other leaf is whole).
    ``participation`` puts the seeded (rounds, N) schedule in
    ``aux["part"]``: absent clients hold their params and ``aggregate``
    reads the same row. ``compression`` carries the codec's key
    (``fold_in(key, 977)``) and residuals and calls ``aggregate(flat, aux,
    t, dec)`` with the decoded (N, P) table receivers rebuild; an absent
    client's residual holds. Returns ``(best_flat, stacked, aux)``."""
    dev = engine.device
    key = prng.PRNGKey(seed, device=dev)
    flat0 = engine.flatten(engine.init_clients(key))
    aux = make_aux(flat0, key) if make_aux is not None else {}
    aux_specs = dict(aux_specs or {})
    part_key = None
    if participation is not None:
        sched = schedule_for_data(participation, rounds, engine.data)
        aux = dict(aux, part=torch.from_numpy(sched).to(dev))
        part_key = "part"
    comp = _compress.normalize(compression)
    if comp is not None:
        aux = dict(aux, k_comp=prng.fold_in(key, 977))
        if _compress.uses_ef(comp):
            aux = dict(aux, ef=torch.zeros_like(flat0))
            aux_specs["ef"] = 0
        base_agg = aggregate

        def aggregate(flat, aux, t):  # noqa: F811 (the compressed wrap)
            _, dec, new_ef = _compress.compress_exchange(
                comp, flat, aux.get("ef"), prng.fold_in(aux["k_comp"], t),
                mesh=engine.mesh, client_axes=engine.client_axes)
            out, aux2 = base_agg(flat, aux, t, dec)
            if new_ef is not None:
                if part_key is not None:
                    # an absent client transmits nothing: its residual
                    # holds (the DPFL engine's rule)
                    a = aux[part_key][t][engine.rows]
                    new_ef = torch.where(a[:, None], new_ef, aux["ef"])
                aux2 = dict(aux2, ef=new_ef)
            return out, aux2
    round_step = make_round_step(engine, tau=tau, aggregate=aggregate,
                                 local_train=local_train,
                                 eval_flat=eval_flat, aux_specs=aux_specs,
                                 participation_key=part_key, donate=True)
    state = run_rounds(round_step, init_round_state(flat0, key, aux=aux),
                       rounds)
    return state.best_flat, engine.unflatten(state.flat), state.aux


def _fedavg_agg(engine):
    return lambda f, s, t: (_global_avg(f, engine.p, engine=engine), s)


def _fine_tuned(engine, best_flat, seed, epochs):
    """Test accuracy after ``epochs`` local epochs from ``best_flat``, on
    ``PRNGKey(seed)``."""
    ft, _ = engine.local_train(engine.unflatten(best_flat),
                               prng.PRNGKey(seed), epochs=epochs)
    acc, _ = engine.eval_test(ft)
    return _accs(engine, acc)


# ------------------------------------------------------------------ methods


def run_local(engine, rounds=20, tau=5, seed=0, **kw):
    # no aggregate at all: local training exchanges nothing
    best_flat, _, _ = _loop(engine, rounds, tau, seed, None)
    return _finish(engine, best_flat)


def run_fedavg(engine, rounds=20, tau=5, seed=0, participation=None,
               compression=None, **kw):
    p, rows = engine.p, engine.rows
    if _compress.normalize(compression) is not None:
        def aggregate(f, s, t, dec):
            # uplink compression: the server averages what clients
            # transmit (decoded payloads); the downlink global replaces
            # participants' models uncompressed
            if participation is None:
                return _global_avg(dec, p, engine=engine), s
            a = s["part"][t]
            return torch.where(a[rows, None], _global_avg(
                dec, p, active=a, engine=engine), f), s
    elif participation is None:
        aggregate = _fedavg_agg(engine)
    else:
        def aggregate(f, s, t):
            # sampled FedAvg: only participants enter the (renormalized)
            # average and download the new global; absent clients hold
            a = s["part"][t]
            return torch.where(a[rows, None], _global_avg(
                f, p, active=a, engine=engine), f), s
    best_flat, _, _ = _loop(engine, rounds, tau, seed, aggregate,
                            participation=participation,
                            compression=compression)
    return _finish(engine, best_flat)


def run_fedavg_ft(engine, rounds=20, tau=5, seed=0, **kw):
    """FedAvg, then 2*tau fine-tuning epochs from the best global model."""
    best_flat, _, _ = _loop(engine, rounds, tau, seed, _fedavg_agg(engine))
    return _fine_tuned(engine, best_flat, seed + 1, 2 * tau)


def _prox_train(engine, lam):
    """Local train whose every step adds (lam/2)||w - w_ref||^2 to the
    loss, w_ref the client's round-start params (or ``ref_flat``): the
    engine's own minibatch loop, permutations and SGD with a per-step
    loss override."""
    base_loss = engine.loss_fn

    def local_train(stacked, key, epochs, *, ref_flat=None):
        ref = engine.flatten(stacked) if ref_flat is None else ref_flat

        def prox_loss(params, batch):
            return base_loss(params, batch) + 0.5 * lam * torch.sum(
                (engine.flatten(params) - ref) ** 2, dim=1)

        return engine.local_train(stacked, key, epochs, loss_fn=prox_loss)

    return local_train


def run_fedprox(engine, rounds=20, tau=5, seed=0, lam=0.1, **kw):
    best_flat, _, _ = _loop(engine, rounds, tau, seed, _fedavg_agg(engine),
                            local_train=_prox_train(engine, lam))
    return _finish(engine, best_flat)


def run_fedprox_ft(engine, rounds=20, tau=5, seed=0, lam=0.1, **kw):
    best_flat, _, _ = _loop(engine, rounds, tau, seed, _fedavg_agg(engine),
                            local_train=_prox_train(engine, lam))
    return _fine_tuned(engine, best_flat, seed + 1, 2 * tau)


def run_apfl(engine, rounds=20, tau=5, seed=0, alpha=0.5,
             participation=None, **kw):
    """APFL: personal model v mixed with the global w; v trained locally,
    w federated; evaluated on alpha*v + (1-alpha)*w (alpha fixed).

    ``state.flat`` carries the federated branch w, the personal models v
    and the base key ride in ``aux`` (v trained inside ``aggregate``),
    and the evaluated mixture is ``eval_flat``. Under partial
    participation absent clients skip both branches."""
    p, rows = engine.p, engine.rows

    def aggregate(flat, aux, t):
        active = aux["part"][t] if participation is not None else None
        w = _global_avg(flat, p, active=active, engine=engine)
        if active is not None:
            active = active[rows]
            w = torch.where(active[:, None], w, flat)
        # personal branch trains from the current mixture (old v, new w)
        mix = alpha * aux["v"] + (1 - alpha) * w
        pers, _ = engine.train_fn(engine.unflatten(mix),
                                  prng.fold_in(aux["key"], 7000 + t),
                                  epochs=tau)
        v = engine.flatten(pers)
        if active is not None:
            v = torch.where(active[:, None], v, aux["v"])
        return w, dict(aux, v=v)

    def eval_flat(flat, aux):
        return alpha * aux["v"] + (1 - alpha) * flat

    best_flat, _, _ = _loop(
        engine, rounds, tau, seed, aggregate, eval_flat=eval_flat,
        make_aux=lambda flat0, key: {"v": flat0, "key": key},
        aux_specs={"v": 0}, participation=participation)
    return _finish(engine, best_flat)


def run_perfedavg(engine, rounds=20, tau=5, seed=0, inner_lr=0.01, **kw):
    """First-order Per-FedAvg: federated training of a meta-initialization;
    evaluation after one local adaptation epoch."""
    best_flat, _, _ = _loop(engine, rounds, tau, seed, _fedavg_agg(engine))
    return _fine_tuned(engine, best_flat, seed + 3, 1)


def run_ditto(engine, rounds=20, tau=5, seed=0, lam=0.75,
              participation=None, **kw):
    """Ditto: FedAvg global plus per-client personal models with a prox
    term to the global; the personal models are evaluated.

    ``state.flat`` carries the global branch, the personal models and the
    base key ride in ``aux`` (prox-trained towards the fresh global
    inside ``aggregate``), and ``eval_flat`` evaluates the personal
    models. Under partial participation absent clients hold both."""
    p, rows = engine.p, engine.rows
    lt_prox = _prox_train(engine, lam)

    def aggregate(flat, aux, t):
        active = aux["part"][t] if participation is not None else None
        g = _global_avg(flat, p, active=active, engine=engine)
        if active is not None:
            active = active[rows]
            g = torch.where(active[:, None], g, flat)
        # personal step: prox-regularized towards the *global* params
        pers, _ = lt_prox(engine.unflatten(aux["pers"]),
                          prng.fold_in(aux["key"], 5000 + t),
                          epochs=tau, ref_flat=g)
        pers_flat = engine.flatten(pers)
        if active is not None:
            pers_flat = torch.where(active[:, None], pers_flat, aux["pers"])
        return g, dict(aux, pers=pers_flat)

    def eval_flat(flat, aux):
        return aux["pers"]

    best_flat, _, _ = _loop(
        engine, rounds, tau, seed, aggregate, eval_flat=eval_flat,
        make_aux=lambda flat0, key: {"pers": flat0, "key": key},
        aux_specs={"pers": 0}, participation=participation)
    return _finish(engine, best_flat)


def run_fedrep(engine, rounds=20, tau=5, seed=0, **kw):
    """FedRep: share the representation (body), keep the heads local
    (the model's ``HEAD_KEYS``)."""
    head_keys = set(getattr(engine.model, "HEAD_KEYS", ()))
    p = engine.p

    @exchange_site(charges="unaccounted")
    def aggregate(flat, state, t):
        stacked = engine.unflatten(flat)
        whole = engine.unflatten(engine.whole(flat))
        for name, leaf in stacked.items():
            if name not in head_keys:  # heads stay local
                g = torch.einsum("n,n...->...", p, whole[name])
                stacked[name] = g[None].expand(leaf.shape)
        return engine.flatten(stacked), state

    best_flat, _, _ = _loop(engine, rounds, tau, seed, aggregate)
    return _finish(engine, best_flat)


def knn_rank(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of ``d`` along its last axis, nearest
    first, equal distances by lower index: ``jax.lax.top_k(-d, k)``'s
    choice (a stable ascending sort; ``torch.topk`` leaves the order of
    ties unspecified)."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _vote_table(k: int) -> np.ndarray:
    """float32 c * (1/k) as c scatter-adds of 1/k onto 0 give it
    (``zeros.at[labels].add(1.0 / k)``), for c = 0..k: the same bits in
    any order, since every addend is the same."""
    step = np.float32(1.0 / k)
    out = np.zeros(k + 1, np.float32)
    for c in range(1, k + 1):
        out[c] = out[c - 1] + step
    return out


def run_knnper(engine, rounds=20, tau=5, seed=0, k_nn=10, lam=0.5, **kw):
    """kNN-Per: FedAvg global model plus a per-client kNN over the local
    training set's features (penultimate layer), interpolated at
    inference."""
    best_flat, _, _ = _loop(engine, rounds, tau, seed, _fedavg_agg(engine))
    params = engine.unflatten(best_flat)
    model = engine.model
    n_classes = engine.data.n_classes
    tr_x, tr_y = engine.train_data
    te_x, te_y = engine.test_data
    k = min(k_nn, tr_x.shape[1])
    with torch.no_grad():
        f_tr = model.features(params, tr_x)         # (N, n_tr, F)
        f_te = model.features(params, te_x)         # (N, n_te, F)
        d = torch.sum((f_te[:, :, None, :] - f_tr[:, None, :, :]) ** 2, -1)
        idx = knn_rank(d, k)                        # (N, n_te, k)
        labels = torch.gather(tr_y[:, None, :].expand(idx.shape[:2] + (-1,)),
                              -1, idx)
        counts = torch.nn.functional.one_hot(labels, n_classes).sum(-2)
        votes = torch.from_numpy(_vote_table(k)).to(best_flat.device)
        knn_prob = votes[counts]                    # (N, n_te, C)
        logits = model.logits(params, te_x)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        model_prob = e / e.sum(-1, keepdim=True)    # jax.nn.softmax
        prob = lam * knn_prob + (1 - lam) * model_prob
        acc = (torch.argmax(prob, -1) == te_y).float().mean(-1)
    return _accs(engine, acc)


def run_pfedgraph(engine, rounds=20, tau=5, seed=0, temp=5.0,
                  self_weight=0.5, **kw):
    """pFedGraph (simplified): infer the collaboration graph each round
    from the pairwise cosine similarity of the flattened models and mix
    with the row-normalized similarity weights (all clients weighted, no
    budget), through the K1 mix. Under a mesh a rank takes its rows of
    the similarities against the gathered normalized panel."""
    mesh, ca, row0 = engine.mesh, engine.client_axes, engine.rows.start

    def aggregate(flat, state, t):
        norm = flat / torch.clamp_min(
            torch.linalg.vector_norm(flat, dim=1, keepdim=True), 1e-9)
        sim = norm @ engine.whole(norm).T
        w = torch.softmax(temp * sim, dim=1)
        m, n = w.shape
        w = (1 - self_weight) * w + self_weight * eye_rows(
            m, n, row0, flat.device).float()
        w = w / w.sum(1, keepdim=True)
        return mix_flat(w, flat, mesh=mesh, client_axes=ca), state

    best_flat, _, _ = _loop(engine, rounds, tau, seed, aggregate)
    return _finish(engine, best_flat)


BASELINES: Dict[str, Callable] = {
    "local": run_local,
    "fedavg": run_fedavg,
    "fedavg_ft": run_fedavg_ft,
    "fedprox": run_fedprox,
    "fedprox_ft": run_fedprox_ft,
    "apfl": run_apfl,
    "perfedavg": run_perfedavg,
    "ditto": run_ditto,
    "fedrep": run_fedrep,
    "knnper": run_knnper,
    "pfedgraph": run_pfedgraph,
}


def run_baseline(name: str, engine: FLEngine, **kw):
    return BASELINES[name](engine, **kw)
