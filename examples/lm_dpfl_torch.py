"""DPFL over transformer LMs on the PyTorch port: `examples/lm_dpfl.py`
run through `repro_torch` (plus ``--device``). Clients hold reduced
qwen3-family models; two latent corpus clusters (distinct bigram
statistics); GGC uses per-client validation loss as the reward. Shows
the collaboration graph recovering the corpus clusters.

The loss and the next-token accuracy are one-client functions of a
`DecoderLM`; `repro_torch.fl.engine.vmap_clients` turns them into the
engine's client-stacked contract (``torch.func.vmap`` over
``functional_call``, as `repro` vmaps them with ``jax.vmap``), so every
local step, reward probe and evaluation is one batched forward over the
clients, with one K4 launch per layer on the folded client and batch
axes on the card.

  PYTHONPATH=src python examples/lm_dpfl_torch.py               # the card
  PYTHONPATH=src python examples/lm_dpfl_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DPFLConfig, run_dpfl
from repro_torch.data import make_lm_token_data
from repro_torch.data.synthetic import FederatedData
from repro_torch.fl.engine import FLEngine, vmap_clients
from repro_torch.models import build_model
from repro_torch.models.common import rms_norm

#: the example's corpus (its vocabulary is the data's, not the model's)
#: and its split of each client's 48 sequences: 24 train, 12 val, 12 test
DATA = dict(seed=0, vocab=256, seq_len=32, n_seqs=48, n_clusters=2)
SPLIT = (24, 36)
CLIENTS = 6
ENGINE = dict(lr=0.01, batch_size=8)
RUN = dict(rounds=4, tau_init=2, tau_train=2, budget=3, seed=0)


def example_config():
    """The example's model: qwen3-0.6b reduced to 2 layers of width 64."""
    return get_config("qwen3-0.6b").reduced().replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
        vocab_size=DATA["vocab"], head_dim=32, dtype="float32")


def lm_loss(model, batch):
    """One client's next-token cross-entropy over its (b, T + 1) tokens."""
    loss, _ = model.loss({"tokens": batch["x"]})
    return loss


def lm_acc(model, batch):
    """One client's next-token argmax accuracy, the "accuracy" GGC's
    runs validate and test with."""
    toks = batch["x"]
    x = model._embed(toks[:, :-1])
    q_pos = torch.arange(x.shape[1], device=x.device)
    h, _ = model._apply_stack(x, q_pos)
    h = rms_norm(h, model.final_norm, model.cfg.norm_eps)
    return (model._logits(h).argmax(-1) == toks[:, 1:]).float().mean()


def lm_engine(cfg, n_clients: int, device):
    """The example's engine over ``n_clients`` clients of ``cfg`` (built
    on "meta"; `run_dpfl`'s init draws the weights on ``device``) on the
    example's corpus. Returns (engine, each client's corpus cluster)."""
    tokens, cluster_of = make_lm_token_data(n_clients=n_clients, **DATA)
    tr, va, te = np.split(tokens, SPLIT, axis=1)
    data = FederatedData(
        train_x=tr, train_y=np.zeros(tr.shape[:2], np.int32),
        val_x=va, val_y=np.zeros(va.shape[:2], np.int32),
        test_x=te, test_y=np.zeros(te.shape[:2], np.int32),
        p=np.full(n_clients, 1.0 / n_clients), cluster=cluster_of,
        n_classes=DATA["vocab"])
    model = build_model(cfg, device="meta", remat="none", loss_chunks=1)
    engine = FLEngine(model, data, loss_fn=vmap_clients(model, lm_loss),
                      acc_fn=vmap_clients(model, lm_acc), device=device,
                      **ENGINE)
    return engine, cluster_of


def graph_split(adj: np.ndarray, cluster_of: np.ndarray):
    """Mean edge rate of ``adj`` within and across corpus clusters."""
    adj = adj.astype(float)
    same = cluster_of[:, None] == cluster_of[None, :]
    return adj[same].mean(), adj[~same].mean()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    args = ap.parse_args()
    engine, cluster_of = lm_engine(example_config(), CLIENTS, args.device)
    res = run_dpfl(engine, DPFLConfig(**RUN))
    same, cross = graph_split(res.graph_history[-1], cluster_of)
    print("next-token acc per client: "
          + " ".join(f"{a:.3f}" for a in res.test_acc))
    print(f"graph edges within corpus-cluster {same:.2f} vs across "
          f"{cross:.2f}")


if __name__ == "__main__":
    main()
