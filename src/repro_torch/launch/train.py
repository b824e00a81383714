"""Single-host LM training entry point (port of `repro.launch.train`):
synthetic bigram corpus -> AdamW under warmup_cosine -> checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

`repro.launch.train`'s flags plus ``--device`` (default cuda). It
computes what `repro.launch.train` computes from the same seed: the init
of ``PRNGKey(0)`` (bit for bit, `repro_torch.prng`), the same corpus
(``make_lm_token_data(seed=0, ...)``), the same batches
(``np.random.default_rng(0)``), the same schedule, and the same log
lines. On the card each layer runs under activation recompute (remat
"full", as `repro`'s model), its kernel's forward twice a step and its
backward once: K4 in the attention layers (dense, moe, vlm, hybrid and
audio: the encoder's, the decoder's self- and cross-attention), K5 in
the Mamba2 layers (SSM), K6 in the RG-LRU layers (hybrid). Every family
trains: a moe model's loss adds its router's load-balance loss, a vlm
model's batches carry zero vision embeddings before the tokens and an
audio model's zero frames, as in `repro`. Checkpoints hold `repro`'s
stacked tree
(`repro_torch.interop.lm_params_to_jax`), which `repro.checkpoint` reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .. import prng
from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data import make_lm_token_data
from ..interop import lm_params_to_jax
from ..models import build_model
from ..optim import Optimizer, adamw, warmup_cosine
from .steps import make_train_step


@dataclasses.dataclass
class TrainRun:
    """What `train` (and `main`) returns: the trained model (its weights
    updated in place), the optimizer and its state, the number of
    weights, the loss of every step and each step's wall time (host
    clock, the device synchronised by reading the loss)."""
    model: Any
    optimizer: Optimizer
    opt_state: Any
    n_params: int
    losses: List[float]
    step_seconds: List[float]


def lm_corpus(cfg, batch: int, seq: int) -> np.ndarray:
    """`repro.launch.train`'s corpus: (n_seqs, seq + 1) int32 token rows of
    one client of ``make_lm_token_data(seed=0, ...)`` over the first
    min(vocab, 4096) ids, n_seqs = max(8 batch, 64)."""
    tokens, _ = make_lm_token_data(
        seed=0, n_clients=1, vocab=min(cfg.vocab_size, 4096),
        seq_len=seq, n_seqs=max(batch * 8, 64))
    return tokens[0]


def batch_rows(n_seqs: int, batch: int, steps: int) -> List[np.ndarray]:
    """Each step's corpus rows, as `repro.launch.train` draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, n_seqs, batch) for _ in range(steps)]


def train(model, corpus: np.ndarray, *, steps: int, batch: int, lr: float,
          ckpt_dir: str = "", ckpt_every: int = 25, log_every: int = 5,
          vision: Optional[torch.Tensor] = None,
          frames: Optional[torch.Tensor] = None) -> TrainRun:
    """`repro.launch.train`'s loop on ``model`` (initialised, on its
    device) from ``corpus`` (`lm_corpus`): AdamW under
    ``warmup_cosine(lr, 10, steps)``, `repro`'s batches (`batch_rows`)
    and log lines, a checkpoint every ``ckpt_every`` steps. A vlm
    model's batches carry ``vision`` (batch, n_vision_tokens, d_model)
    before the tokens at every step, zeros by default, as `repro`'s loop
    feeds them. (At internvl2-2b's full depth zero embeddings give
    non-finite gradients, in `repro` too: each RMS norm of a zero row
    scales its gradient by 1/sqrt(eps), and 48 norms overflow fp32.) An
    audio model's batches carry ``frames`` (batch, n_audio_frames,
    d_model), zeros by default, as `repro`'s loop feeds them (the
    sinusoidal positions keep every encoder row nonzero)."""
    device = model.tok_embed.device
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.from_numpy(corpus).to(device)
    optimizer = adamw(warmup_cosine(lr, 10, steps))
    opt_state = optimizer.init(dict(model.named_parameters()))
    step_fn = make_train_step(model, optimizer)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses, walls = [], []
    t0 = time.time()
    for step, idx in enumerate(batch_rows(corpus.shape[0], batch, steps)):
        t_step = time.perf_counter()
        batch_t = {"tokens": tokens[torch.from_numpy(idx).to(device)]}
        if cfg.family == "vlm":
            batch_t["vision"] = torch.zeros(
                (batch, cfg.n_vision_tokens, cfg.d_model), device=device) \
                if vision is None else vision
        if cfg.family == "audio":
            batch_t["frames"] = torch.zeros(
                (batch, cfg.n_audio_frames, cfg.d_model), device=device) \
                if frames is None else frames
        opt_state, loss = step_fn(opt_state, batch_t)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t_step)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_step(step + 1, lm_params_to_jax(model.state_dict(), cfg),
                          {"loss": losses[-1]})
    print("done.")
    return TrainRun(model, optimizer, opt_state, n_params, losses, walls)


def main(argv: Optional[List[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    # IEEE fp32 products, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(dtype="float32")
    # weights drawn once, on the key's device (not over empty ones)
    model = build_model(cfg, device="meta", loss_chunks=4)
    params = model.init(prng.PRNGKey(0, device=torch.device(args.device)))
    print(f"arch={cfg.name} params="
          f"{sum(t.numel() for t in params.values())/1e6:.2f}M "
          f"family={cfg.family}")
    return train(model, lm_corpus(cfg, args.batch, args.seq),
                 steps=args.steps, batch=args.batch, lr=args.lr,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 log_every=args.log_every)


if __name__ == "__main__":
    main()
