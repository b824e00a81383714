"""Batched serving: prefill of a batch of prompts, then a decode
loop (port of `repro.launch.serve`, every LM family).
Reduced config by default; runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--full] [--device cpu]

Every prefill attention runs on the K4 kernel, every prefill SSD scan on
the K5 kernel and every prefill RG-LRU recurrence on the K6 kernel on
the card (their plain versions on the CPU); decode runs the plain
ring-cache attention and the plain one-token SSD or RG-LRU updates, as
in `repro`. The MoE layers' experts are plain batched products. A vlm
model's Nv vision embeddings run before the prompt, so its caches hold
Nv + S + new_tokens positions and decode starts at Nv + S. An audio
model (whisper) encodes its frames in the prefill (K4 non-causal over
them, K4 causal in its decoder's self-attention, K4 non-causal in each
cross-attention, in decode too) and carries (enc_out, caches). The decode
loop keeps the tokens on the device and makes no device-to-host copy
(`repro_torch.analysis.guards.no_transfer` on CUDA). The CLI draws its weights,
prompts and samples from ``PRNGKey(0)`` as `repro`'s does, so the same
flags give `repro`'s prompts; a vlm model's vision embeddings are zeros,
as in `repro`'s CLI, and an audio model's frames zeros too.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from .. import prng
from ..analysis.guards import no_transfer
from ..configs import ARCH_IDS, get_config
from ..models import build_model


@dataclasses.dataclass
class Generation:
    """What `generate` returns. Tensors stay on the model's device."""
    tokens: torch.Tensor          # (B, new_tokens) int64
    prefill_logits: torch.Tensor  # (B, V) at the prompt's last position
    last_logits: torch.Tensor     # (B, V) of the last decode step
    prefill_seconds: float        # host clock, the card synchronised
    decode_seconds: float


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits: torch.Tensor, temperature: float,
                key: Optional[torch.Tensor]):
    """Greedy, or with ``temperature`` > 0 a Gumbel-max draw (what
    ``jax.random.categorical`` computes) from a split of ``key``.
    Returns ((B, 1) tokens, the carried key)."""
    if temperature <= 0:
        return logits.argmax(-1, keepdim=True), key
    ks = prng.split(key, 2)
    key, sub = ks[0], ks[1]
    u = prng.uniform(sub, logits.shape,
                     float(torch.finfo(torch.float32).tiny), 1.0)
    gumbel = -torch.log(-torch.log(u))
    return (logits / temperature + gumbel).argmax(-1, keepdim=True), key


def vision_positions(model, vision: Optional[torch.Tensor]) -> int:
    """How many positions a vlm model's ``vision`` (B, Nv, d) takes
    before the prompt: Nv, or 0 for no vision or another family (which
    ignores it, as `repro`'s does)."""
    if vision is None or model.cfg.family != "vlm":
        return 0
    return vision.shape[1]


@torch.inference_mode()
def prefill(model, prompts: torch.Tensor, new_tokens: int,
            vision: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """The first phase of `generate`: a vlm model's ``vision`` embeddings
    (B, Nv, d), then ``prompts`` (B, S), into the model's caches (rings of
    Nv + S + new_tokens slots, or SSM states); an audio model's
    ``frames`` (B, T, d) encoded first, its caches (enc_out, rings).
    Returns (last-position logits, the greedy first token (B, 1),
    caches)."""
    total = vision_positions(model, vision) + prompts.shape[1] + new_tokens
    if model.cfg.family == "audio":
        if frames is None:
            raise ValueError(f"{model.cfg.name}: an audio model's prefill "
                             f"needs frames")
        logits, caches = model.prefill(prompts, frames, cache_len=total)
    else:
        logits, caches = model.prefill(prompts, vision=vision,
                                       cache_len=total)
    return logits, logits.argmax(-1, keepdim=True), caches


@torch.inference_mode()
def decode(model, caches, tok: torch.Tensor, pos: int, steps: int, *,
           temperature: float = 0.0, key: Optional[torch.Tensor] = None):
    """The second phase of `generate`: ``steps`` decode steps after token
    ``tok`` (B, 1) at position ``pos``, the tokens kept on the device with
    no device-to-host copy (`no_transfer`). Returns ((B, steps) tokens, the
    last step's logits, None for no step)."""
    out, logits = [], None
    with no_transfer(tok.device):
        for t in range(steps):
            logits, caches = model.decode_step(caches, tok, pos + t)
            tok, key = _next_token(logits, temperature, key)
            out.append(tok)
        tokens = torch.cat(out, dim=1) if out else tok[:, :0]
    return tokens, logits


def generate(model, params: Optional[Dict[str, torch.Tensor]],
             prompts: torch.Tensor, new_tokens: int, *,
             vision: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None,
             temperature: float = 0.0,
             key: Optional[torch.Tensor] = None) -> Generation:
    """`prefill` (of a vlm model's ``vision`` embeddings and the prompts,
    or an audio model's ``frames`` and the prompts),
    the first token greedy from its logits, then `decode` of
    ``new_tokens - 1`` more from position Nv + S (greedy, or Gumbel-max
    at ``temperature`` with ``key``, a `repro_torch.prng` key on the
    model's device). ``params``
    is a state dict of ``model`` (`DecoderLM.init`,
    `repro_torch.interop.lm_params_from_jax`), bound to it without a copy
    (None keeps the model's own). Runs under ``torch.inference_mode()``."""
    if new_tokens < 1:
        raise ValueError(f"new_tokens {new_tokens} < 1")
    if temperature > 0 and key is None:
        raise ValueError("sampling at a temperature needs a key")
    if params is not None:
        model.load_state_dict(params, assign=True)
    device = prompts.device
    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, tok, caches = prefill(model, prompts, new_tokens,
                                          vision, frames)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    start = vision_positions(model, vision) + prompts.shape[1]
    tokens, last = decode(model, caches, tok, start, new_tokens - 1,
                          temperature=temperature, key=key)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat([tok, tokens], dim=1), prefill_logits,
                      prefill_logits if last is None else last, t_prefill,
                      t_decode)


def make_prompts(vocab_size: int, batch: int, length: int, seed: int,
                 device) -> torch.Tensor:
    """(batch, length) int64 token ids, uniform over the vocabulary, from a
    generator seeded with ``seed`` on ``device`` (chip_smoke.py's inputs;
    the CLI draws `repro`'s prompts with `prng.randint` instead)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab_size, (batch, length), generator=gen,
                         device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    # IEEE fp32 products, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    cfg = cfg.replace(dtype="float32")
    # weights drawn once, on the key's device (not over empty ones)
    model = build_model(cfg, device="meta")
    key = prng.PRNGKey(0, device=device)
    params = model.init(key)
    B, S = args.batch, args.prompt_len
    # `repro`'s prompts: jax.random.randint(key, (B, S), 0, vocab)
    prompts = prng.randint(key, (B, S), 0, cfg.vocab_size)
    vision = frames = None
    if cfg.family == "vlm":
        vision = torch.zeros((B, cfg.n_vision_tokens, cfg.d_model),
                             device=device)
        S += cfg.n_vision_tokens
    if cfg.family == "audio":
        frames = torch.zeros((B, cfg.n_audio_frames, cfg.d_model),
                             device=device)
    gen = generate(model, params, prompts, args.new_tokens, vision=vision,
                   frames=frames, temperature=args.temperature, key=key)
    n = args.new_tokens - 1
    print(f"prefill B={B} S={S}: {gen.prefill_seconds * 1e3:.1f} ms")
    print(f"decoded {n} steps x {B} seqs in {gen.decode_seconds:.2f}s "
          f"({n * B / max(gen.decode_seconds, 1e-9):.1f} tok/s)")
    print("sample token ids:", gen.tokens[0].tolist())


if __name__ == "__main__":
    main()
