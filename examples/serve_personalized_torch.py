"""Personalized serving on the PyTorch port: `examples/serve_personalized.py`
run through `repro_torch` (plus ``--device``). Batched decode where each
request routes to its client's personalized model (the DPFL outcome),
demonstrated with a reduced qwen3-family LM. Client models live in one
stacked state dict (leading client axis); each request's weights are
gathered once, then ``torch.func.vmap`` runs the prefill and every
decode step over the requests (`repro_torch.fl.engine.vmap_clients`), as
`repro` does with ``jax.vmap``. On the card the prefill's attention is
one K4 launch per layer for all requests.

  PYTHONPATH=src python examples/serve_personalized_torch.py      # the card
  PYTHONPATH=src python examples/serve_personalized_torch.py --device cpu
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import prng
from repro_torch.analysis.guards import no_transfer
from repro_torch.configs import get_config
from repro_torch.fl.engine import vmap_clients
from repro_torch.models import build_model

CLIENTS = 3
#: (client id, the token its prompt repeats)
REQUESTS = ((0, 7), (1, 3), (2, 11), (0, 2))
PROMPT_LEN = 8
NEW_TOKENS = 12


def example_config():
    return get_config("qwen3-0.6b").reduced().replace(dtype="float32")


def stacked_init(model, n_clients: int, device):
    """`DecoderLM.init` of each key of ``split(PRNGKey(0), n_clients)`` on
    ``device``, stacked on a leading client axis: ``jax.vmap(model.init)``
    of `repro`'s split keys, bit for bit (`prng` is jax's threefry)."""
    keys = prng.split(prng.PRNGKey(0, device=device), n_clients)
    inits = [model.init(keys[i]) for i in range(n_clients)]
    return {k: torch.stack([p[k] for p in inits]) for k in inits[0]}


def example_prompts(device):
    """(requests, PROMPT_LEN) prompts, each its request's token repeated."""
    return torch.tensor([[t] * PROMPT_LEN for _, t in REQUESTS],
                        device=device)


@dataclasses.dataclass
class Served:
    tokens: torch.Tensor          # (R, new_tokens) int64
    prefill_logits: torch.Tensor  # (R, V) at each prompt's last position
    gather_seconds: float         # host clock, the card synchronised
    prefill_seconds: float
    decode_seconds: float


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def personalized_prefill(model, params, prompts: torch.Tensor,
                         new_tokens: int):
    """Request r's prompt ``prompts[r]`` (R, S) prefilled on its own
    weights, ``params`` the requests' gathered state dicts (leading
    request axis), through one vmapped `DecoderLM.prefill` (``model``
    built with ``remat="none"``). Returns (last-position logits (R, V),
    the greedy first tokens (R, 1), the caches, each (R, 1, ...))."""
    S = prompts.shape[1]
    logits, caches = vmap_clients(
        model, lambda m, p: m.prefill(p[None], cache_len=S + new_tokens)
    )(params, prompts)
    # vmap returns an output that no request's weights touch (the ring's
    # positions) broadcast over the requests; decode writes the caches in
    # place, so each request takes its own copy
    caches = [{k: v.contiguous() for k, v in c.items()} for c in caches]
    return logits[:, 0], logits[:, 0].argmax(-1, keepdim=True), caches


@torch.inference_mode()
def personalized_decode(model, params, caches, tok: torch.Tensor, pos: int,
                        steps: int) -> torch.Tensor:
    """``steps`` greedy decode steps after tokens ``tok`` (R, 1) at
    position ``pos``, each request on its own weights (one vmapped
    `DecoderLM.decode_step` a step), the tokens kept on the device with
    no device-to-host copy (`no_transfer`). Returns (R, steps) tokens."""
    decode = vmap_clients(
        model, lambda m, b, at: m.decode_step(b[0], b[1], at))
    out = []
    with no_transfer(tok.device):
        for t in range(steps):
            logits, caches = decode(params, (caches, tok[:, None]), pos + t)
            tok = logits[:, 0].argmax(-1, keepdim=True)
            out.append(tok)
        return torch.cat(out, dim=1) if out else tok[:, :0]


def serve_personalized(model, stacked, client_ids: torch.Tensor,
                       prompts: torch.Tensor, new_tokens: int) -> Served:
    """Request r's prompt ``prompts[r]`` (R, S) served greedily on client
    ``client_ids[r]``'s weights of ``stacked``: the weights gathered once,
    then `personalized_prefill` and ``new_tokens - 1`` steps of
    `personalized_decode`."""
    device = prompts.device
    seconds = []
    _sync(device)
    t0 = time.perf_counter()
    params = {k: v[client_ids] for k, v in stacked.items()}
    _sync(device)
    seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    logits, tok, caches = personalized_prefill(model, params, prompts,
                                               new_tokens)
    _sync(device)
    seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    tokens = personalized_decode(model, params, caches, tok,
                                 prompts.shape[1], new_tokens - 1)
    _sync(device)
    seconds.append(time.perf_counter() - t0)
    return Served(torch.cat([tok, tokens], dim=1), logits, *seconds)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights (cuda or cpu)")
    args = ap.parse_args()
    device = torch.device(args.device)
    model = build_model(example_config(), device="meta", remat="none")
    # stand-in for per-client DPFL-personalized weights
    stacked = stacked_init(model, CLIENTS, device)
    client_ids = torch.tensor([c for c, _ in REQUESTS], device=device)
    served = serve_personalized(model, stacked, client_ids,
                                example_prompts(device), NEW_TOKENS)
    toks = served.tokens.cpu()
    dt = served.decode_seconds  # the decode loop, as `repro` times it
    print(f"served {len(REQUESTS)} requests x {NEW_TOKENS} tokens routed to "
          f"{CLIENTS} personalized models in {dt:.2f}s")
    for i, (c, _) in enumerate(REQUESTS):
        print(f"  req{i} -> client {c}: {toks[i].tolist()}")
    # personalization check: same prompt, different clients => different text
    assert not torch.equal(toks[0], toks[2])
    print("different clients produce different continuations ✓")


if __name__ == "__main__":
    main()
