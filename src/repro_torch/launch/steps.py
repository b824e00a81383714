"""Step functions of the entry points (port of `repro.launch.steps`:
`make_train_step`, `make_prefill_step`, `make_decode_step`, and
`make_dpfl_mix`).

The model owns its weights (`repro_torch.models.build_model`), so a step
takes no params argument, and a maker no config: the model is a
`DecoderLM` of the dense, moe, vlm, SSM or hybrid family, or the audio
family's `WhisperModel`. A vlm batch carries its "vision" embeddings,
which the loss and the prefill run before the tokens; an audio batch its
"frames", which they encode, and an audio decode step takes the
encoder's output beside the caches, as `repro`'s.
"""
from __future__ import annotations

import functools

import torch

from ..analysis.registry import exchange_site
from ..core.graph import mix_pytree


def make_train_step(model, optimizer, grad_dtype=None):
    """step(opt_state, batch) -> (opt_state, loss): the gradients of
    ``model.loss(batch)`` with respect to every weight, cast to
    ``grad_dtype`` if given (e.g. bf16, halving a data-parallel
    all-reduce), then ``optimizer.update`` and the updates added to the
    weights in place. `repro`'s step maps (params, opt_state, batch) to
    (params, opt_state, loss): here the model owns its weights, and
    updating them (and AdamW's moments) in place is the port's stand-in
    for donating the old ones, so params are neither passed nor
    returned. ``opt_state`` is ``optimizer.init`` of the model's weights
    (``dict(model.named_parameters())``); the loss comes back detached,
    on the model's device (no host sync)."""
    params = dict(model.named_parameters())

    def step(opt_state, batch):
        loss, _ = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        if grad_dtype is not None:
            grads = {k: g.to(grad_dtype) for k, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k].to(p.dtype))
        return opt_state, loss.detach()
    return step


def make_prefill_step(model):
    """step(batch, cache_len=None) -> (last-position logits, caches), a
    vlm batch's "vision" embeddings before its tokens; for the audio
    family -> (logits, (enc_out, caches)) from the batch's "frames"."""
    if model.cfg.family == "audio":
        def step(batch, cache_len=None):
            return model.prefill(batch["tokens"], batch["frames"],
                                 cache_len=cache_len)
        return step

    def step(batch, cache_len=None):
        return model.prefill(batch["tokens"], vision=batch.get("vision"),
                             cache_len=cache_len)
    return step


def make_decode_step(model):
    """step(caches, token, pos) -> (logits, caches), caches written in
    place (a ring slot, or the SSM or RG-LRU state and conv rows); for
    the audio family step(enc_out, caches, token, pos) -> (logits,
    caches), as `repro`'s."""
    if model.cfg.family == "audio":
        def step(enc_out, caches, token, pos: int):
            logits, (_, caches) = model.decode_step((enc_out, caches), token,
                                                    pos)
            return logits, caches
        return step

    def step(caches, token, pos: int):
        return model.decode_step(caches, token, pos)
    return step


@exchange_site(charges="caller")
def make_dpfl_mix(mix_matrix: torch.Tensor):
    """Cross-client DPFL aggregation: w_k <- sum_i A[k, i] w_i on
    client-stacked params. mix_matrix: (C, C) row-stochastic (built by
    `repro_torch.core.graph` from the GGC-selected collaboration sets).
    mix(stacked) maps a dict of (C, ...) leaves to the mixed dict
    (`repro_torch.core.graph.mix_pytree`: each leaf viewed as (C, P) and
    mixed in fp32 by K1, one launch per leaf on the card, then cast back
    to the leaf's dtype)."""
    return functools.partial(mix_pytree, mix_matrix)
