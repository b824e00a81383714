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
    on the model's device (no host sync). Under a model's ("data",
    "model") mesh with its batch split on ``data`` (``moe_data_axes``)
    each rank's gradients are its rows' part, summed over ``data`` (one
    `psum` a weight), so every rank takes the whole batch's step: a
    rank's experts their own, every other weight the same. A weight the
    loss does not read (ln2 under ``parallel_block``) gets a zero
    gradient, as `jax.grad` gives it. The gradients come in the leaves'
    dtypes (bf16 leaves: bf16), and AdamW's moments are in its
    ``state_dtype`` (`optim.adamw`), as in `repro`."""
    from ..sharding import collectives as coll

    params = dict(model.named_parameters())
    mesh = getattr(model, "mesh", None)
    split = mesh is not None and bool(getattr(model, "moe_data_axes", ()))

    def step(opt_state, batch):
        loss, _ = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        if split:
            grads = {k: coll.psum(g, mesh, "data") for k, g in grads.items()}
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
def make_dpfl_mix(mix_matrix: torch.Tensor, mesh=None, axis: str = "pod"):
    """Cross-client DPFL aggregation: w_k <- sum_i A[k, i] w_i on
    client-stacked params. mix_matrix: (C, C) row-stochastic (built by
    `repro_torch.core.graph` from the GGC-selected collaboration sets).
    mix(stacked) maps a dict of (C, ...) leaves to the mixed dict
    (`repro_torch.core.graph.mix_pytree`: each leaf viewed as (C, P) and
    mixed in fp32 by K1, one launch per leaf on the card, then cast back
    to the leaf's dtype).

    With a ``mesh`` whose ``axis`` holds the C clients (`repro`'s
    client-stacked weights sharded on "pod", one client a pod), this
    rank holds its client's block of each weight: mix(blocks) maps a
    dict of the rank's blocks to its mixed blocks, each leaf's blocks
    all-gathered over ``axis`` (`collectives.all_gather_rows`), then
    the (C, C) @ (C, block) product of K1 in fp32 and this rank's row,
    cast back to the leaf's dtype."""
    if mesh is None:
        return functools.partial(mix_pytree, mix_matrix)
    from ..kernels import ops
    from ..sharding import collectives as coll

    A = mix_matrix.float().contiguous()
    row = coll.axis_index(mesh, axis)

    def mix(blocks):
        out = {}
        for k, w in blocks.items():
            flat = w.reshape(1, -1).float().contiguous()
            rows = coll.all_gather_rows(flat, mesh, (axis,))
            out[k] = ops.graph_mix(A, rows)[row].reshape(w.shape).to(w.dtype)
        return out
    return mix
