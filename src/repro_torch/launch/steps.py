"""Step functions of the serving loop (port of the decoder-only half
of `repro.launch.steps`: `make_prefill_step`, `make_decode_step`).

The model owns its weights (`repro_torch.models.lm.DecoderLM`), so a step
takes no params argument, and a maker no config: the model is a
`DecoderLM` of the dense, SSM or hybrid family, which has no audio or vlm
branch.
`make_train_step` and `make_dpfl_mix` come with LM training (ROADMAP
Queue 1 item 14d).
"""
from __future__ import annotations


def make_prefill_step(model):
    """step(batch, cache_len=None) -> (last-position logits, caches)."""

    def step(batch, cache_len=None):
        return model.prefill(batch["tokens"], cache_len=cache_len)
    return step


def make_decode_step(model):
    """step(caches, token, pos) -> (logits, caches), caches written in
    place (a ring slot, or the SSM or RG-LRU state and conv rows)."""

    def step(caches, token, pos: int):
        return model.decode_step(caches, token, pos)
    return step
