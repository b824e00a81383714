"""The dry run's inputs: "meta" stand-ins for every model input and their
specs, per (architecture x input shape x mesh) (port of
`repro.launch.specs`: ``resolve_arch_for_shape``, ``input_specs``,
``batch_spec_tree``).

`input_specs` returns "meta" tensors of `repro`'s shapes (no storage);
`batch_spec_tree` returns the port's spec tuples
(`repro_torch.sharding.rules`: one entry a dimension, ``None``, an axis
name or a tuple of names), `repro`'s ``PartitionSpec``\\ s as tuples.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import get_config
from ..configs.base import ArchConfig
from ..configs.shapes import InputShape, get_shape

#: token ids, as `repro`'s (``jnp.int32``)
TOK = torch.int32


def meta(shape, dtype) -> torch.Tensor:
    """A "meta" tensor of ``shape`` and ``dtype``: `repro`'s ``sds``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def resolve_arch_for_shape(arch: str, shape_name: str,
                           swa_window: int = 4096) -> ArchConfig:
    """The config of ``arch`` for ``shape_name``: long_500k gets a sliding
    window of ``swa_window`` unless the config supports long context;
    whisper-medium x long_500k raises ``NotImplementedError`` (`repro`'s
    documented skip)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.name == "long_500k":
        if cfg.family == "audio":
            raise NotImplementedError(
                "whisper-medium x long_500k is skipped by design: the decoder"
                " cross-attends to <=1500 encoder frames and generates <=448"
                " tokens; a 524288-token decoder cache contradicts the"
                " architecture (DESIGN.md §5).")
        if not cfg.supports_long_context:
            cfg = cfg.with_window(swa_window)
    return cfg


def input_specs(cfg: ArchConfig, shape: InputShape, *, per_client=1,
                dtype=torch.float32):
    """"meta" tensors of every model input of this (arch, shape), as
    `repro`'s ``input_specs``: token ids int32, embeddings (a vlm's
    vision, an audio model's frames and encoder output) in ``dtype`` (the
    port's step runs fp32). ``per_client`` > 1 stacks that many DPFL
    clients on a leading axis (each with global_batch / per_client
    rows)."""
    C = per_client
    B = shape.global_batch // max(C, 1)
    S = shape.seq_len
    d = cfg.d_model

    def cl(shp):
        return (C,) + tuple(shp) if C > 1 else tuple(shp)

    if shape.kind == "train":
        if cfg.family == "vlm":
            t = S - cfg.n_vision_tokens
            return {"tokens": meta(cl((B, t + 1)), TOK),
                    "vision": meta(cl((B, cfg.n_vision_tokens, d)), dtype)}
        if cfg.family == "audio":
            return {"tokens": meta(cl((B, S + 1)), TOK),
                    "frames": meta(cl((B, cfg.n_audio_frames, d)), dtype)}
        return {"tokens": meta(cl((B, S + 1)), TOK)}

    if shape.kind == "prefill":
        if cfg.family == "vlm":
            return {"tokens": meta(cl((B, S - cfg.n_vision_tokens)), TOK),
                    "vision": meta(cl((B, cfg.n_vision_tokens, d)), dtype)}
        if cfg.family == "audio":
            return {"tokens": meta(cl((B, S)), TOK),
                    "frames": meta(cl((B, cfg.n_audio_frames, d)), dtype)}
        return {"tokens": meta(cl((B, S)), TOK)}

    # decode: one new token against a cache of seq_len
    out = {"token": meta(cl((B, 1)), TOK), "pos": meta((), TOK)}
    if cfg.family == "audio":
        out["enc_out"] = meta(cl((B, cfg.n_audio_frames, d)), dtype)
    return out


def batch_spec_tree(cfg: ArchConfig, shape: InputShape, data_axes=("data",),
                    client_axis: Optional[str] = None):
    """The specs of `input_specs`' tensors (`repro`'s ``batch_spec_tree``):
    the batch on ``data_axes`` only when the global batch is 16 or more
    (tiny batches stay whole), the ``client_axis`` in front where given;
    one axis is its name, as ``PartitionSpec`` normalises it."""
    B = shape.global_batch
    shard_b = B > 1 and B >= 16  # don't shard tiny batches
    da = tuple(data_axes)
    b = (da[0] if len(da) == 1 else da) if shard_b else None

    def wrap(*tail):
        lead = (client_axis,) if client_axis else ()
        return lead + tail

    bt = wrap(b, None)
    b3 = wrap(b, None, None)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": bt}
        if cfg.family == "vlm":
            out["vision"] = b3
        if cfg.family == "audio":
            out["frames"] = b3
        return out
    out = {"token": bt, "pos": ()}
    if cfg.family == "audio":
        out["enc_out"] = b3
    return out
