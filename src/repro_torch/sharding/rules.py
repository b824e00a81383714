"""Megatron-style logical sharding rules for every model family (port of
`repro.sharding.rules`).

Axes: ``data`` shards the batch (and a long-context cache's sequence),
``model`` shards heads, d_ff, vocab, experts and the recurrent width.
KV projections whose head count does not divide the model axis are
replicated; Mamba2 blocks are replicated whole.

A spec is a tuple with one entry per dimension of a leaf: ``None``
(whole), an axis name, or a tuple of axis names (the dimension split
over their product, row-major): ``tuple(PartitionSpec(...))`` of
`repro`'s. The port's layers are separate modules, so its specs are
keyed by the state-dict names ("layers.3.moe.we_gate") with no stacked
layer axis, and a cache's are one dict a layer. `local_block` cuts a
rank's block of a whole tensor by its spec.

A model built on a mesh of `MODEL_MESH_AXES` (`repro_torch.models.lm.
DecoderLM`) runs two of these rules: the expert leaves (``we_gate``,
``we_up``, ``we_down``: ``("model", None, None)``, so a rank holds E / M
experts) and the attention caches under ``shard_seq_model``. The dry run
(`repro_torch.launch.dryrun`, as `repro`'s) reads the rest: a rank's
resident bytes are the `local_block` blocks of `param_specs`, `cache_specs`
and the inputs' specs (which must agree with `batch_specs`), under
`add_client_axis` for two pods, and every weight of its rank-local model
is held to its `local_block`.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[object], ...]

#: the axes of the mesh a model is built on (`repro_torch.models.lm.
#: DecoderLM`, `repro_torch.models.moe.moe_apply`): the batch on "data",
#: the experts and each attention ring's slots on "model"
MODEL_MESH_AXES = ("data", "model")
#: the experts' leaves: split over ``model`` on the expert axis
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")
#: a Mamba2 block's leaves, replicated whole (a small model)
_SSM_LEAVES = ("in_proj", "out_proj", "A_log", "D", "dt_bias", "norm_w",
               "conv_w")


def _sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a `DeviceMesh`, or ``mesh`` itself when it is such
    a mapping (the production sizes, with no world to build a mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def check_model_mesh(mesh) -> None:
    """Raise ``ValueError`` unless ``mesh``'s axes are `MODEL_MESH_AXES`."""
    names = tuple(mesh.mesh_dim_names)
    if names != MODEL_MESH_AXES:
        raise ValueError(f"a model is built on a mesh of axes "
                         f"{MODEL_MESH_AXES}, not {names}")


def _param_rule(name: str, shape: Sequence[int], model_size: int,
               kv_heads: int) -> Spec:
    """The spec of a leaf called ``name`` (its last name) of ``shape``
    (`repro`'s ``_param_rule``)."""
    def div(i):
        return shape[i] % model_size == 0

    none = (None,) * len(shape)
    if name == "tok_embed":
        return ("model", None)
    if name == "lm_head":
        return (None, "model")
    if name in ("wq", "wi_gate", "wi_up", "wi", "w_gate", "w_lin", "wa",
                "wx"):
        return (None, "model") if div(-1) else none
    if name in ("wk", "wv"):
        # shard only when whole KV heads divide the axis
        if kv_heads and kv_heads % model_size == 0:
            return (None, "model")
        return none
    if name in ("wo", "wo_mlp", "w_out"):
        return ("model", None) if div(0) else none
    if name in ("bi", "lam", "ba", "bx"):
        return ("model",) if div(-1) else none
    if name in EXPERT_LEAVES:
        return ("model", None, None)    # expert parallel
    if name == "conv_w" and len(shape) == 2 and div(-1):
        return (None, "model")
    return none


def param_specs(model, cfg, mesh) -> Dict[str, Spec]:
    """{state-dict name: spec} of ``model`` (`repro`'s ``param_specs``,
    the stacked layer axis dropped). ``mesh`` is a `DeviceMesh` or a
    mapping of axis sizes; only its ``model`` size is read. ``model`` may
    be built on "meta"."""
    model_size = _sizes(mesh).get("model", 1)
    out = {}
    for key, leaf in model.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if cfg.family == "ssm" and name in _SSM_LEAVES:
            out[key] = (None,) * leaf.dim()
        else:
            out[key] = _param_rule(name, tuple(leaf.shape), model_size,
                                   cfg.n_kv_heads)
    return out


def cache_leaf_spec(name: str, ndim: int, data, seq) -> Spec:
    """The spec of one layer's cache leaf: k and v (B, C, Hkv, hd) and pos
    (B, C) on ``data`` and ``seq`` (an axis, a tuple of axes or None),
    the state and conv leaves on ``data`` alone."""
    if name in ("k", "v"):
        return (data, seq, None, None)
    if name == "pos":
        return (data, seq)
    return (data,) + (None,) * (ndim - 1)


def cache_specs(model, cfg, batch: int, cache_len: int, *,
                shard_seq: bool = False,
                shard_seq_model: bool = False) -> List[Dict[str, Spec]]:
    """One {leaf: spec} a layer of ``model.init_cache(batch, cache_len)``
    (`repro`'s ``cache_specs``, the stacked axis dropped): the batch on
    ``data`` when batch > 1; the sequence on ``data`` with ``shard_seq``
    at batch 1 (long_500k), on ``model`` with ``shard_seq_model`` (the
    flash-decoding layout of `repro_torch.models.lm.attn_decode_seqshard`).
    Build ``model`` on "meta" to allocate nothing."""
    data = "data" if batch > 1 else None
    if shard_seq_model:
        seq = "model"
    else:
        seq = "data" if (shard_seq and batch == 1) else None
    return [{name: cache_leaf_spec(name, leaf.dim(), data, seq)
             for name, leaf in layer.items()}
            for layer in model.init_cache(batch, cache_len)]


def batch_specs(cfg, shape_kind: str, global_batch: int,
                data_axes=("data",)) -> Dict[str, Spec]:
    """Specs of a batch dict (`repro`'s ``batch_specs``): the batch on
    ``data_axes`` (``("data",)`` or ``("pod", "data")``) when it is
    above 1; a vlm's vision and an audio model's frames likewise."""
    axes = tuple(data_axes)
    # one axis is its name, as PartitionSpec normalises it
    axes = (axes[0] if len(axes) == 1 else axes) if global_batch > 1 \
        else None
    out = {"tokens": (axes, None)}
    if cfg.family == "vlm":
        out["vision"] = (axes, None, None)
    if cfg.family == "audio":
        out["frames"] = (axes, None, None)
    return out


def add_client_axis(spec_tree):
    """A leading ``pod`` (client) axis on every spec of a dict or list of
    specs (`repro`'s ``add_client_axis``)."""
    if isinstance(spec_tree, dict):
        return {k: add_client_axis(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [add_client_axis(v) for v in spec_tree]
    return ("pod",) + tuple(spec_tree)


def local_block(tensor: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole ``tensor`` under ``spec`` (a view):
    each dimension with axes split into their product's equal blocks,
    the rank's the one at its row-major position over those axes.
    Raises ``ValueError`` for a dimension that does not split."""
    from . import collectives as coll

    sizes = _sizes(mesh)
    out = tensor
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= sizes[a]
        if tensor.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(tensor.shape)} "
                             f"does not split over {axes} ({n} shards)")
        step = tensor.shape[dim] // n
        i = coll.shard_index(mesh, axes)
        out = out.narrow(dim, i * step, step)
    return out
