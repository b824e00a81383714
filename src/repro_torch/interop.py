"""Carry weights from `repro` (JAX) into the port.

The port keeps `repro`'s flat layout exactly: the leaves of a parameter
dict in ``ravel_pytree`` order (sorted keys), each raveled in its JAX
layout (HWIO conv weights, (in, out) dense weights). So a row of a
(N, P) table of one package is the same model in the other, and weights
cross as numpy arrays with no reshuffling. An LM's stacked layer tree
becomes the port's per-layer state dict (`lm_params_from_jax`), and back
(`lm_params_to_jax`); so do the audio family's encoder and decoder
stacks. Takes and gives numpy, not JAX arrays: this module
imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.lm import hybrid_layout, hybrid_segments
from .models.moe import expert_block
from .sharding.rules import EXPERT_LEAVES


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """A `repro` parameter dict (as numpy arrays; a client axis may lead)
    -> the same dict of float32 tensors on ``device`` (default cuda)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device)
            for k, v in sorted(params.items())}


def flat_from_jax(flat: np.ndarray, device=None) -> torch.Tensor:
    """A `repro` flat table ((N, P) rows or one (P,) row) -> a float32
    tensor on ``device`` (default cuda), row for row."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.tensor(np.asarray(flat), dtype=torch.float32,
                        device=device)


#: per family, the layer leaves (dotted paths within a layer) that are
#: float32 in `repro` whatever ``cfg.dtype``: the Mamba2 block's scalars
#: (`repro.models.ssm.init_mamba_block`), the RG-LRU block's gate
#: weights and decay (`repro.models.rglru.init_rec_block`) and the MoE
#: router (`repro.models.moe.init_moe`)
FLOAT32_LEAVES = {"ssm": ("A_log", "D", "dt_bias"),
                  "hybrid": ("wa", "ba", "wx", "bx", "lam"),
                  "moe": ("moe.router",)}
#: the families whose trees `lm_params_from_jax` and `lm_params_to_jax`
#: carry: vlm's tree is the dense one, moe's stacks its layers as dense
#: does, with a "moe" subtree in place of the MLP, audio's stacks its
#: encoder and decoder layers apart
LM_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _stacks(cfg) -> Dict[str, int]:
    """The stacked subtrees of ``cfg``'s family and their rows: an audio
    tree's "enc_layers" (n_enc_layers) and "dec_layers" (n_layers),
    another's "layers" (n_layers); a hybrid tree's "segments" are laid
    out by `hybrid_layout`."""
    if cfg.family == "audio":
        return {"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


def _leaves(tree: Mapping, prefix: str = ""):
    """(dotted path, numpy array) of each leaf of a nested mapping."""
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            yield from _leaves(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", np.asarray(leaf)


def lm_params_from_jax(params: Mapping, cfg, device=None, mesh=None
                       ) -> Dict[str, torch.Tensor]:
    """A `repro` LM parameter tree of any family (`LM_FAMILIES`), as numpy
    arrays -> the state dict of the port's model
    (`repro_torch.models.build_model`: "tok_embed", "final_norm",
    ["lm_head"], "layers.{i}.ln1", "layers.{i}.attn.wq", ...,
    "layers.{i}.moe.router", ..., "layers.{i}.in_proj", ...; audio's
    "enc_layers.{i}.attn.wq", "dec_layers.{i}.cross_attn.wk",
    "enc_norm.w", ...), in ``cfg.dtype`` on ``device`` (default cuda),
    except the leaves that `repro` keeps in float32 whatever the dtype
    (`FLOAT32_LEAVES`). Dense, moe, vlm and SSM trees stack every leaf
    under ``"layers"`` over a leading n_layers axis, audio's under
    ``"enc_layers"`` and ``"dec_layers"``; a hybrid tree's leaf
    ``params["segments"][si][f"b{bi}"][name][g]`` becomes
    ``layers.{i}.{name}`` for the layer i at (si, g, bi)
    (`repro_torch.models.lm.hybrid_layout`). With a ``mesh`` (a
    `DecoderLM` built on it) each expert leaf becomes this rank's block
    by the expert rule of `repro_torch.sharding.rules` (E / M experts on
    the ``model`` axis, `repro_torch.models.moe.expert_block`); the other
    leaves stay whole, as `repro`'s ``shard_map`` sees them."""
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"lm_params_from_jax: the {cfg.family} "
                                  f"family is not ported")
    device = torch.device("cuda") if device is None else torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    float32 = FLOAT32_LEAVES.get(cfg.family, ())

    first, n_experts = (0, None) if mesh is None else \
        expert_block(cfg, mesh)

    def put(a, name=""):
        keep = name in float32
        if n_experts is not None and name.rsplit(".", 1)[-1] in \
                EXPERT_LEAVES:
            a = a[first:first + n_experts]
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=torch.float32 if keep else dtype)

    stacks = {"segments": None} if cfg.family == "hybrid" else _stacks(cfg)
    out = {name: put(a) for name, a in _leaves(
        {k: v for k, v in params.items() if k not in stacks})}
    if cfg.family == "hybrid":
        segs = params["segments"]
        for i, (si, g, bi, _) in enumerate(hybrid_layout(cfg)):
            for name, a in _leaves(segs[si][f"b{bi}"]):
                out[f"layers.{i}.{name}"] = put(a[g], name)
        return out
    for stack, n in stacks.items():
        for name, a in _leaves(params[stack]):
            if a.shape[0] != n:
                raise ValueError(f"lm_params_from_jax: {stack}.{name} has "
                                 f"{a.shape[0]} rows for {n} layers")
            for i in range(n):
                out[f"{stack}.{i}.{name}"] = put(a[i], name)
    return out


def lm_params_to_jax(state: Mapping[str, torch.Tensor], cfg
                     ) -> Dict[str, object]:
    """The inverse of `lm_params_from_jax`: a state dict of the port's
    model -> `repro`'s LM parameter tree, every leaf a float32 numpy
    array on the host: "tok_embed", "final_norm", ["lm_head"], and
    ``"layers"`` (dense, moe, vlm, SSM) holding each leaf stacked over
    the layers, ``"enc_layers"`` and ``"dec_layers"`` with the "enc_norm"
    and "dec_norm" subtrees (audio), or ``"segments"`` (hybrid) holding
    ``[si][f"b{bi}"]`` leaves stacked over the groups. Saved with
    `repro_torch.checkpoint.save_pytree`, it is a file that
    `repro.checkpoint.load_pytree` reads into `repro`'s tree."""
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(f"lm_params_to_jax: the {cfg.family} "
                                  f"family is not ported")

    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def nest(leaves: Dict[str, np.ndarray]) -> Dict:
        tree: Dict = {}
        for name, a in leaves.items():
            *path, last = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = a
        return tree

    stacks = _stacks(cfg)
    per_layer: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {
        stack: {} for stack in stacks}
    top = {}
    for k, v in state.items():
        stack, _, rest = k.partition(".")
        if stack in stacks:
            i, name = rest.split(".", 1)
            per_layer[stack].setdefault(int(i), {})[name] = v
        else:
            top[k] = arr(v)
    out: Dict[str, object] = nest(top)
    if cfg.family == "hybrid":
        layout = hybrid_layout(cfg)
        segs = [dict() for _ in hybrid_segments(cfg)]
        for i, (si, g, bi, _) in enumerate(layout):
            block = segs[si].setdefault(f"b{bi}", {})
            for name, v in per_layer["layers"][i].items():
                block.setdefault(name, []).append(arr(v))
        out["segments"] = [{b: nest({n: np.stack(rows)
                                     for n, rows in block.items()})
                            for b, block in seg.items()} for seg in segs]
        return out
    for stack, n in stacks.items():
        rows = per_layer[stack]
        if sorted(rows) != list(range(n)):
            raise ValueError(f"lm_params_to_jax: {stack} {sorted(rows)} "
                             f"for {n} layers")
        out[stack] = nest({name: np.stack([arr(rows[i][name])
                                           for i in range(n)])
                           for name in rows[0]})
    return out
