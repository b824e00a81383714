"""The shape-and-memory dry run: one rank of `repro`'s production meshes,
every (architecture x input shape), on "meta" tensors (port of
`repro.launch.dryrun`: ``model_flops_estimate``, ``_zero1``, ``run_one``,
``main``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \\
      [--shape S] [--mesh single|multi] [--out build/dryrun]

`repro` lowers each step onto (16, 16) ("data", "model") or (2, 16, 16)
("pod", "data", "model") forced host devices and reads XLA's memory and
cost analyses. Here one rank runs the port's own step code (the train
step of `launch.steps.make_train_step`, the prefill, one decode step) on
"meta" tensors, as rank 0 of `launch.mesh.make_production_mesh`, and
`roofline.count_step` counts what it does. Nothing is launched and
nothing is allocated.

What one rank holds (its resident bytes) is read from
`sharding.rules`: the `local_block` of every weight under `param_specs`
(with AdamW's two moments, at ``opt_dtype``, when training), the
caches' blocks under `cache_specs` (whole rings for the rank's rows,
`repro`'s default, or under ``cache_seq_shard`` the flash-decoding
rings, ``shard_seq_model``) and the inputs' blocks under
`launch.specs.batch_spec_tree`, which must agree with
`rules.batch_specs`. Under two pods `add_client_axis` gives one DPFL
client a pod, and the train step ends with the DPFL mix of every weight
over "pod" (`launch.steps.make_dpfl_mix` on a `ShapeMesh` with a pod
axis: the rank's blocks exchanged, K1's (2, 2) @ (2, block) in fp32,
cast back), unless ``mix`` is false; the (2, 2) mix matrix is an
input.

The step a rank runs is a rank-local model: the config with each
dimension that `param_specs` splits on ``model`` divided by M (query
heads, whole KV heads where they divide, d_ff, the padded vocab, the
recurrent width), built on a ("data", "model") `ShapeMesh` whose model
axis holds E / M experts and the rings' C / M slots; its batch is the
rank's rows (the whole batch on every data rank where `repro` does not
split it). Each rank-local weight must be the `local_block` of its whole
weight, but for two documented reads: where KV heads do not divide M
the rank holds them whole and reads the KV heads of its query heads;
the recurrent gates' (W, W) weights, split on their columns, are read
as the rank's (W / M, W / M) block. The tensor-parallel all-reduces the
port has no code for are modelled from the layer shapes and named in
the record. The step runs at the config's dtype (bf16 for every
architecture, `repro`'s default), its inputs too, and its FLOPs are set
against the card's rate for that dtype; every time is modelled from the
card's data-sheet rates.

``opts`` are `repro`'s ``build_lowered`` options (`OPTIONS`, with
`repro`'s defaults), each applied as there: ``fedavg_global`` (one
global model over both pods, the batch on ("pod", "data")),
``cache_seq_shard``, ``parallel_block``, ``vocab_pad``, ``remat``,
``loss_chunks``, ``lr``, ``opt_dtype`` and ``grad_dtype``, ``zero1``,
``mix``. A key not among them ends the combo as "error".

Each combo's record goes to ``--out`` as JSON: ``status`` "ok",
"skipped" (whisper-medium x long_500k, as in `repro`), "refused" (a
kernel's or a model's check raised a `kernels.meta.Refusal`, whose text
is recorded: the card would refuse the step too) or "error" (anything
else, the dry run's own limits and faults included; a failure).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from ..configs import ARCH_IDS
from ..configs.shapes import SHAPES, get_shape
from ..kernels import meta as kmeta
from ..models import build_model
from ..optim import adamw
from ..roofline import HW, analyze_count, breakdown, count_step
from ..sharding import collectives as coll
from ..sharding.rules import (add_client_axis, batch_specs, cache_specs,
                              local_block, param_specs)
from .mesh import make_production_mesh
from .specs import batch_spec_tree, input_specs, resolve_arch_for_shape
from .steps import (make_decode_step, make_dpfl_mix, make_prefill_step,
                    make_train_step)

#: where the records go (git-ignored with build/)
OUT = os.path.join("build", "dryrun")


def model_flops_estimate(shapes: Dict[str, Tuple[int, ...]], cfg,
                         shape) -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (inference) over the weights'
    ``shapes`` ({name: shape}); an MoE model's N counts its experts'
    weights (names with "we_") at topk / n_experts (`repro`'s)."""
    total = 0
    expert = 0
    for name, shp in shapes.items():
        n = math.prod(shp)
        total += n
        if "we_" in name.rsplit(".", 1)[-1]:
            expert += n
    n_active = total - expert
    if cfg.n_experts:
        n_active += expert * cfg.topk / cfg.n_experts
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:
        tokens = shape.global_batch  # one new token per sequence
        factor = 2.0
    return factor * n_active * tokens


def _zero1(pspecs, shapes, client_axis, data_size: int = 16):
    """The optimizer moments' specs under ZeRO-1: each leaf's spec with
    ``data`` on its largest dimension that is whole and divides by
    ``data_size`` (`repro`'s ``_zero1``)."""
    out = {}
    for name, spec in pspecs.items():
        shp = shapes[name]
        dims = list(spec) + [None] * (len(shp) - len(spec))
        best, best_d = -1, 0
        for i in range(1 if client_axis else 0, len(shp)):
            if dims[i] is None and shp[i] % data_size == 0 \
                    and shp[i] > best_d:
                best, best_d = i, shp[i]
        if best >= 0:
            dims[best] = "data"
        out[name] = tuple(dims)
    return out


def _block_bytes(shape, dtype, spec, mesh) -> int:
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    b = local_block(t, spec, mesh)
    return b.numel() * b.element_size()


def local_config(cfg, M: int):
    """(the config of one rank's slice over a model axis of M, the KV
    heads a rank reads where they stay whole or None): `param_specs`'
    splits divided out (`repro_torch.sharding.rules._param_rule`)."""
    kw = {}
    kv_read = None
    if cfg.n_heads:
        kw["head_dim"] = cfg.resolved_head_dim
        if cfg.n_heads % M:
            raise ValueError(f"{cfg.n_heads} query heads do not split over "
                             f"a model axis of {M}")
        hq = cfg.n_heads // M
        kw["n_heads"] = hq
        if cfg.n_kv_heads % M == 0:
            kw["n_kv_heads"] = cfg.n_kv_heads // M
        else:
            rep = cfg.n_heads // cfg.n_kv_heads
            kv_read = max(1, hq // rep)
            kw["n_kv_heads"] = kv_read
    if cfg.d_ff and cfg.d_ff % M == 0:
        kw["d_ff"] = cfg.d_ff // M
    if cfg.lru_width and cfg.lru_width % M == 0:
        kw["lru_width"] = cfg.lru_width // M
    return dataclasses.replace(cfg, **kw), kv_read


#: rank-local weights that are not their `local_block`, by design (module
#: docstring): the whole KV projections' read heads, the gates' diagonal
#: block
_READS = {"wk": "kv", "wv": "kv", "wa": "gate", "wx": "gate"}


def check_local_leaves(local_sd, global_sd, pspecs, mesh, kv_read,
                       family) -> list:
    """Hold every rank-local weight to the `local_block` of its whole
    weight under ``pspecs`` (the dry run's reading of `param_specs`);
    returns the documented reads (`_READS`) as notes, and raises
    ``AssertionError`` on any other difference."""
    reads = {}
    for name, t in local_sd.items():
        want = tuple(local_block(global_sd[name], pspecs[name], mesh).shape)
        got = tuple(t.shape)
        if got == want:
            continue
        kind = _READS.get(name.rsplit(".", 1)[-1])
        if (kind == "kv" and kv_read) or (kind == "gate" and
                                          family == "hybrid"):
            leaf = name.split(".", 2)[-1] if name.startswith("layers.") \
                else name
            reads.setdefault((leaf, want, got), []).append(name)
            continue
        raise AssertionError(f"rank-local weight {name} is {got}, its "
                             f"local_block under {pspecs[name]} {want}")
    return [f"{leaf} ({len(names)} layers): holds {want}, reads {got}"
            for (leaf, want, got), names in reads.items()]


def modelled_collectives(cfg, kind: str, rows: int, seq: int, M: int,
                         D: int, n_local_params: int, has_mesh: bool,
                         grad_bytes: int = 4):
    """{what: bytes a rank receives} of the exchanges a tensor-parallel
    step needs that the port has no code for, from the layer shapes: one
    all-reduce of (rows, seq, d) after each row-parallel product (the
    attention's output projection, the dense MLP's down projection, the
    recurrent block's output) and after the vocab-parallel embedding;
    the loss's max and sum over the vocab; the last position's logits
    gathered at serving. Training doubles the products' all-reduces for
    the backward and adds the recompute's (remat "full"); a model with
    no mesh (the audio family) also all-reduces its gradients over the
    data ranks. Activations and logits are in the config's dtype, the
    loss's max and sum fp32, gradients ``grad_bytes`` an element. Each
    all-reduce of n bytes over a group of G receives (G - 1) n
    (`analysis.commaudit.wire_bytes`)."""
    if M == 1:
        return {}
    el = getattr(torch, cfg.dtype).itemsize
    act = rows * seq * cfg.d_model * el
    if cfg.family == "audio":
        products = 2 * (cfg.n_layers + cfg.n_enc_layers) + cfg.n_layers
    elif cfg.family == "ssm":
        products = 0
    elif cfg.family == "moe":
        products = cfg.n_layers
    else:
        products = 2 * cfg.n_layers
    passes = 3 if kind == "train" else 1
    out = {"row-parallel all-reduces": (M - 1) * act * products * passes,
           "vocab-parallel embedding": (M - 1) * act * (
               2 if kind == "train" else 1)}
    if kind == "train":
        out["loss over the vocab (max, sum)"] = (M - 1) * 2 * rows * seq * 4
        if not has_mesh and D > 1:
            out["data-parallel gradients"] = (D - 1) * n_local_params * \
                grad_bytes
    else:
        out["logits gathered"] = (M - 1) * rows * cfg.padded_vocab(2048) \
            // M * el
    return out


#: `repro`'s ``build_lowered`` options and their defaults
OPTIONS = {"fedavg_global": False, "cache_seq_shard": False,
           "parallel_block": False, "vocab_pad": 2048, "remat": "full",
           "loss_chunks": 8, "lr": 3e-4, "opt_dtype": "float32",
           "grad_dtype": None, "zero1": False, "mix": True}



def _inputs(specs: dict, rows: Optional[int]):
    """The step's inputs: ``specs``' tensors, their batch cut to ``rows``
    where given (a model with no mesh takes the rank's rows)."""
    if rows is None:
        return dict(specs)
    return {k: v if v.dim() == 0 else v[:rows] for k, v in specs.items()}


def build_step(arch: str, shape_name: str, multi_pod: bool, opts=None):
    """Everything one rank of the (arch, shape, mesh) combo holds and runs:
    (step, meta), ``step()`` the rank's step on "meta" tensors and
    ``meta`` the record so far (resident bytes, specs read, notes, the
    options applied)."""
    given = dict(opts or {})
    unknown = sorted(set(given) - set(OPTIONS))
    if unknown:     # not a Refusal: the record says "error"
        raise ValueError(f"unknown dry-run option(s) {unknown}: the options "
                         f"are {sorted(OPTIONS)}")
    opts = {**OPTIONS, **given}
    cfg = resolve_arch_for_shape(arch, shape_name)
    dtype = getattr(torch, cfg.dtype)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = coll.mesh_axis_sizes(mesh)
    M = sizes["model"]
    B = shape.global_batch
    n_clients = 2 if (multi_pod and B >= 2) else 1
    if opts["fedavg_global"]:
        # one global model data-parallel over both pods (`repro`'s
        # comparator of DPFL's pod-local training and mix)
        n_clients = 1
    client_axis = "pod" if n_clients > 1 else None
    data_axes = ("data",)
    if multi_pod and n_clients == 1 and B >= 32:
        data_axes = ("pod", "data")
    sharded = B >= 16
    D = math.prod(sizes[a] for a in data_axes) if sharded else 1
    B_client = B // n_clients
    vp = opts["vocab_pad"]
    build_kw = dict(remat=opts["remat"], loss_chunks=opts["loss_chunks"])
    # the options `repro` passes to a DecoderLM (not to the audio family)
    lm_kw = {} if cfg.family == "audio" else dict(
        moe_data_axes=("data",) if sharded else (),
        decode_cache_seqshard=bool(opts["cache_seq_shard"]),
        parallel_block=bool(opts["parallel_block"]))

    whole = build_model(cfg, device="meta", vocab_pad_multiple=vp,
                        **build_kw, **lm_kw)
    global_sd = whole.state_dict()
    shapes = {k: tuple(v.shape) for k, v in global_sd.items()}
    pspecs = param_specs(whole, cfg, sizes)
    mflops = model_flops_estimate(shapes, cfg, shape)

    def stacked(name):
        return ((n_clients,) if n_clients > 1 else ()) + shapes[name]
    wspecs = add_client_axis(pspecs) if n_clients > 1 else pspecs
    resident = {"weights": sum(
        _block_bytes(stacked(k), global_sd[k].dtype, wspecs[k], mesh)
        for k in shapes)}
    opt_dtype = getattr(torch, opts["opt_dtype"])
    grad_dtype = getattr(torch, opts["grad_dtype"]) \
        if opts["grad_dtype"] else None
    if shape.kind == "train":
        mspecs = (_zero1(wspecs, {k: stacked(k) for k in shapes},
                         client_axis) if opts["zero1"] else wspecs)
        resident["adamw moments"] = 2 * sum(
            _block_bytes(stacked(k), opt_dtype, mspecs[k], mesh)
            for k in shapes)

    inputs = input_specs(cfg, shape, per_client=n_clients, dtype=dtype)
    ispecs = batch_spec_tree(cfg, shape, data_axes=data_axes,
                             client_axis=client_axis)
    if shape.kind != "decode":
        bs = batch_specs(cfg, shape.kind, B, data_axes)
        if n_clients > 1:
            bs = add_client_axis(bs)
        bad = {k: (bs[k], ispecs[k]) for k in bs if bs[k] != ispecs[k]}
        if bad:
            raise AssertionError(f"rules.batch_specs and batch_spec_tree "
                                 f"differ: {bad}")
    resident["inputs"] = sum(_block_bytes(inputs[k].shape, inputs[k].dtype,
                                          ispecs[k], mesh) for k in inputs)
    mixes = shape.kind == "train" and n_clients > 1 and bool(opts["mix"])
    if mixes:
        # the (2, 2) mix matrix, an input replicated on every rank
        resident["inputs"] += n_clients * n_clients * 4
    if shape.kind == "decode":
        caches = whole.init_cache(B_client, shape.seq_len)
        cspecs = cache_specs(whole, cfg, B_client, shape.seq_len,
                             shard_seq=(B == 1), shard_seq_model=bool(
                                 opts["cache_seq_shard"]))
        if n_clients > 1:
            cspecs = add_client_axis(cspecs)
        resident["caches"] = sum(
            _block_bytes(((n_clients,) if n_clients > 1 else ())
                         + tuple(leaf.shape), leaf.dtype, spec[name], mesh)
            for layer, spec in zip(caches, cspecs)
            for name, leaf in layer.items())
        del caches

    # the rank-local model and its step
    lcfg, kv_read = local_config(cfg, M)
    lcfg = lcfg.replace(vocab_size=cfg.padded_vocab(vp) // M)
    lmesh = coll.ShapeMesh((D, M), ("data", "model"))
    local = build_model(lcfg, device="meta", vocab_pad_multiple=1,
                        mesh=lmesh, **build_kw, **lm_kw)
    has_mesh = getattr(local, "mesh", None) is not None
    notes = check_local_leaves(local.state_dict(), global_sd, pspecs, mesh,
                               kv_read, cfg.family)
    if kv_read:
        notes.append(f"the KV projections stay whole ({cfg.n_kv_heads} "
                     f"heads do not split over {M}): a rank reads the "
                     f"{kv_read} KV head(s) of its {lcfg.n_heads} query "
                     f"head(s)")
    if shape.kind == "decode" and cfg.n_heads and \
            not opts["cache_seq_shard"]:
        notes.append(f"the rings are whole on every model rank (all "
                     f"{cfg.n_kv_heads} KV heads, {shape.seq_len} slots, "
                     f"the rank's rows): its step attends its "
                     f"{lcfg.n_heads} query head(s) over the "
                     f"{lcfg.n_kv_heads} KV head(s) they read, with no "
                     f"flash-decoding collective")
    if cfg.family == "audio" and (opts["parallel_block"]
                                  or opts["cache_seq_shard"]):
        notes.append("parallel_block and cache_seq_shard reach no "
                     "audio model (as in repro); cache_seq_shard still "
                     "lays out the resident rings")
    # a model on a mesh takes the client's whole batch and runs its rows;
    # the audio model (no mesh) takes the rank's rows
    rows = B_client // D
    one = {k: (v[0] if n_clients > 1 and v.dim() else v)
           for k, v in inputs.items()}
    batch = _inputs(one, None if has_mesh else rows)
    n_local_params = sum(v.numel() for v in local.state_dict().values())
    if shape.kind == "train":
        optimizer = adamw(opts["lr"], state_dtype=opt_dtype)
        opt_state = optimizer.init(dict(local.named_parameters()))
        train = make_train_step(local, optimizer, grad_dtype=grad_dtype)
        params = dict(local.named_parameters())
        mix = None
        if mixes:
            # the client of this pod mixes with the other pod's: the rank
            # (pod 0) exchanges its blocks over "pod"
            pmesh = coll.ShapeMesh(tuple(sizes[a] for a in
                                         ("pod", "data", "model")),
                                   ("pod", "data", "model"))
            mix = make_dpfl_mix(torch.empty(
                (n_clients, n_clients), dtype=torch.float32, device="meta"),
                mesh=pmesh)

        def step():
            state, loss = train(opt_state, batch)
            if mix is not None:
                with torch.no_grad():
                    for k, w in mix(params).items():
                        params[k].copy_(w)
            return state, loss
    elif shape.kind == "prefill":
        prefill = make_prefill_step(local)

        def step():
            with torch.inference_mode():
                return prefill(batch)
    else:
        decode = make_decode_step(local)
        caches = local.init_cache(B_client if has_mesh else rows,
                                  shape.seq_len)
        token = one["token"][:rows].long()
        pos = shape.seq_len - 1

        def step():
            with torch.inference_mode():
                if cfg.family == "audio":
                    return decode(batch["enc_out"], caches, token, pos)
                return decode(caches, token, pos)
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": mesh.size(), "n_clients": n_clients,
        "window": getattr(whole, "window", None), "model_flops": mflops,
        "dtype": cfg.dtype, "opts": given, "options": opts,
        "dpfl_mix": mixes,
        "rank_rows": rows, "data_shards": D, "model_shards": M,
        "resident_bytes": resident,
        "local_config": {k: getattr(lcfg, k) for k in (
            "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
            "lru_width", "n_experts")},
        "local_experts": (cfg.n_experts // M if cfg.n_experts else 0),
        "notes": notes,
        "modelled_collectives": modelled_collectives(
            cfg, shape.kind, rows, 1 if shape.kind == "decode"
            else shape.seq_len, M, D, n_local_params, has_mesh,
            grad_bytes=(grad_dtype or dtype).itemsize),
    }
    return step, meta


def _error(rec: dict, e: Exception) -> None:
    rec["status"] = "error"
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-4000:]
    print(f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}] ERROR: {e}")


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Optional[str] = OUT, opts=None, tag: str = "") -> dict:
    """One combo's record (module docstring), written to ``out_dir`` as
    ``<arch>_<shape>_<mesh>[_<tag>].json`` unless it is None."""
    t0 = time.time()
    hw = HW()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single", "tag": tag}
    try:
        step, meta = build_step(arch, shape_name, multi_pod, opts)
        count = count_step(step, hw=hw)
        rec.update(meta)
        modelled = sum(meta["modelled_collectives"].values())
        rec.update(analyze_count(count, hw, meta["dtype"], modelled))
        resident = sum(meta["resident_bytes"].values())
        rec["memory"] = {
            "resident_bytes": resident, "step_peak_bytes": count.peak_bytes,
            "peak_bytes": resident + count.peak_bytes,
            "card_bytes": hw.card.memory,
            "fits": resident + count.peak_bytes <= hw.card.memory}
        rec["model_flops_ratio"] = meta["model_flops"] / max(
            count.flops * meta["chips"], 1.0)
        top_bytes, top_flops = breakdown(count, top=8)
        rec["breakdown"] = {"bytes": top_bytes, "flops": top_flops}
        rec["count_s"] = time.time() - t0
        rec["status"] = "ok"
        print(f"[{arch} x {shape_name} x {rec['mesh']}] peak "
              f"{rec['memory']['peak_bytes']} bytes a rank (resident "
              f"{resident}), flops {count.flops}, hbm {count.hbm_bytes}")
    except kmeta.Refusal as e:
        rec["status"] = "refused"
        rec["reason"] = f"{type(e).__name__}: {e}"
        print(f"[{arch} x {shape_name} x {rec['mesh']}] REFUSED: {e}")
    except NotImplementedError as e:
        if "skipped by design" not in str(e):
            _error(rec, e)
        else:
            rec["status"] = "skipped"
            rec["reason"] = str(e)
            print(f"[{arch} x {shape_name}] SKIPPED: {e}")
    except Exception as e:  # noqa: BLE001
        _error(rec, e)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(
            out_dir, f"{arch}_{shape_name}_{rec['mesh']}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--opts", default="{}",
                    help="JSON dict of repro's build options: "
                         + ", ".join(sorted(OPTIONS)))
    args = ap.parse_args(argv)
    opts = json.loads(args.opts)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    errors = 0
    for a in archs:
        for s in shapes:
            rec = run_one(a, s, args.mesh == "multi", args.out, opts,
                          args.tag)
            st = rec.get("status")
            r = rec.get("roofline", {})
            errors += st == "error"
            print(f"== {a} x {s} x {args.mesh}: {st}"
                  + (f" dominant={r.get('dominant')}" if st == "ok" else ""))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
