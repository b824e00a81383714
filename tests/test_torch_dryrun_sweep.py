"""The dry run's combos on the CPU (`repro_torch.launch.dryrun`): one
(arch x shape x mesh) per model family and step kind, the smallest arch
of each family, runs to "ok" with every part of its record (the whole
80-combo sweep, `python -m repro_torch.launch.dryrun --mesh single` and
``--mesh multi``, takes minutes and is run by hand: PERF.md). The
whisper x long_500k combo is "skipped", as in `repro`; the CLI writes
its records; only a kernel's or a model's refusal is "refused";
examples/multipod_dryrun_torch.py runs one combo on both meshes.
"""
from __future__ import annotations

import json
import math
import runpy
from pathlib import Path

import test_torch_common  # noqa: F401  (the jax patch; first)
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ops import flash_attention
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
#: the smallest arch of each family
FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-370m", "hybrid": "recurrentgemma-9b",
            "vlm": "internvl2-2b", "audio": "whisper-medium"}
#: one shape of each step kind, on one mesh or the other
KINDS = {"train": ("train_4k", False), "prefill": ("prefill_32k", True),
         "decode": ("decode_32k", False)}
#: the kernels each family's step reaches (shape-only calls)
KERNELS = {"dense": {"flash_attention"}, "moe": {"flash_attention"},
           "vlm": {"flash_attention"}, "audio": {"flash_attention"},
           "ssm": {"ssd"}, "hybrid": {"flash_attention", "rglru_scan"}}
BACKWARDS = {"flash_attention": "flash_attention_bwd", "ssd": "ssd_bwd",
             "rglru_scan": "rglru_scan_bwd"}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_combo_per_family_and_kind_runs_ok(family, kind):
    """The combo's record: status "ok", the rank's resident bytes by part
    (weights, AdamW's moments when training, the caches when decoding,
    the inputs), the step's peak over them, flops and HBM bytes with the
    kernels' work in them, the roofline's three terms and its dominant
    one, the model flops, the modelled collectives named; the prefill and
    the train step reach the family's kernels (the backwards too when
    training), decode none of them but the audio family's cross-attention
    (K4 at one query row)."""
    shape, multi = KINDS[kind]
    rec = dryrun.run_one(FAMILIES[family], shape, multi, out_dir=None)
    assert rec["status"] == "ok", rec.get("error") or rec.get("reason")
    parts = set(rec["resident_bytes"])
    assert {"weights", "inputs"} <= parts
    assert ("adamw moments" in parts) == (kind == "train")
    assert ("caches" in parts) == (kind == "decode")
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["resident_bytes"] + \
        mem["step_peak_bytes"] > mem["resident_bytes"] > 0
    assert mem["fits"] == (mem["peak_bytes"] <= mem["card_bytes"])
    dev = rec["per_device"]
    assert dev["flops"] > dev["kernel_flops"] >= 0
    assert dev["hbm_bytes"] > dev["kernel_bytes"] >= 0
    rl = rec["roofline"]
    assert rl["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rl["step_time_lower_bound_s"] == rl[rl["dominant"]] > 0
    assert rec["model_flops"] > 0 and rec["modelled_collectives"]
    kernels = set(dev["kernel_calls"])
    want = set() if kind == "decode" else set(KERNELS[family])
    if kind == "decode" and family == "audio":
        want = {"flash_attention"}      # the cross-attention, one row
    if kind == "train":
        want |= {BACKWARDS[k] for k in want}
    assert kernels == want
    assert rec["chips"] == (512 if multi else 256)
    assert rec["breakdown"]["flops"] and rec["breakdown"]["bytes"]


def test_cli_writes_records_and_skips_whisper_at_500k(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes one JSON record a
    combo; whisper-medium x long_500k is "skipped" with `repro`'s reason,
    and an "ok" combo exits 0."""
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "whisper-medium", "--shape", "long_500k",
                        "--mesh", "multi", "--out", str(out)]) == 0
    rec = json.loads((out / "whisper-medium_long_500k_multi.json").read_text())
    assert rec["status"] == "skipped" and "by design" in rec["reason"]
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rec = json.loads((out / "qwen3-0.6b_long_500k_single.json").read_text())
    assert rec["status"] == "ok" and rec["window"] == 4096


def _head_dim_24():
    q = torch.empty((1, 8, 2, 24), device="meta")
    flash_attention(q, q, q)


def _planted_type_error():
    flash_attention(torch.empty((1, 8, 2, 16), device="meta"), bogus=1)


def _query_heads_over_5():
    dryrun.local_config(get_config("qwen3-0.6b"), 5)


@pytest.mark.parametrize("step, status", [
    (_head_dim_24, "refused"), (_planted_type_error, "error"),
    (_query_heads_over_5, "error")])
def test_only_a_kernels_or_models_refusal_is_refused(monkeypatch, step,
                                                     status):
    """A combo is "refused" only where a kernel's or a model's check
    raises a `kernels.meta.Refusal` (K4 at head_dim 24: the card's own
    text is the reason); a planted TypeError from a wrong call and the
    dry run's own limit (query heads that do not split over the model
    axis) are "error", and the CLI fails on them."""
    def build_step(*a, **kw):
        return step, {}

    monkeypatch.setattr(dryrun, "build_step", build_step)
    rec = dryrun.run_one("qwen3-0.6b", "train_4k", False, out_dir=None)
    assert rec["status"] == status
    if status == "refused":
        assert "head_dim 24 is not a multiple of 16" in rec["reason"]
    else:
        assert "error" in rec and "traceback" in rec
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                        "--out", ""]) == (status == "error")


def test_multipod_example_runs_both_meshes(capsys):
    mod = runpy.run_path(str(ROOT / "examples" / "multipod_dryrun_torch.py"))
    recs = mod["main"](["--arch", "mamba2-370m", "--shape", "decode_32k"])
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert [r["chips"] for r in recs] == [256, 512]
    out = capsys.readouterr().out
    assert "16x16 (data,model)" in out and "2x16x16 (pod,data,model)" in out


# ------------------------------------------------------------ the options

_RECORDS = {}


def _record(arch="qwen3-0.6b", shape="train_4k", multi=False, **opts):
    """One combo's record (cached: each is a few seconds on the CPU)."""
    key = (arch, shape, multi, tuple(sorted(opts.items())))
    if key not in _RECORDS:
        rec = dryrun.run_one(arch, shape, multi, out_dir=None, opts=opts)
        assert rec["status"] == "ok", rec.get("error") or rec.get("reason")
        _RECORDS[key] = rec
    return _RECORDS[key]


def test_options_are_repros_build_lowered_options():
    """`dryrun.OPTIONS` holds every option `repro`'s ``build_lowered``
    reads (``opts.get("...")`` in its source), with its default, and no
    other; the config's dtype is the step's (bf16, `repro`'s default)."""
    import re

    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    body = src[src.index("def build_lowered"):src.index("def _zero1")]
    # opts.get("name") or opts.get("name", default), the default a literal
    # or one call of a literal (jnp.dtype(opts.get("opt_dtype", ...)))
    read = dict(re.findall(
        r'opts\.get\(\s*"(\w+)"(?:,\s*([^()]+|[^,]*\([^)]*\)))?\)', body))
    assert set(read) == set(dryrun.OPTIONS)
    for name, default in read.items():
        if not default:     # read as a flag: absent is off
            assert not dryrun.OPTIONS[name], name
            continue
        want = eval(default)   # noqa: S307  (a literal of repro's source)
        assert dryrun.OPTIONS[name] == want, name
    rec = _record()
    assert rec["dtype"] == "bfloat16" and rec["options"] == dryrun.OPTIONS


def test_an_unknown_option_ends_the_combo_as_error():
    rec = dryrun.run_one("qwen3-0.6b", "train_4k", False, out_dir=None,
                         opts={"parallel_blocks": True})
    assert rec["status"] == "error" and "unknown" in rec["error"]
    assert "parallel_blocks" in rec["error"]


def _bytes(rec, part):
    return rec["resident_bytes"][part]


OPTION_CASES = {
    # option: (arch, shape, multi, value)
    "fedavg_global": ("qwen3-0.6b", "train_4k", True, True),
    "cache_seq_shard": ("qwen3-0.6b", "decode_32k", False, True),
    "parallel_block": ("qwen3-0.6b", "train_4k", False, True),
    "vocab_pad": ("qwen3-0.6b", "train_4k", False, 1),
    "remat": ("qwen3-0.6b", "train_4k", False, "none"),
    "loss_chunks": ("qwen3-0.6b", "train_4k", False, 1),
    "lr": ("qwen3-0.6b", "train_4k", False, 1e-3),
    "opt_dtype": ("qwen3-0.6b", "train_4k", False, "bfloat16"),
    "grad_dtype": ("whisper-medium", "train_4k", False, "float32"),
    "zero1": ("qwen3-0.6b", "train_4k", False, True),
    "mix": ("qwen3-0.6b", "train_4k", True, False),
}


@pytest.mark.parametrize("option", list(OPTION_CASES))
def test_each_option_changes_the_record_it_should(option):
    """Each of `repro`'s options is applied, not only recorded: the
    record with it differs from the default one where the option acts,
    and names it under "options"."""
    arch, shape, multi, value = OPTION_CASES[option]
    base = _record(arch, shape, multi)
    rec = _record(arch, shape, multi, **{option: value})
    assert rec["options"][option] == value and rec["opts"] == {option: value}
    dev, bdev = rec["per_device"], base["per_device"]
    peak, bpeak = (r["memory"]["step_peak_bytes"] for r in (rec, base))
    if option == "fedavg_global":
        assert (base["n_clients"], base["data_shards"]) == (2, 16)
        assert (rec["n_clients"], rec["data_shards"]) == (1, 32)
        assert base["dpfl_mix"] and not rec["dpfl_mix"]
    elif option == "cache_seq_shard":
        assert _bytes(base, "caches") == 16 * _bytes(rec, "caches")
        assert bdev["collective_calls"] == 0 < dev["collective_calls"]
    elif option == "parallel_block":
        # one RMS norm and one residual sum a layer fewer (no products
        # fewer); the weights are the same (ln2 kept, unread)
        assert dev["hbm_bytes"] < bdev["hbm_bytes"]
        assert _bytes(rec, "weights") == _bytes(base, "weights")
    elif option == "vocab_pad":
        assert _bytes(rec, "weights") < _bytes(base, "weights")
    elif option in ("remat", "loss_chunks"):
        assert peak > bpeak
    elif option == "lr":
        assert (peak, dev["flops"]) == (bpeak, bdev["flops"])
    elif option == "opt_dtype":
        assert 2 * _bytes(rec, "adamw moments") == \
            _bytes(base, "adamw moments")
    elif option == "grad_dtype":
        key = "data-parallel gradients"
        assert rec["modelled_collectives"][key] == \
            2 * base["modelled_collectives"][key]
    elif option == "zero1":
        assert _bytes(rec, "adamw moments") < _bytes(base, "adamw moments")
    else:
        assert bdev["kernel_calls"]["graph_mix"] > 0
        assert "graph_mix" not in dev["kernel_calls"]


@pytest.mark.parametrize("mix", [True, False])
def test_two_pod_train_step_ends_with_the_pod_mix(mix):
    """Under (2, 16, 16) the train step ends with `repro`'s
    ``make_dpfl_mix`` over "pod": every weight's block of the rank
    exchanged with the other pod's (an all-gather over a group of 2) and
    K1's shape-only (2, 2) @ (2, block) in fp32, cast back to the
    weight's dtype; with ``mix`` false neither."""
    from repro_torch.roofline import count_step

    step, meta = dryrun.build_step("qwen3-0.6b", "train_4k", True,
                                   {"mix": mix})
    count = count_step(step)
    gathers = [r for r in count.records if r.op == "all_gather"]
    mixes = [k for k in count.kernels if k.name == "graph_mix"]
    assert meta["dpfl_mix"] == mix
    if not mix:
        assert not gathers and not mixes
        return
    assert len(gathers) == len(mixes) > 300
    assert all(r.group_size == 2 and r.dtype == "torch.float32"
               and r.shape[0] == 1 for r in gathers)
    assert all(k.dtype == "float32" for k in mixes)
    # K1's work: A (2, 2) and W (2, P) read, out (2, P) written, fp32
    for r, k in zip(gathers, mixes):
        P = r.shape[1]
        assert k.flops == 2 * 2 * 2 * P
        assert k.nbytes == 4 * 2 * 2 + 4 * (2 * P + 2 * P)


@pytest.mark.parametrize("arch, multi", [("qwen3-0.6b", False),
                                         ("qwen3-0.6b", True),
                                         ("recurrentgemma-9b", False),
                                         ("whisper-medium", False)])
def test_default_decode_caches_are_repros_cache_spec_blocks(arch, multi):
    """Without ``cache_seq_shard`` a rank's resident cache bytes are the
    blocks of `repro`'s own ``cache_specs(shard_seq_model=False)``: whole
    rings of the rank's rows (under two pods, one client a pod), every KV
    head, bf16 with int32 positions."""
    import jax
    import numpy as np
    from repro.configs.shapes import get_shape as jshape
    from repro.launch.specs import resolve_arch_for_shape as jresolve
    from repro.models import build_model as jbuild
    from repro.sharding.rules import cache_specs as jcache

    rec = _record(arch, "decode_32k", multi)
    shape = jshape("decode_32k")
    cfg = jresolve(arch, "decode_32k")
    clients = 2 if multi else 1
    B, C = shape.global_batch // clients, shape.seq_len
    model = jbuild(cfg)
    leaves = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: model.init_cache(B, C)))
    specs = jax.tree_util.tree_leaves(
        jcache(model, cfg, B, C, shard_seq=False, shard_seq_model=False),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    sizes = {"pod": 2, "data": 16, "model": 16}
    total = 0
    for leaf, spec in zip(leaves, specs, strict=True):
        dims = list(leaf.shape)
        for i, axes in enumerate(tuple(spec)):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                assert dims[i] % sizes[a] == 0
                dims[i] //= sizes[a]
        # two pods: `add_client_axis` stacks the clients on "pod"
        total += clients * math.prod(dims) // clients * \
            np.dtype(leaf.dtype).itemsize
    assert rec["resident_bytes"]["caches"] == total
