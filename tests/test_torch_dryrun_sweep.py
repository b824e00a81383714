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
