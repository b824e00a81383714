"""Plain PyTorch versions of the port's kernels.

Each is the function its CUDA kernel computes, written with stock
PyTorch ops. The kernel wrappers take them only for tensors on the CPU
(the tests), and ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""
from __future__ import annotations

import torch


def graph_mix_ref(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A: (M, N) mixing operator; W: (N, P) client-stacked flattened
    params. Returns A @ W accumulated in fp32, cast back to W.dtype
    (`repro.kernels.ref.graph_mix_ref`)."""
    return (A.float() @ W.float()).to(W.dtype)
