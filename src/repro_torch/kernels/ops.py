"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

The choice follows the device of the tensors and nothing else: no
environment variable and no ``impl=`` argument selects an
implementation. On a CUDA tensor an op launches its kernel or raises.
"""
from __future__ import annotations

import torch

from ..analysis.registry import exchange_site
from . import graph_mix as _kernel
from . import ref


@exchange_site(charges="caller")
def graph_mix(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Eq.-4 mixing matmul ``A @ W`` ((M, N) @ (N, P)), fp32 accumulation,
    output in W's dtype (`repro.kernels.ops.graph_mix`)."""
    if A.device.type == "cpu" and W.device.type == "cpu":
        return ref.graph_mix_ref(A, W)
    return _kernel.graph_mix(A, W)
