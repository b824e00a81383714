"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

The choice follows the device of the tensors and nothing else: no
environment variable and no ``impl=`` argument selects an
implementation. On a CUDA tensor an op launches its kernel or raises.
"""
from __future__ import annotations

import torch

from ..analysis.registry import exchange_site
from . import compressed_graph_mix as _k3
from . import graph_mix as _k1
from . import ref
from . import sparse_graph_mix as _k2


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


@exchange_site(charges="caller")
def graph_mix(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Eq.-4 mixing matmul ``A @ W`` ((M, N) @ (N, P)), fp32 accumulation,
    output in W's dtype (`repro.kernels.ops.graph_mix`)."""
    if _on_cpu(A, W):
        return ref.graph_mix_ref(A, W)
    return _k1.graph_mix(A, W)


@exchange_site(charges="caller")
def sparse_graph_mix(self_w: torch.Tensor, nbr_w: torch.Tensor,
                     nbr_idx: torch.Tensor, W_self: torch.Tensor,
                     W_peers: torch.Tensor) -> torch.Tensor:
    """Neighbor-list Eq.-4 mix
    ``out[n] = self_w[n] W_self[n] + sum_b nbr_w[n, b] W_peers[idx[n, b]]``
    (idx -1 = empty slot), fp32 accumulation, output in W_self's dtype
    (`repro.kernels.ops.sparse_graph_mix` on one device)."""
    if _on_cpu(self_w, nbr_w, nbr_idx, W_self, W_peers):
        return ref.sparse_graph_mix_ref(self_w, nbr_w, nbr_idx, W_self,
                                        W_peers)
    return _k2.sparse_graph_mix(self_w, nbr_w, nbr_idx, W_self, W_peers)


@exchange_site(charges="caller")
def compressed_graph_mix(A: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, p_dim: int) -> torch.Tensor:
    """``A @ densify(vals, idx)`` over (N, K) top-k payloads, fp32
    accumulation (`repro.kernels.ops.compressed_graph_mix` on one
    device)."""
    if _on_cpu(A, vals, idx):
        return ref.compressed_graph_mix_ref(A, vals, idx, p_dim)
    return _k3.compressed_graph_mix(A, vals, idx, p_dim)
