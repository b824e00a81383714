"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.

The choice follows the device of the tensors and nothing else: no
environment variable and no ``impl=`` argument selects an
implementation. On a CUDA tensor an op launches its kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis.registry import exchange_site
from . import compressed_graph_mix as _k3
from . import flash_attention as _k4
from . import graph_mix as _k1
from . import ref
from . import rglru_scan as _k6
from . import sparse_graph_mix as _k2
from . import ssd as _k5


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention over aligned positions, optional sliding
    window: q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), output in q's
    dtype (`repro.kernels.ops.flash_attention`). Differentiable in fp32:
    on CPU tensors autograd differentiates the plain version, on CUDA
    tensors the kernel's backward runs (`kernels.flash_attention`).
    Raises ``NotImplementedError`` for bf16 inputs that require grad, on
    either device: the kernel's backward takes fp32 only."""
    _k4.check_no_grad(q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _k4.flash_attention(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 chunked SSD scan: x (b, l, h, p) already scaled by dt,
    dlogA (b, l, h), B and C (b, l, n), h0 (b, h, p, n) or None; returns
    (y (b, l, h, p), h_last (b, h, p, n)) (`repro.kernels.ops.ssd`).
    Differentiable in fp32: on CPU tensors autograd differentiates the
    plain version, on CUDA tensors the kernel's backward runs
    (`kernels.ssd`)."""
    if _on_cpu(x, dlogA, B, C, *(() if h0 is None else (h0,))):
        return ref.ssd_ref(x, dlogA, B, C, chunk, h0)
    return _k5.ssd(x, dlogA, B, C, chunk=chunk, h0=h0)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` over axis 1: a, b
    (B, S, W) float32, h0 (B, W) or None; returns (h (B, S, W), h_last
    (B, W)) (`repro.kernels.rglru_scan.rglru_scan`, whose oracle `repro`'s
    model runs). Differentiable: on CPU tensors autograd differentiates
    the plain version, on CUDA tensors the kernel's backward runs
    (`kernels.rglru_scan`)."""
    if _on_cpu(a, b, *(() if h0 is None else (h0,))):
        return ref.linear_scan_ref(a, b, h0)
    return _k6.rglru_scan(a, b, h0)
