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


def sparse_graph_mix_ref(self_w: torch.Tensor, nbr_w: torch.Tensor,
                         nbr_idx: torch.Tensor, W_self: torch.Tensor,
                         W_peers: torch.Tensor) -> torch.Tensor:
    """The neighbor-list Eq.-4 mix: self_w (N,), nbr_w and nbr_idx (N, B),
    W_self and W_peers (N, P). Returns
    ``self_w[:, None] * W_self + sum_b nbr_w[:, b] * W_peers[idx[:, b]]``
    in fp32, cast to W_self.dtype. An idx of -1 is an empty slot with
    weight 0 (clamped to row 0); duplicate indices add. Unrolled over
    the B slots, one (N, P) row gather each, never an (N, B, P) tensor
    (`repro.kernels.ref.sparse_graph_mix_ref`)."""
    N = W_peers.shape[0]
    w = torch.where(nbr_idx >= 0, nbr_w, 0.0).float()
    safe = nbr_idx.clamp(0, N - 1).long()
    Wp = W_peers.float()
    out = self_w.float()[:, None] * W_self.float()
    for b in range(nbr_idx.shape[1]):
        out = out + w[:, b, None] * Wp[safe[:, b]]
    return out.to(W_self.dtype)


def densify_topk(vals: torch.Tensor, idx: torch.Tensor,
                 p_dim: int) -> torch.Tensor:
    """Scatter a (N, K) top-k payload back to dense (N, p_dim) fp32. The
    single definition of the densify semantics: duplicate indices add,
    and an idx of -1 is a pad that lands nowhere, as in the
    `compressed_graph_mix` kernel (the codec's `decode` and the plain
    version below both call this)."""
    N = vals.shape[0]
    pad = idx < 0
    v = torch.where(pad, 0.0, vals.float())
    out = torch.zeros((N, p_dim), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, torch.where(pad, 0, idx).long(), v)


def compressed_graph_mix_ref(A: torch.Tensor, vals: torch.Tensor,
                             idx: torch.Tensor, p_dim: int) -> torch.Tensor:
    """``A @ densify(vals, idx)``: densify, then an fp32 matmul, cast to
    vals.dtype (`repro.kernels.ref.compressed_graph_mix_ref`)."""
    return (A.float() @ densify_topk(vals, idx, p_dim)).to(vals.dtype)
