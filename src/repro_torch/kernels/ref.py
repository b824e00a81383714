"""Plain PyTorch versions of the port's kernels.

Each is the function its CUDA kernel computes, written with stock
PyTorch ops. The kernel wrappers take them only for tensors on the CPU
(the tests), and ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
    and an idx outside [0, p_dim) (the -1 pad) lands nowhere, as in the
    `compressed_graph_mix` kernel (the codec's `decode` and the plain
    version below both call this)."""
    N = vals.shape[0]
    pad = (idx < 0) | (idx >= p_dim)
    v = torch.where(pad, 0.0, vals.float())
    out = torch.zeros((N, p_dim), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, torch.where(pad, 0, idx).long(), v)


def compressed_graph_mix_ref(A: torch.Tensor, vals: torch.Tensor,
                             idx: torch.Tensor, p_dim: int) -> torch.Tensor:
    """``A @ densify(vals, idx)``: densify, then an fp32 matmul, cast to
    vals.dtype (`repro.kernels.ref.compressed_graph_mix_ref`)."""
    return (A.float() @ densify_topk(vals, idx, p_dim)).to(vals.dtype)


def bucket_payload_ref(vals: torch.Tensor, idx: torch.Tensor, p_dim: int,
                       tile: int) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The K3 bucketing pass: each (N, K) payload row's entries with an
    idx in [0, p_dim) grouped by ``tile``-column tile, in payload order
    within a tile, then the row's tail as (0.0, -1) (pads and indices
    out of range dropped). Returns (vals, idx, offsets), offsets (N, T + 1)
    int32 with T = ceil(p_dim / tile): tile t of row n is
    ``[offsets[n, t], offsets[n, t + 1])``, and offsets[n, T] counts the
    row's kept entries."""
    N, K = idx.shape
    T = -(-p_dim // tile)
    keep = (idx >= 0) & (idx < p_dim)
    bucket = torch.where(keep, idx.long() // tile, T)  # dropped: past T
    order = torch.sort(bucket, dim=1, stable=True).indices
    counts = torch.zeros((N, T + 1), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, bucket, torch.ones_like(bucket))
    offsets = torch.zeros((N, T + 1), dtype=torch.int32, device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :T], dim=1)
    tail = torch.arange(K, device=idx.device)[None] >= offsets[:, T:]
    return (torch.where(tail, 0.0, vals.gather(1, order)),
            torch.where(tail, -1, idx.gather(1, order)), offsets)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd); aligned positions
    (q_pos = arange(Sq), kv_pos = arange(Sk)): `attention_ref` in one
    chunk (`repro.kernels.ref.flash_attention_ref`)."""
    # imported here: `models` imports this module (`models.ssm` re-exports
    # `segsum` and `ssd_ref`), so a top-level import would be a cycle
    from ..models.common import attention_ref

    B, Sq = q.shape[0], q.shape[1]
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(Sk, dtype=torch.int32,
                          device=q.device)[None].expand(B, Sk)
    return attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                         window=window, q_chunk=1 << 30)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The plain version of K4's backward: (dq, dk, dv), the gradients of
    `flash_attention_ref` at (q, k, v) for the output gradient ``dout``,
    by ``torch.autograd.grad``, in the inputs' dtype. At bf16 it is
    `repro`'s autograd of its plain attention with its cast points (fp32
    products and sums of the bf16 values; dP the gradient of the bf16 P,
    so rounded to bf16; dS from the fp32 P; each gradient rounded to
    bf16 once), as `models.common.attention_ref`'s casts give it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) with out[i, j] = sum_{j<k<=i} x[k] (the
    difference of inclusive cumulative sums); -inf above the diagonal
    (`repro.models.ssm.segsum`)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=x.device)
    return torch.where(i[:, None] >= i[None, :], d, -torch.inf)


def ssd_ref(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan (`repro.models.ssm.ssd_ref`), the plain version
    of the K5 kernel. x: (b, l, h, p), already scaled by dt; dlogA:
    (b, l, h) per-step log decay (dt * A, A < 0); B, C: (b, l, n), one
    group shared by every head; h0: (b, h, p, n) or None (zeros).
    Chunks of L = min(chunk, l) steps; the inter-chunk recurrence is a
    Python loop over chunks where `repro` runs ``lax.scan``. Returns
    (y (b, l, h, p), h_last (b, h, p, n))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, l)
    if l % L != 0:
        raise ValueError(f"seq {l} not divisible by chunk {L}")
    c = l // L

    xc = x.reshape(b, c, L, h, p)
    Bc = B.reshape(b, c, L, n)
    Cc = C.reshape(b, c, L, n)
    Ac = dlogA.reshape(b, c, L, h).permute(0, 3, 1, 2)   # (b, h, c, L)
    A_cumsum = torch.cumsum(Ac, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    Lmat = torch.exp(segsum(Ac))                         # (b, h, c, L, L)
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lmat, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(A_cumsum[..., -1])           # (b, h, c)
    hprev = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    prev = []
    for i in range(c):
        prev.append(hprev)
        hprev = hprev * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)               # (b, c, h, p, n)

    # 4. contribution of the carried-in states
    state_decay_out = torch.exp(A_cumsum)                # (b, h, c, L)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay_out)
    return (Y_diag + Y_off).reshape(b, l, h, p), hprev


def ssd_bwd_ref(x: torch.Tensor, dlogA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor],
                dy: torch.Tensor, dh_last: Optional[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """The plain version of K5's backward: (dx, d dlogA, dB, dC, dh0), the
    gradients of `ssd_ref` at (x, dlogA, B, C, h0) for the output
    gradients ``dy`` (of y) and ``dh_last`` (of h_last; None is zero), by
    ``torch.autograd.grad``. dh0 is None when h0 is."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dlogA, B, C)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        y, h_last = ssd_ref(*ins, chunk, h)
        outs, grads = [y], [dy]
        if dh_last is not None:
            outs.append(h_last)
            grads.append(dh_last)
        leaves = ins + ([] if h is None else [h])
        got = torch.autograd.grad(outs, leaves, grads)
    return tuple(got) + ((None,) if h is None else ())


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over
    axis 1, the plain version of the K6 kernel. a, b: (B, S, W) float32;
    h0: (B, W) or None (zeros). Returns (h (B, S, W), h_last (B, W)).

    A Python loop over the S steps, each ``a_t * h + b_t`` rounded after
    the product and after the sum: the order of the Pallas kernel
    (``repro/kernels/rglru_scan.py``), which K6 keeps bit for bit.
    `repro`'s oracle (`repro.models.rglru.linear_scan_ref`) is an
    associative scan, which sums in another order, so the two agree to
    rounding only. Not the closed form ``P_t * cumsum(b / P)`` with
    ``P_t`` the running product of a: it divides by products that
    underflow."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, out[:, -1]


def linear_scan_bwd_ref(a: torch.Tensor, b: torch.Tensor,
                        h0: Optional[torch.Tensor], dy: torch.Tensor,
                        dh_last: Optional[torch.Tensor]
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The plain version of K6's backward: (da, db, dh0), the gradients of
    `linear_scan_ref` at (a, b, h0) for the output gradients ``dy`` (of
    h) and ``dh_last`` (None is zero), by ``torch.autograd.grad``. dh0 is
    None when h0 is. Autograd runs the recurrence backward in time, g_t =
    dy_t + a_{t+1} g_{t+1} (g_{S-1} = dy_{S-1} + dh_last), da_t = g_t
    h_{t-1}, db_t = g_t, dh0 = a_0 g_0: each product and sum rounded once,
    and each sum of two terms, so in no order that could differ."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (a, b)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        out, h_last = linear_scan_ref(*ins, h)
        outs, grads = [out], [dy]
        if dh_last is not None:
            outs.append(h_last)
            grads.append(dh_last)
        leaves = ins + ([] if h is None else [h])
        got = torch.autograd.grad(outs, leaves, grads)
    return tuple(got) + ((None,) if h is None else ())


def _grouped_conv(h: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Grouped VALID conv, one group a model. h: (B, G*Cin, H, W); w: (G,
    kh, kw, Cin, Cout) HWIO per model; b: (G, Cout). Returns (B, G*Cout,
    H', W')."""
    G, kh, kw, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(G * cout, cin, kh, kw)
    return F.conv2d(h, wt, groups=G) + b.reshape(1, G * cout, 1, 1)


def cnn_features_ref(x: torch.Tensor, conv1_w: torch.Tensor,
                     conv1_b: torch.Tensor, conv2_w: torch.Tensor,
                     conv2_b: torch.Tensor) -> torch.Tensor:
    """PaperCNN's convolution stack for G models: each model's conv1 ->
    bias -> ReLU -> 2x2 max-pool -> conv2 -> bias -> ReLU -> 2x2 max-pool
    over its images, as one grouped convolution a layer (``groups=G``).
    x: (G, B, H, W, C) NHWC per model; weights HWIO with a leading model
    axis. Returns (G, B, flat), each model's activations flattened in
    NHWC order, as `repro` flattens them before fc1. Differentiable: the
    model's training route (`repro_torch.models.classifier.PaperCNN`)."""
    G, B = x.shape[:2]
    # NHWC -> one NCHW batch whose channels are the G models' inputs
    h = x.permute(1, 0, 4, 2, 3).reshape(B, G * x.shape[4], x.shape[2],
                                          x.shape[3])
    h = F.relu(_grouped_conv(h, conv1_w, conv1_b))
    h = F.max_pool2d(h, 2)
    h = F.relu(_grouped_conv(h, conv2_w, conv2_b))
    h = F.max_pool2d(h, 2)
    c2 = conv2_w.shape[-1]
    h = h.reshape(B, G, c2, h.shape[2], h.shape[3])
    return h.permute(1, 0, 3, 4, 2).reshape(G, B, -1)
