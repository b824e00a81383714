"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where there is no CUDA card.
The file imports neither jax nor `repro`, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import compressed_graph_mix as k3
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import graph_mix as k1
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as k6
from repro_torch.kernels import sparse_graph_mix as k2
from repro_torch.kernels import ssd as k5

pytestmark = pytest.mark.gpu

# (M, N, P): M = 1 (one set sum), M = N (Eq. 4), M != N (a BGGC phase-1
# batch), ragged P, and the Eq.-4 mix at PaperCNN width
SHAPES = [(1, 6, 512), (6, 6, 512), (6, 3, 700), (4, 9, 2048 + 37),
          (9, 4, 1000), (33, 40, 1001), (32, 32, 62006)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # as tests/test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(M, N, P, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.random((M, N)).astype(np.float32)
    A /= A.sum(axis=1, keepdims=True)
    W = rng.standard_normal((N, P)).astype(np.float32)
    return (torch.from_numpy(A).to(device),
            torch.from_numpy(W).to(device).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_mix_kernel_matches_plain_version(cuda, dtype):
    for M, N, P in SHAPES:
        A, W = _inputs(M, N, P, dtype, cuda)
        before = k1.graph_mix.launches
        got = ops.graph_mix(A, W)
        torch.cuda.synchronize()
        assert k1.graph_mix.launches == before + 1
        assert got.dtype == W.dtype and tuple(got.shape) == (M, P)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), ref.graph_mix_ref(A, W).float(),
                                   rtol=tol, atol=tol)


# K1 shapes that reach every vector width and edge: P = 0, 1, 2, 3 mod 4,
# P under one vector, M 33 and 64 (two block rows), N 1, 33 and 100 (a
# partial and several passes of W's rows)
K1_EDGE_SHAPES = [(32, 32, 62004), (32, 32, 62005), (32, 32, 62007),
                  (5, 3, 1), (5, 3, 3), (33, 32, 1000), (64, 32, 2048),
                  (32, 1, 62006), (32, 33, 999), (7, 100, 4098)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_mix_kernel_every_vector_width(cuda, dtype):
    """Each edge shape, on W itself and on a row-offset view of a larger
    buffer (``narrow`` of one element, so data_ptr() is only element-
    aligned): the width follows P and the address, and a repeated call
    gives the same bits."""
    widths = set()
    for M, N, P in K1_EDGE_SHAPES:
        A, W = _inputs(M, N, P, dtype, cuda)
        buf = torch.empty(N * P + 1, dtype=W.dtype, device=cuda)
        view = buf.narrow(0, 1, N * P).view(N, P).copy_(W)
        for w in (W, view):
            widths.add(k1.vector_width(P, w.element_size(), w.data_ptr()))
            got = ops.graph_mix(A, w)
            tol = TOL[dtype]
            torch.testing.assert_close(
                got.float(), ref.graph_mix_ref(A, w).float(), rtol=tol,
                atol=tol)
            assert torch.equal(got, ops.graph_mix(A, w))
    assert widths == set(k1.WIDTHS)


def test_graph_mix_kernel_refuses_what_it_does_not_take(cuda):
    A, W = _inputs(4, 4, 64, "float32", cuda)
    with pytest.raises(TypeError):
        k1.graph_mix(A.double(), W)
    with pytest.raises(TypeError):
        k1.graph_mix(A, W.half())
    with pytest.raises(ValueError):
        k1.graph_mix(A, W[:3])
    with pytest.raises(ValueError):
        k1.graph_mix(A, W.t().contiguous().t())
    with pytest.raises(ValueError):
        k1.graph_mix(A, W.cpu())


# K2 (N, B, P, index table): sentinel slots, duplicates, all-sentinel
# rows, B > N, ragged P, and the main path at PaperCNN width
K2_SHAPES = [(6, 3, 40, "random"), (16, 4, 2100, "duplicates"),
             (5, 7, 33, "random"), (6, 3, 40, "sentinel"),
             (9, 5, 1001, "random"), (32, 4, 62006, "random")]


def _k2_inputs(N, B, P, table, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    idx = {"random": rng.integers(-1, N, (N, B)),
           "duplicates": np.zeros((N, B)),
           "sentinel": np.full((N, B), -1)}[table].astype(np.int32)
    arrays = (rng.random(N).astype(np.float32),
              rng.random((N, B)).astype(np.float32), idx)
    W = rng.standard_normal((2, N, P)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in arrays) + tuple(
        torch.from_numpy(w).to(device).to(getattr(torch, dtype)) for w in W)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_graph_mix_kernel_matches_plain_version(cuda, dtype):
    for N, B, P, table in K2_SHAPES:
        sw, nw, idx, W, peers = _k2_inputs(N, B, P, table, dtype, cuda)
        for Wp in (W, peers):
            before = k2.sparse_graph_mix.launches
            got = ops.sparse_graph_mix(sw, nw, idx, W, Wp)
            torch.cuda.synchronize()
            assert k2.sparse_graph_mix.launches == before + 1
            assert got.dtype == W.dtype and tuple(got.shape) == (N, P)
            tol = TOL[dtype]
            torch.testing.assert_close(
                got.float(),
                ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp).float(),
                rtol=tol, atol=tol)


def test_sparse_graph_mix_kernel_refuses_what_it_does_not_take(cuda):
    sw, nw, idx, W, peers = _k2_inputs(4, 2, 64, "random", "float32", cuda)
    with pytest.raises(TypeError):
        k2.sparse_graph_mix(sw, nw, idx.long(), W, peers)
    with pytest.raises(TypeError):
        k2.sparse_graph_mix(sw, nw, idx, W, peers.bfloat16())
    with pytest.raises(TypeError):
        k2.sparse_graph_mix(sw.double(), nw, idx, W, peers)
    with pytest.raises(ValueError):
        k2.sparse_graph_mix(sw, nw, idx, W, peers[:3])
    with pytest.raises(ValueError):
        k2.sparse_graph_mix(sw, nw, idx[:, :1], W, peers)
    with pytest.raises(ValueError):
        k2.sparse_graph_mix(sw, nw, idx, W.t().contiguous().t(), peers)
    with pytest.raises(ValueError):
        k2.sparse_graph_mix(sw, nw, idx, W, peers.cpu())


# K3 (M, N, K, P, index table): top-k payloads with K and P off the
# tile, duplicates, -1 pads, M > 32, and the main path at PaperCNN width
K3_SHAPES = [(2, 2, 2, 2, "topk"), (3, 3, 14, 700, "topk"),
             (12, 12, 300, 900, "duplicates"), (12, 12, 300, 900, "pads"),
             (40, 9, 77, 515, "duplicates"), (32, 32, 6201, 62006, "topk")]


def _k3_inputs(M, N, K, P, table, device, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.random((M, N)).astype(np.float32)
    A /= A.sum(axis=1, keepdims=True)
    if table == "topk":
        x = rng.standard_normal((N, P)).astype(np.float32)
        idx = np.argsort(-np.abs(x), axis=1, kind="stable")[:, :K]
        vals = np.take_along_axis(x, idx, axis=1)
    else:
        idx = rng.integers(0, max(1, P // 8), (N, K)) * 8
        vals = rng.standard_normal((N, K)).astype(np.float32)
        if table == "pads":
            idx = np.where(rng.random((N, K)) < 0.3, -1, idx)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (A, vals, idx.astype(np.int32)))


def test_compressed_graph_mix_kernel_matches_plain_version(cuda):
    for M, N, K, P, table in K3_SHAPES:
        A, vals, idx = _k3_inputs(M, N, K, P, table, cuda)
        before = k3.compressed_graph_mix.launches
        got = ops.compressed_graph_mix(A, vals, idx, P)
        torch.cuda.synchronize()
        assert k3.compressed_graph_mix.launches == before + 1
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, P)
        torch.testing.assert_close(
            got, ref.compressed_graph_mix_ref(A, vals, idx, P), rtol=1e-5,
            atol=1e-5)
        # no atomics: the same bits from run to run
        assert torch.equal(got, ops.compressed_graph_mix(A, vals, idx, P))


def test_compressed_graph_mix_kernel_duplicates_add_exactly(cuda):
    got = k3.compressed_graph_mix(
        torch.eye(2, device=cuda),
        torch.tensor([[1.0, 2.0, 4.0], [0.5, 0.25, 0.125]], device=cuda),
        torch.tensor([[3, 3, 0], [1, 1, 1]], dtype=torch.int32,
                     device=cuda), 5)
    want = torch.tensor([[4.0, 0, 0, 3.0, 0], [0, 0.875, 0, 0, 0]],
                        device=cuda)
    assert torch.equal(got, want)


def test_compressed_graph_mix_kernel_refuses_what_it_does_not_take(cuda):
    A, vals, idx = _k3_inputs(4, 4, 8, 64, "topk", cuda)
    with pytest.raises(TypeError):
        k3.compressed_graph_mix(A, vals, idx.long(), 64)
    with pytest.raises(TypeError):
        k3.compressed_graph_mix(A, vals.bfloat16(), idx, 64)
    with pytest.raises(ValueError):
        k3.compressed_graph_mix(A, vals[:3], idx[:3], 64)
    with pytest.raises(ValueError):
        k3.compressed_graph_mix(A.t(), vals, idx, 64)
    with pytest.raises(ValueError):
        k3.compressed_graph_mix(A, vals.cpu(), idx, 64)


# K3 edge cases of the bucketing design: (name, M, N, K, P); the
# payloads are drawn by `_k3_edge`
K3_EDGES = [("every entry in one tile", 4, 4, 200, 1000),
            ("duplicates across a 32-entry step", 3, 3, 70, 600),
            ("a row of pads only", 5, 4, 100, 700),
            ("P off the tile", 6, 5, 120, 1000),
            ("K > P", 5, 5, 300, 100),
            ("several windows, indices past P", 4, 3, 5000, 200_000),
            # more entries in one window than shared memory stages
            # (kStageMax, 24,576): written to device memory directly
            ("a window past the stage", 3, 2, 30_000, 5000)]


def _k3_edge(name, M, N, K, P, device, seed=0):
    """(A, vals, idx) for one K3_EDGES case: integer values (so every sum
    is exact) where the case is about the order of duplicates."""
    rng = np.random.default_rng(seed)
    A = rng.random((M, N)).astype(np.float32)
    A /= A.sum(axis=1, keepdims=True)
    vals = rng.standard_normal((N, K)).astype(np.float32)
    if name == "every entry in one tile":
        idx = rng.integers(256, 512, (N, K))
    elif name == "duplicates across a 32-entry step":
        # one tile, each row's bucket 70 entries long: column k % 20, and
        # entries 31 and 32 (the two sides of a step) both column 17
        idx = np.tile(np.arange(K) % 20, (N, 1))
        idx[:, 31] = idx[:, 32] = 17
        vals = rng.integers(-8, 9, (N, K)).astype(np.float32)
        A = np.eye(M, N, dtype=np.float32)
    elif name == "a row of pads only":
        idx = np.where(rng.random((N, K)) < 0.2, -1,
                       rng.integers(0, P, (N, K)))
        idx[1] = -1
    elif name == "several windows, indices past P":
        idx = rng.integers(0, P, (N, K))
        idx = np.where(rng.random((N, K)) < 0.05, P + 3, idx)
    else:
        idx = rng.integers(0, P, (N, K))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (A, vals, idx.astype(np.int32)))


@pytest.mark.parametrize("case", K3_EDGES, ids=[c[0] for c in K3_EDGES])
def test_compressed_graph_mix_kernel_edge_cases(cuda, case):
    """Against the plain version (exactly where the sums are integers),
    one op counted per call, and the same bits on a repeated call."""
    name, M, N, K, P = case
    A, vals, idx = _k3_edge(name, M, N, K, P, cuda)
    before = k3.compressed_graph_mix.launches
    got = ops.compressed_graph_mix(A, vals, idx, P)
    torch.cuda.synchronize()
    assert k3.compressed_graph_mix.launches == before + 1
    want = ref.compressed_graph_mix_ref(A, vals, idx, P)
    if name == "duplicates across a 32-entry step":
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.compressed_graph_mix(A, vals, idx, P))


@pytest.mark.parametrize("case", K3_EDGES + [
    ("main", 32, 32, 6201, 62006)], ids=[c[0] for c in K3_EDGES] + ["main"])
def test_compressed_graph_mix_bucketing_matches_plain_version(cuda, case):
    """The bucketing pass gives its plain version's entries, order, tail
    and offsets exactly."""
    name, M, N, K, P = case
    if name == "main":
        _, vals, idx = _k3_inputs(M, N, K, P, "topk", cuda)
    else:
        _, vals, idx = _k3_edge(name, M, N, K, P, cuda)
    got = k3.bucket_payload(vals, idx, P)
    want = ref.bucket_payload_ref(vals, idx, P, k3.TILE)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# K2 on its one-column path and past its slot group (kSlots 4) and
# staging chunk (kChunk 64): (N, B, P, W_self one element into a buffer)
K2_EDGES = [(5, 11, 1001, False),   # odd P, B > kSlots, B > N
            (5, 11, 1000, True),    # base address off 8 bytes
            (6, 70, 2002, False),   # B > kChunk, two columns a thread
            (6, 70, 2003, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_graph_mix_kernel_vector_paths(cuda, dtype):
    widths = set()
    for N, B, P, offset in K2_EDGES:
        sw, nw, idx, W, peers = _k2_inputs(N, B, P, "random", dtype, cuda)
        if offset:
            buf = torch.empty(N * P + 1, dtype=W.dtype, device=cuda)
            W = buf.narrow(0, 1, N * P).view(N, P).copy_(W)
        for Wp in (W, peers):
            widths.add(k1.vector_width(P, W.element_size(), W.data_ptr(),
                                       Wp.data_ptr()))
            got = k2.sparse_graph_mix(sw, nw, idx, W, Wp)
            tol = TOL[dtype]
            torch.testing.assert_close(
                got.float(),
                ref.sparse_graph_mix_ref(sw, nw, idx, W, Wp).float(),
                rtol=tol, atol=tol)
            # a fixed order of slots: the same bits from run to run
            assert torch.equal(got, k2.sparse_graph_mix(sw, nw, idx, W, Wp))
    assert widths == {1, 2}


def test_sparse_graph_mix_kernel_tiles_past_the_grid(cuda):
    """More P tiles than the grid's y extent: blocks take several tiles
    (`launch_grid`), and every column is written."""
    P = 512 * 65536 + 1   # odd: one column a thread, 65,537 tiles
    assert k2.launch_grid(1, P, 1) == 65535
    sw, nw, idx, W, peers = _k2_inputs(1, 2, P, "random", "float32", cuda)
    torch.testing.assert_close(
        k2.sparse_graph_mix(sw, nw, idx, W, peers),
        ref.sparse_graph_mix_ref(sw, nw, idx, W, peers), rtol=1e-5,
        atol=1e-5)


# K4 (B, Sq, Sk, Hq, Hkv, hd, window): chip_smoke.py's cases (the serve
# shape, MQA with a window, hd 80, hd 256 with one KV head, ragged S,
# S = 1, Sq != Sk) and every head size of the repo's configs
K4_SHAPES = [(4, 512, 512, 16, 8, 128, None), (1, 256, 256, 4, 1, 64, 96),
             (2, 384, 384, 32, 8, 80, 128), (1, 256, 256, 16, 1, 256, 64),
             (2, 200, 200, 16, 8, 128, None), (4, 1, 1, 16, 8, 128, None),
             (2, 128, 256, 16, 8, 128, None), (2, 250, 128, 4, 2, 112, 128),
             (1, 70, 70, 3, 3, 16, None), (1, 33, 33, 2, 1, 48, 5)]
K4_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # as tests/test_kernels.py
# bf16 against the fp32 plain version on the same inputs, (atol, rtol):
# as chip_smoke.py's K4_BF16_FP32_TOL (one bf16 ulp at 1, two ulps)
K4_BF16_FP32_TOL = (2.0 ** -7, 2.0 ** -6)


def _k4_inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Sq, Hq, hd)) * 0.5,
              rng.standard_normal((B, Sk, Hkv, hd)) * 0.5,
              rng.standard_normal((B, Sk, Hkv, hd)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 .to(getattr(torch, dtype)) for a in arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_version(cuda, dtype):
    for B, Sq, Sk, Hq, Hkv, hd, window in K4_SHAPES:
        q, k, v = _k4_inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, cuda)
        before = k4.flash_attention.launches
        got = ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert k4.flash_attention.launches == before + 1
        assert got.dtype == q.dtype and got.shape == q.shape
        tol = K4_TOL[dtype]
        torch.testing.assert_close(
            got.float(), ref.flash_attention_ref(q, k, v, window=window)
            .float(), rtol=tol, atol=tol)
        if dtype == "bfloat16":
            atol, rtol = K4_BF16_FP32_TOL
            torch.testing.assert_close(
                got.float(), ref.flash_attention_ref(
                    q.float(), k.float(), v.float(), window=window),
                rtol=rtol, atol=atol)
        # no atomics: the same bits from run to run
        assert torch.equal(got, ops.flash_attention(q, k, v, window=window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_reads_strided_heads(cuda, dtype):
    """(B, H, S, hd) storage viewed as (B, S, H, hd): read in place."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _k4_inputs(2, 100, 100, 8, 2, 64, dtype, cuda))
    assert not q.is_contiguous()
    tol = K4_TOL[dtype]
    torch.testing.assert_close(
        k4.flash_attention(q, k, v, window=40).float(),
        ref.flash_attention_ref(q, k, v, window=40).float(), rtol=tol,
        atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_refuses_misaligned_inputs(cuda, dtype):
    """Rows are copied in 16-byte pieces: a base address or a (b, s, h)
    stride off 16 bytes raises ValueError, never a slow path; a stride
    that is a multiple of 16 bytes is read in place."""
    q, k, v = _k4_inputs(2, 64, 64, 4, 2, 32, dtype, cuda)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat.narrow(0, 1, q.numel()).view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        k4.flash_attention(shifted, k, v)
    wide = torch.zeros((2, 64, 2, 33), dtype=q.dtype, device=cuda)
    ragged = wide[..., :32]   # head stride 33 elements
    with pytest.raises(ValueError, match="stride"):
        k4.flash_attention(q, ragged, v)
    padded = torch.zeros((2, 64, 2, 40), dtype=q.dtype, device=cuda)
    kp = padded[..., :32].copy_(k)   # head stride 40 elements: aligned
    tol = K4_TOL[dtype]
    torch.testing.assert_close(
        k4.flash_attention(q, kp, v).float(),
        ref.flash_attention_ref(q, k, v).float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_non_causal(cuda):
    q, k, v = _k4_inputs(1, 64, 96, 4, 2, 32, "float32", cuda)
    for window in (None, 40):
        torch.testing.assert_close(
            k4.flash_attention(q, k, v, causal=False, window=window),
            ref.flash_attention_ref(q, k, v, causal=False, window=window),
            rtol=2e-5, atol=2e-5)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _k4_inputs(1, 16, 16, 4, 2, 32, "float32", cuda)
    with pytest.raises(TypeError):
        k4.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        k4.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        k4.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError):
        k4.flash_attention(q, k[:, :2], v[:, :2], window=4)
    # bf16 inputs that require grad run (K4's bf16 backward); q, k and v
    # of two dtypes do not
    with pytest.raises(TypeError):
        k4.flash_attention(q.bfloat16().requires_grad_(True), k, v)


# K4 backward cases: (B, Sq, Sk, Hq, Hkv, hd, causal, window): GQA at hd
# 128, MQA at hd 256 with a window (one Q/dO stage in (b); 4 head
# splits), hd 192 (one stage), hd 80 with a window, a ragged S, Sq < Sk
# causal (keys no row sees get zeros), non-causal with Sq != Sk, with and
# without a window; then recurrentgemma-9b's training shape (hd 256, one
# KV head, window 2,048: 8 splits), qwen3's heads at a ragged S 200 that
# no key tile divides, hd 176 (the first one-stage size) at a window and
# hd 224 non-causal with Sq < Sk
K4_BWD_SHAPES = [(2, 128, 128, 8, 4, 128, True, None),
                 (1, 130, 130, 4, 1, 256, True, 64),
                 (1, 70, 70, 2, 2, 192, True, None),
                 (2, 100, 100, 8, 2, 80, True, 48),
                 (2, 77, 77, 4, 2, 64, True, None),
                 (1, 40, 90, 4, 2, 16, True, None),
                 (1, 64, 96, 4, 2, 32, False, None),
                 (1, 96, 64, 4, 2, 32, False, 40),
                 (4, 512, 512, 16, 1, 256, True, 2048),
                 (2, 200, 200, 16, 8, 128, True, None),
                 (2, 300, 300, 8, 2, 176, True, 100),
                 (1, 200, 260, 8, 1, 224, False, None)]
# each gradient against the plain version's, relative to its largest
# element: fp32 sums over up to 130 keys (or queries and heads) in
# another order than cuBLAS's
K4_BWD_TOL = 1e-4


def _lse_ref(q, k, causal, window):
    """(B, Hq, Sq) logsumexp of the scaled, masked scores."""
    rep = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / q.shape[-1] ** 0.5
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None]
    mask = torch.ones_like(i == j)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    return torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)


def test_flash_attention_backward_matches_plain_version(cuda):
    for B, Sq, Sk, Hq, Hkv, hd, causal, window in K4_BWD_SHAPES:
        q, k, v = _k4_inputs(B, Sq, Sk, Hq, Hkv, hd, "float32", cuda)
        dout = torch.randn(q.shape, generator=torch.Generator(
            device=cuda).manual_seed(1), device=cuda)
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        assert torch.equal(out, k4.flash_attention(q, k, v, **kw))
        torch.testing.assert_close(lse, _lse_ref(q, k, causal, window),
                                   rtol=1e-5, atol=1e-5)
        before = k4.flash_attention_bwd.launches
        got = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        assert k4.flash_attention_bwd.launches == before + 1
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        for name, g, w in zip("qkv", got, want):
            scale = w.abs().max().clamp_min(1e-30)
            torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                       atol=K4_BWD_TOL, msg=f"d{name}")
        # no atomics: the same bits from run to run
        again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # autograd through ops.flash_attention runs the same launches
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (k4.flash_attention.launches,
                  k4.flash_attention_bwd.launches)
        grads = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                    leaves, dout)
        assert (k4.flash_attention.launches,
                k4.flash_attention_bwd.launches) == (before[0] + 1,
                                                     before[1] + 1)
        assert all(torch.equal(a, b) for a, b in zip(grads, got))


# K4 backward cases walked in slabs of `keys` keys (a scratch budget set
# that small): a window whose late query tiles see no key of the first
# slab, hd 176 non-causal with Sq < Sk (32-key tiles), GQA at hd 128
K4_BWD_SLABS = [(1, 300, 300, 4, 2, 64, True, 100, 64),
                (1, 200, 260, 4, 1, 176, False, None, 64),
                (2, 256, 256, 8, 2, 128, True, None, 128)]


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, keys",
                         K4_BWD_SLABS)
def test_flash_attention_backward_in_slabs_of_keys(cuda, monkeypatch, B, Sq,
                                                   Sk, Hq, Hkv, hd, causal,
                                                   window, keys):
    n_qt = -(-Sq // k4.QUERY_TILE)
    monkeypatch.setattr(k4, "BWD_SCRATCH_BYTES",
                        B * Hq * n_qt * k4.QUERY_TILE * 4 * keys)
    plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, k4._sm_count(0))
    assert plan.slab_keys == keys and plan.n_slabs > 1
    q, k, v = _k4_inputs(B, Sq, Sk, Hq, Hkv, hd, "float32", cuda)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    kw = dict(causal=causal, window=window)
    out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
    got = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K4_BWD_TOL, msg=f"d{name}")
    again = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# K4's bf16 backward: the three main-path shapes (qwen3-0.6b's train
# shape; whisper-medium's encoder, non-causal over 1,500 keys;
# recurrentgemma-9b's, one KV head of 256 in 8 head splits, window 2,048),
# then small cases of every mask (ragged, a window, Sq < Sk, Sq > Sk,
# GQA 2 and 8, hd 16 to 224; hd 176's dK/dV column quarters uneven)
K4_BWD_BF16_SHAPES = [(8, 512, 512, 16, 8, 128, True, None),
                      (8, 1500, 1500, 16, 16, 64, False, None),
                      (4, 512, 512, 16, 1, 256, True, 2048),
                      (2, 77, 77, 4, 2, 64, True, None),
                      (2, 100, 100, 8, 2, 80, True, 48),
                      (1, 40, 90, 4, 2, 16, True, None),
                      (1, 96, 64, 4, 2, 32, False, 40),
                      (2, 300, 300, 16, 2, 176, True, 100),
                      (1, 200, 260, 8, 1, 224, False, None)]
# each bf16 gradient against the plain version's, relative to its largest
# element: both round dq, dk and dv to bf16 (2^-8 relative, so an element
# on a rounding boundary differs by an ulp), and D is rowsum(dO o O) of the
# bf16 O where the plain autograd sums P dP
K4_BWD_BF16_TOL = 2e-2


def test_flash_attention_bf16_backward_matches_plain_version(cuda):
    for B, Sq, Sk, Hq, Hkv, hd, causal, window in K4_BWD_BF16_SHAPES:
        q, k, v = _k4_inputs(B, Sq, Sk, Hq, Hkv, hd, "bfloat16", cuda)
        dout = torch.randn(q.shape, generator=torch.Generator(
            device=cuda).manual_seed(1), device=cuda).bfloat16()
        kw = dict(causal=causal, window=window)
        out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
        before = (k4.flash_attention_bwd.launches,
                  k4.flash_attention_bwd_bf16.launches)
        got = k4.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        assert (k4.flash_attention_bwd.launches,
                k4.flash_attention_bwd_bf16.launches) == (before[0],
                                                          before[1] + 1)
        want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == w.dtype == torch.bfloat16
            scale = w.float().abs().max().clamp_min(1e-30)
            err = float(((g.float() - w.float()) / scale).abs().max())
            print(f"bf16 backward {(B, Sq, Sk, Hq, Hkv, hd, causal, window)}"
                  f" d{name}: {err:.3e} of its largest element")
            assert err <= K4_BWD_BF16_TOL, f"d{name}"
        del want
        # fixed orders, no atomics: the same bits on a repeat
        again = k4.flash_attention_bwd_bf16(q, k, v, out, lse, dout, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # autograd through ops.flash_attention runs the same launches
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                    leaves, dout)
        assert all(torch.equal(a, b) for a, b in zip(grads, got))


# K4 under torch.func.vmap over clients: (clients, B, S, Hq, Hkv, hd),
# lm-dpfl's local step at qwen3-0.6b width and the personalized prefill,
# the lm-dpfl example's local step and reward call (2/2 heads of 32; all
# chip_smoke.py's K4_VMAP_CASES), then GQA 4/1 with hd 64 at a ragged S
K4_VMAP_SHAPES = [(4, 8, 32, 16, 8, 128), (4, 1, 512, 16, 8, 128),
                  (6, 8, 32, 2, 2, 32), (24, 12, 32, 2, 2, 32),
                  (3, 2, 200, 4, 1, 64)]


@pytest.mark.parametrize("N, B, S, Hq, Hkv, hd", K4_VMAP_SHAPES)
def test_flash_attention_under_vmap_folds_the_clients(cuda, N, B, S, Hq,
                                                      Hkv, hd):
    """One forward launch (and one backward call under autograd) on the
    folded (N * B) batch, bit for bit the per-client launches, within
    1e-5 of the plain version (the gradients as a share of their largest
    element)."""
    q, k, v = (t.unflatten(0, (N, B)) for t in _k4_inputs(
        N * B, S, S, Hq, Hkv, hd, "float32", cuda))
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    f = torch.func.vmap(ops.flash_attention)

    def counts():
        return k4.flash_attention.launches, k4.flash_attention_bwd.launches
    before = counts()
    with torch.no_grad():
        out = f(q, k, v)
    assert counts() == (before[0] + 1, before[1])
    with torch.no_grad():
        each = torch.stack([ops.flash_attention(q[i], k[i], v[i])
                            for i in range(N)])
    assert torch.equal(out, each)
    torch.testing.assert_close(out, ref.flash_attention_ref(
        q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1)).unflatten(
        0, (N, B)), rtol=1e-5, atol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = counts()
    got = torch.autograd.grad(f(*leaves), leaves, dout)
    assert counts() == (before[0] + 1, before[1] + 1)
    want = ref.flash_attention_bwd_ref(q.flatten(0, 1), k.flatten(0, 1),
                                       v.flatten(0, 1), dout.flatten(0, 1))
    for i in range(N):
        li = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
        gi = torch.autograd.grad(ops.flash_attention(*li), li, dout[i])
        assert all(torch.equal(a[i], b) for a, b in zip(got, gi))
    for name, g, w in zip("qkv", got, want):
        w = w.unflatten(0, (N, B))
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-5,
                                   msg=f"d{name}")


# K5 (b, l, H, p, n, chunk, dlogA, h0): chip_smoke.py's cases (the serve
# shape of mamba2-370m with the model's dt, tests/test_kernels.py's three
# shapes, a single ragged chunk, an h0, p 128), then eight chunks at the
# serve width (the state passed seven times), h0 with a single chunk, and
# p 24 with n 4 (widths that are not a whole tile)
K5_SHAPES = [(4, 512, 32, 64, 128, 256, "model", False),
             (1, 128, 2, 16, 8, 32, "kernels", False),
             (2, 256, 4, 32, 16, 64, "kernels", False),
             (1, 64, 1, 64, 32, 64, "kernels", False),
             (2, 100, 8, 64, 128, 256, "model", False),
             (2, 256, 4, 32, 16, 64, "kernels", True),
             (1, 256, 4, 128, 64, 128, "model", True),
             (1, 2048, 32, 64, 128, 256, "model", False),
             (2, 64, 4, 32, 16, 64, "kernels", True),
             (2, 192, 3, 24, 4, 64, "model", True)]
K5_TOL = dict(atol=2e-4, rtol=1e-3)   # as tests/test_kernels.py


def _k5_inputs(b, l, H, p, n, dlogA, h0, device, seed=0):
    """x, B, C normal * 0.3 with dlogA = -|normal| * 0.1 (tests/
    test_kernels.py), or as the model makes them: dt = softplus(normal),
    A = -1, x scaled by dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, H, p)) * 0.3
    if dlogA == "model":
        dt = np.logaddexp(rng.standard_normal((b, l, H)), 0.0)
        x, dA = x * dt[..., None], -dt
    else:
        dA = -np.abs(rng.standard_normal((b, l, H))) * 0.1
    arrays = (x, dA, rng.standard_normal((b, l, n)) * 0.3,
              rng.standard_normal((b, l, n)) * 0.3)
    if h0:
        arrays += (rng.standard_normal((b, H, p, n)) * 0.5,)
    out = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]
    return out if h0 else out + [None]


def test_ssd_kernel_matches_plain_version(cuda):
    for b, l, H, p, n, chunk, dlogA, with_h0 in K5_SHAPES:
        x, dA, Bm, Cm, h0 = _k5_inputs(b, l, H, p, n, dlogA, with_h0, cuda)
        before = k5.ssd.launches
        y, hl = ops.ssd(x, dA, Bm, Cm, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        assert k5.ssd.launches == before + 1
        assert y.shape == x.shape and tuple(hl.shape) == (b, H, p, n)
        wy, wh = ref.ssd_ref(x, dA, Bm, Cm, chunk, h0)
        torch.testing.assert_close(y, wy, **K5_TOL)
        torch.testing.assert_close(hl, wh, **K5_TOL)
        # no atomics: the same bits from run to run
        y2, hl2 = ops.ssd(x, dA, Bm, Cm, chunk=chunk, h0=h0)
        assert torch.equal(y, y2) and torch.equal(hl, hl2)


def test_ssd_kernel_reads_strided_inputs(cuda):
    """x a (b, l, h, p) view of (b, h, l, p) storage, B and C column
    slices of one projection, as mamba_block passes them."""
    x, dA, Bm, Cm, _ = _k5_inputs(2, 128, 4, 32, 16, "model", False, cuda)
    xs = x.transpose(1, 2).contiguous().transpose(1, 2)
    proj = torch.cat([Bm, Cm], dim=-1)
    Bv, Cv = proj[..., :16], proj[..., 16:]
    assert not xs.is_contiguous() and not Bv.is_contiguous()
    y, hl = k5.ssd(xs, dA, Bv, Cv, chunk=64)
    wy, wh = ref.ssd_ref(x, dA, Bm, Cm, 64)
    torch.testing.assert_close(y, wy, **K5_TOL)
    torch.testing.assert_close(hl, wh, **K5_TOL)


def test_ssd_kernel_reads_b_and_c_in_place_from_the_projection(cuda):
    """B and C as mamba_block takes them at mamba2-370m's widths: column
    slices of one (b, l, d_in + 2n) tensor (row stride 2,304 floats,
    offsets 2,048 and 2,176), read through 16-byte copies, no copy on the
    host; two chunks with h0."""
    b, l, H, p, n = 2, 512, 32, 64, 128
    x, dA, Bm, Cm, h0 = _k5_inputs(b, l, H, p, n, "model", True, cuda)
    xBC = torch.cat([x.reshape(b, l, H * p), Bm, Cm], dim=-1)
    Bv, Cv = xBC[..., H * p:H * p + n], xBC[..., H * p + n:]
    assert Bv.stride() == (l * 2304, 2304, 1)
    assert k5.aligned16(Bv, (0, 1)) and k5.aligned16(Cv, (0, 1))
    y, hl = k5.ssd(x, dA, Bv, Cv, chunk=256, h0=h0)
    wy, wh = ref.ssd_ref(x, dA, Bm, Cm, 256, h0)
    torch.testing.assert_close(y, wy, **K5_TOL)
    torch.testing.assert_close(hl, wh, **K5_TOL)


def test_ssd_kernel_copies_misaligned_inputs_by_element(cuda):
    """Inputs off 16-byte alignment take the kernels' 4-byte copies: p 10
    (rows 40 bytes apart), and B and C one float into their buffers."""
    b, l, H, p, n = 2, 128, 3, 10, 12
    x, dA, Bm, Cm, h0 = _k5_inputs(b, l, H, p, n, "model", True, cuda)
    buf = torch.empty(2 * Bm.numel() + 1, device=cuda)
    Bv = buf[1:1 + Bm.numel()].view(b, l, n).copy_(Bm)
    Cv = buf[1 + Bm.numel():].view(b, l, n).copy_(Cm)
    assert not k5.aligned16(x, (0, 1, 2)) and not k5.aligned16(Bv, (0, 1))
    y, hl = k5.ssd(x, dA, Bv, Cv, chunk=64, h0=h0)
    wy, wh = ref.ssd_ref(x, dA, Bm, Cm, 64, h0)
    torch.testing.assert_close(y, wy, **K5_TOL)
    torch.testing.assert_close(hl, wh, **K5_TOL)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dA, Bm, Cm, _ = _k5_inputs(1, 64, 2, 16, 8, "kernels", False, cuda)
    with pytest.raises(TypeError):
        k5.ssd(x.bfloat16(), dA, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        k5.ssd(x, dA, Bm.cpu(), Cm, chunk=32)
    with pytest.raises(ValueError):
        k5.ssd(x, dA, Bm, Cm, chunk=48)
    with pytest.raises(ValueError):
        k5.ssd(x, dA, Bm[..., :6], Cm[..., :6], chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        k5.ssd(x, dA, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm,
               chunk=32)
    with pytest.raises(TypeError):   # no bf16 backward: fp32 only
        k5.ssd(x.bfloat16().requires_grad_(True), dA, Bm, Cm, chunk=32)


# K6 cases (B, S, W, h0): chip_smoke.py's phase 3 without the serve
# shape: tests/test_kernels.py's three shapes with h0 and its no-h0
# case, ragged S and W, one step with h0, B * W under one block
K6_SHAPES = [(1, 128, 256, True), (2, 256, 512, True), (3, 64, 128, True),
             (2, 128, 128, False), (2, 200, 100, True), (4, 1, 300, True),
             (1, 33, 40, False)]


def _k6_inputs(B, S, W, h0, device, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W)))) * 0.2 + 0.79
    b = rng.standard_normal((B, S, W)) * 0.1
    out = [torch.from_numpy(x.astype(np.float32)).to(device) for x in (a, b)]
    return out + [torch.from_numpy(rng.standard_normal((B, W)).astype(
        np.float32)).to(device) if h0 else None]


def test_rglru_scan_kernel_matches_plain_version(cuda):
    """Bit for bit: the kernel rounds each product and each sum in the
    plain version's order (atol 1e-4 is tests/test_kernels.py's)."""
    for B, S, W, with_h0 in K6_SHAPES:
        a, b, h0 = _k6_inputs(B, S, W, with_h0, cuda)
        before = k6.rglru_scan.launches
        h, hl = ops.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        assert k6.rglru_scan.launches == before + 1
        assert h.shape == a.shape and tuple(hl.shape) == (B, W)
        wh, whl = ref.linear_scan_ref(a, b, h0)
        torch.testing.assert_close(h, wh, atol=1e-4, rtol=0)
        torch.testing.assert_close(hl, whl, atol=1e-4, rtol=0)
        assert torch.equal(h, wh) and torch.equal(hl, whl)


def test_rglru_scan_kernel_refuses_what_it_does_not_take(cuda):
    a, b, h0 = _k6_inputs(2, 16, 8, True, cuda)
    with pytest.raises(TypeError):
        k6.rglru_scan(a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):
        k6.rglru_scan(a, b.cpu())
    with pytest.raises(ValueError):
        k6.rglru_scan(a, b, h0[:, :4])
    with pytest.raises(ValueError):
        k6.rglru_scan(a[:, :0], b[:, :0])
    with pytest.raises(TypeError):   # no bf16 backward: fp32 only
        k6.rglru_scan(a.bfloat16().requires_grad_(True), b.bfloat16())


# K5 backward cases (b, l, H, p, n, chunk, dlogA, h0, dh_last): the train
# run's shape at batch 2, the test_kernels shapes with h0 and dh_last,
# one chunk, eight chunks, a ragged chunk, p 128, p 24 with n 4, 9 heads
# (a dx block of one head; second W and state head groups of one head),
# 17 heads (three groups), one head, and n 100 with a ragged chunk of 80
# (a column block of 36)
K5_BWD_SHAPES = [(2, 512, 32, 64, 128, 256, "model", False, False),
                 (2, 256, 4, 32, 16, 64, "kernels", True, True),
                 (1, 64, 1, 64, 32, 64, "kernels", False, True),
                 (1, 2048, 8, 64, 128, 256, "model", True, True),
                 (2, 100, 8, 64, 128, 256, "model", False, False),
                 (1, 256, 4, 128, 64, 128, "model", True, False),
                 (2, 192, 3, 24, 4, 64, "model", True, True),
                 (2, 192, 9, 16, 8, 64, "model", False, True),
                 (1, 192, 17, 8, 8, 64, "model", True, True),
                 (1, 128, 1, 32, 16, 64, "kernels", True, False),
                 (1, 160, 2, 24, 100, 80, "model", True, True)]
# each gradient against the plain version's as a share of its largest
# element: fp32 sums over up to 256 positions and the heads in another
# order than autograd's; d dlogA's row and column sums nearly cancel, so
# it is held to its largest element, not elementwise (as chip_smoke.py)
K5_BWD_TOL = 1e-4


def _k5_bwd_check(x, dA, Bm, Cm, chunk, h0, dy, dhl, want_inputs=None):
    """K5's backward (from the forward's workspaces) against its plain
    version on ``want_inputs`` (default the same tensors), each gradient
    within K5_BWD_TOL of its largest element, and a repeat bit for bit."""
    before = k5.ssd_bwd.launches
    _, _, cum, states = k5.ssd_with_work(x, dA, Bm, Cm, chunk=chunk, h0=h0)
    got = k5.ssd_bwd(x, dA, Bm, Cm, chunk, h0, dy, dhl, cum, states)
    torch.cuda.synchronize()
    assert k5.ssd_bwd.launches == before + 1
    wx, wdA, wB, wC, wh0 = want_inputs or (x, dA, Bm, Cm, h0)
    want = ref.ssd_bwd_ref(wx, wdA, wB, wC, chunk, wh0, dy, dhl)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.is_contiguous()
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K5_BWD_TOL)
    again = k5.ssd_bwd(x, dA, Bm, Cm, chunk, h0, dy, dhl, cum, states)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_backward_matches_plain_version(cuda):
    for b, l, H, p, n, chunk, dlogA, with_h0, with_dhl in K5_BWD_SHAPES:
        x, dA, Bm, Cm, h0 = _k5_inputs(b, l, H, p, n, dlogA, with_h0, cuda)
        rng = np.random.default_rng(1)
        dy = torch.from_numpy(rng.standard_normal((b, l, H, p)).astype(
            np.float32)).to(cuda)
        dhl = torch.from_numpy(rng.standard_normal((b, H, p, n)).astype(
            np.float32)).to(cuda) if with_dhl else None
        _k5_bwd_check(x, dA, Bm, Cm, chunk, h0, dy, dhl)


def test_ssd_backward_reads_views_and_misaligned_inputs(cuda):
    """x, B and C as column slices of one projection at mamba2-370m's
    widths (16-byte copies), and one float into their buffers at p 10
    (4-byte copies), as the forward reads them."""
    rng = np.random.default_rng(2)
    for b, l, H, p, n, off in ((2, 512, 32, 64, 128, 0),
                               (2, 128, 3, 10, 12, 1)):
        x, dA, Bm, Cm, h0 = _k5_inputs(b, l, H, p, n, "model", True, cuda)
        width = H * p + 2 * n
        buf = torch.empty(b * l * width + off, device=cuda)
        xBC = buf[off:].view(b, l, width)
        xBC.copy_(torch.cat([x.reshape(b, l, H * p), Bm, Cm], dim=-1))
        xv = xBC[..., :H * p].unflatten(-1, (H, p))
        Bv, Cv = xBC[..., H * p:H * p + n], xBC[..., H * p + n:]
        assert k5.aligned16(Bv, (0, 1)) == (off == 0)
        dy = torch.from_numpy(rng.standard_normal((b, l, H, p)).astype(
            np.float32)).to(cuda)
        dhl = torch.from_numpy(rng.standard_normal((b, H, p, n)).astype(
            np.float32)).to(cuda)
        _k5_bwd_check(xv, dA, Bv, Cv, 64, h0, dy, dhl,
                      want_inputs=(x, dA, Bm, Cm, h0))


def test_ssd_autograd_function_gives_the_plain_gradients(cuda):
    """Under autograd `ops.ssd` on CUDA tensors launches the forward once
    and the backward once; an unused h_last costs nothing; the
    gradients of x, dlogA, B, C and h0 are the plain version's."""
    x, dA, Bm, Cm, h0 = _k5_inputs(2, 256, 4, 32, 16, "model", True, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm, h0)]
    before = (k5.ssd.launches, k5.ssd_bwd.launches)
    y, _ = ops.ssd(*leaves[:4], chunk=64, h0=leaves[4])
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, dy)
    assert (k5.ssd.launches - before[0], k5.ssd_bwd.launches - before[1]) \
        == (1, 1)
    want = ref.ssd_bwd_ref(x, dA, Bm, Cm, 64, h0, dy, None)
    for g, w in zip(got, want):
        scale = w.abs().max()
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K5_BWD_TOL)
    with torch.no_grad():   # serving never enters the Function
        before = k5.ssd_bwd.launches
        ops.ssd(*leaves[:4], chunk=64, h0=leaves[4])
        assert k5.ssd_bwd.launches == before


# K6 backward cases (B, S, W, h0, dh_last): the train shape, ragged S
# and W, with and without h0 and dh_last, one step, and B W under one
# block
K6_BWD_SHAPES = [(4, 512, 4096, False, False), (2, 200, 100, True, True),
                 (2, 200, 100, False, True), (2, 200, 100, True, False),
                 (3, 64, 128, False, False), (4, 1, 300, True, True),
                 (1, 33, 40, True, True)]


def test_rglru_scan_backward_matches_plain_version(cuda):
    """Bit for bit: each product and sum rounded in the plain version's
    order, and every sum of two terms."""
    rng = np.random.default_rng(3)
    for B, S, W, with_h0, with_dhl in K6_BWD_SHAPES:
        a, b, h0 = _k6_inputs(B, S, W, with_h0, cuda)
        dh = torch.from_numpy(rng.standard_normal((B, S, W)).astype(
            np.float32)).to(cuda)
        dhl = torch.from_numpy(rng.standard_normal((B, W)).astype(
            np.float32)).to(cuda) if with_dhl else None
        h, _ = k6.rglru_scan(a, b, h0)
        before = k6.rglru_scan_bwd.launches
        got = k6.rglru_scan_bwd(a, h, h0, dh, dhl)
        torch.cuda.synchronize()
        assert k6.rglru_scan_bwd.launches == before + 1
        want = ref.linear_scan_bwd_ref(a, b, h0, dh, dhl)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
            assert torch.equal(g, w)


def test_rglru_scan_autograd_function_gives_the_plain_gradients(cuda):
    a, b, h0 = _k6_inputs(2, 200, 100, True, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    before = (k6.rglru_scan.launches, k6.rglru_scan_bwd.launches)
    h, h_last = ops.rglru_scan(*leaves)
    dh, dl = torch.randn_like(h), torch.randn_like(h_last)
    got = torch.autograd.grad((h, h_last), leaves, (dh, dl))
    assert (k6.rglru_scan.launches - before[0],
            k6.rglru_scan_bwd.launches - before[1]) == (1, 1)
    want = ref.linear_scan_bwd_ref(a, b, h0, dh, dl)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_blocked_prng_draw_is_the_same_bits_on_the_card(cuda, monkeypatch):
    """The card's blocked draw gives the CPU's bits (one whole draw),
    normals included."""
    want = prng.normal(prng.PRNGKey(3), (70, 9))
    monkeypatch.setattr(prng, "BLOCK", 64)
    got = prng.normal(prng.PRNGKey(3, device=cuda), (70, 9))
    bits = prng.random_bits(prng.PRNGKey(3, device=cuda), (70, 9))
    assert torch.equal(bits.cpu(), prng.random_bits(prng.PRNGKey(3),
                                                    (70, 9)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("arch, S, layers", [
    ("qwen3-0.6b", 16, None), ("h2o-danube-1.8b", 48, None),
    ("mamba2-370m", 512, 2), ("recurrentgemma-9b", 128, None)])
def test_decoder_loss_gradients_on_the_card_match_the_cpu(cuda, arch, S,
                                                          layers):
    """Reduced qwen3-0.6b, h2o-danube-1.8b (window 32 under 48 positions)
    and recurrentgemma-9b (rec, rec, attn; window 32 under 128), and
    mamba2-370m at full width cut to 2 layers (two chunks of 256), on the
    same weights: the loss and every gradient on the card (K4, K5 and K6
    forward and backward) against the CPU's plain versions (1e-4,
    relative to each gradient's largest element), with remat "full"
    launching each kernel's forward twice a layer and its backward
    once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd as k5
    from repro_torch.models import build_model

    wrappers = (k4.flash_attention, k4.flash_attention_bwd, k5.ssd,
                k5.ssd_bwd, k6.rglru_scan, k6.rglru_scan_bwd)
    cfg = get_config(arch)
    cfg = (cfg.replace(n_layers=layers) if layers else cfg.reduced()
           ).replace(dtype="float32")
    # drawn on the card (a full-width draw is slow on the CPU), copied
    card = build_model(cfg, device="meta", loss_chunks=4)
    params = card.init(prng.PRNGKey(1, device=cuda))
    cpu = build_model(cfg, device="meta", loss_chunks=4)
    cpu.load_state_dict({k: t.to("cpu", copy=True)
                         for k, t in params.items()}, assign=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, S + 1)))
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        before = [w.launches for w in wrappers]
        loss, _ = model.loss({"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (loss.detach().cpu(), [g.cpu() for g in grads],
                     [w.launches - n for w, n in zip(wrappers, before)])
    kinds = [type(layer).__name__ for layer in card.layers]
    per = {"DenseLayer": 0, "MambaLayer": 2, "RecLayer": 4}
    want = [0] * 6
    for kind in kinds:
        want[per[kind]] += 2
        want[per[kind] + 1] += 1
    assert out["cpu"][2] == [0] * 6
    assert out["card"][2] == want
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=0,
                               atol=1e-5)
    for g, w in zip(out["card"][1], out["cpu"][1]):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=1e-4)


# K4 at the vlm and moe families' shapes: internvl2-2b serves B 4 at S 768
# (256 vision positions and 512 tokens) and trains B 8 at the same S;
# qwen3-moe-30b-a3b serves and trains B 4 at S 512 with 32/4 heads (GQA
# ratio 8). (B, S, Hq, Hkv, hd)
K4_FAMILY_FWD = [(4, 768, 16, 8, 128), (4, 512, 32, 4, 128)]
K4_FAMILY_BWD = [(8, 768, 16, 8, 128), (4, 512, 32, 4, 128)]


@pytest.mark.parametrize("B, S, Hq, Hkv, hd", K4_FAMILY_FWD,
                         ids=["vlm serve", "moe serve"])
def test_flash_attention_kernel_at_the_vlm_and_moe_serve_shapes(
        cuda, B, S, Hq, Hkv, hd):
    q, k, v = _k4_inputs(B, S, S, Hq, Hkv, hd, "float32", cuda)
    before = k4.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert k4.flash_attention.launches == before + 1
    tol = K4_TOL["float32"]
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=tol, atol=tol)
    assert torch.equal(got, ops.flash_attention(q, k, v))


@pytest.mark.parametrize("B, S, Hq, Hkv, hd", K4_FAMILY_BWD,
                         ids=["vlm train", "moe train"])
def test_flash_attention_backward_at_the_vlm_and_moe_train_shapes(
        cuda, B, S, Hq, Hkv, hd):
    q, k, v = _k4_inputs(B, S, S, Hq, Hkv, hd, "float32", cuda)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    out, lse = k4.flash_attention_with_lse(q, k, v)
    before = k4.flash_attention_bwd.launches
    got = k4.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert k4.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, dout)
    for name, g, w in zip("qkv", got, want):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K4_BWD_TOL, msg=f"d{name}")
    again = k4.flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "internvl2-2b"])
def test_moe_and_vlm_serve_repeat_bit_for_bit_and_match_the_cpu(cuda, arch):
    """Reduced qwen3-moe-30b-a3b (4 experts top 2) and internvl2-2b (8
    seeded vision embeddings before the prompt) served twice on the card
    through
    `generate`, its decode under the no-sync fence: the same logits and
    tokens bit for bit, one K4 launch a layer in the prefill and none in
    decode; and the CPU's plain path on the same weights gives the same
    tokens, its prefill logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="meta")
    params = model.init(prng.PRNGKey(2, device=cuda))
    prompts = serve.make_prompts(cfg.vocab_size, 4, 64, 0, cuda)
    vision = None
    if cfg.family == "vlm":
        vision = torch.randn((4, cfg.n_vision_tokens, cfg.d_model),
                             generator=torch.Generator(device=cuda)
                             .manual_seed(5), device=cuda)
    before = k4.flash_attention.launches
    gen = serve.generate(model, params, prompts, 12, vision=vision)
    torch.cuda.synchronize()
    assert k4.flash_attention.launches == before + cfg.n_layers
    again = serve.generate(model, params, prompts, 12, vision=vision)
    assert torch.equal(gen.tokens, again.tokens)
    assert torch.equal(gen.prefill_logits, again.prefill_logits)
    assert torch.equal(gen.last_logits, again.last_logits)
    cpu = serve.generate(build_model(cfg, device="meta"),
                         {k: t.cpu() for k, t in params.items()},
                         prompts.cpu(), 12,
                         vision=None if vision is None else vision.cpu())
    torch.testing.assert_close(gen.prefill_logits.cpu(), cpu.prefill_logits,
                               rtol=0, atol=1e-4)
    assert torch.equal(gen.tokens.cpu(), cpu.tokens)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "internvl2-2b"])
def test_moe_and_vlm_loss_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Reduced qwen3-moe-30b-a3b and internvl2-2b (seeded vision
    embeddings) on the same weights: the loss, the router's aux and every
    gradient on the card (K4 forward and backward) against the CPU's
    plain versions (1e-4 of each gradient's largest element), K4's
    forward twice a layer and its backward once under remat "full"; a
    second call on the card gives the same loss and aux bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    card = build_model(cfg, device="meta", loss_chunks=4)
    params = card.init(prng.PRNGKey(1, device=cuda))
    cpu = build_model(cfg, device="meta", loss_chunks=4)
    cpu.load_state_dict({k: t.to("cpu", copy=True)
                         for k, t in params.items()}, assign=True)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 65)))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda),
                             ("again", card, cuda)):
        before = (k4.flash_attention.launches,
                  k4.flash_attention_bwd.launches)
        loss, aux = model.loss({k: t.to(dev) for k, t in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (loss.detach().cpu(), aux["aux"].detach().cpu(),
                     [g.cpu() for g in grads],
                     (k4.flash_attention.launches - before[0],
                      k4.flash_attention_bwd.launches - before[1]))
    assert out["cpu"][3] == (0, 0)
    assert out["card"][3] == (2 * cfg.n_layers, cfg.n_layers)
    assert torch.equal(out["card"][0], out["again"][0])
    assert torch.equal(out["card"][1], out["again"][1])
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out["card"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)
    for g, w in zip(out["card"][2], out["cpu"][2]):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)


# whisper-medium's attention (16 heads of 64, MHA): the encoder's
# non-causal self-attention over 1,500 frames (serve B 4), the
# cross-attention of a 224-token prompt and of a decode step against
# them, the decoder's causal self-attention; (B, Sq, Sk, causal, dtype)
K4_WHISPER_FWD = [(4, 1500, 1500, False, "float32"),
                  (4, 1500, 1500, False, "bfloat16"),
                  (4, 224, 1500, False, "float32"),
                  (4, 1, 1500, False, "float32"),
                  (4, 224, 224, True, "float32")]
# its train step's (B 8, 448 tokens): the encoder (5 slabs of 320 keys),
# the cross-attention (slabs of 1,152 and 348) and the decoder's causal
# self-attention (one slab); (B, Sq, Sk, causal)
K4_WHISPER_BWD = [(8, 1500, 1500, False), (8, 448, 1500, False),
                  (8, 448, 448, True)]


@pytest.mark.parametrize("B, Sq, Sk, causal, dtype", K4_WHISPER_FWD,
                         ids=["encoder", "encoder bf16", "cross",
                              "decode cross", "decoder self"])
def test_flash_attention_kernel_at_whisper_serve_shapes(cuda, B, Sq, Sk,
                                                        causal, dtype):
    q, k, v = _k4_inputs(B, Sq, Sk, 16, 16, 64, dtype, cuda)
    before = k4.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k4.flash_attention.launches == before + 1
    tol = K4_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, causal=causal).float(),
        rtol=tol, atol=tol)
    if dtype == "bfloat16":
        atol, rtol = K4_BF16_FP32_TOL
        torch.testing.assert_close(got.float(), ref.flash_attention_ref(
            q.float(), k.float(), v.float(), causal=causal), rtol=rtol,
            atol=atol)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("B, Sq, Sk, causal", K4_WHISPER_BWD,
                         ids=["encoder", "cross", "decoder self"])
def test_flash_attention_backward_at_whisper_train_shapes(cuda, B, Sq, Sk,
                                                          causal):
    plan = k4.backward_plan(B, Sq, Sk, 16, 16, 64, k4._sm_count(0))
    assert plan.n_slabs == {(1500, 1500): 5, (448, 1500): 2,
                            (448, 448): 1}[(Sq, Sk)]
    q, k, v = _k4_inputs(B, Sq, Sk, 16, 16, 64, "float32", cuda)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    out, lse = k4.flash_attention_with_lse(q, k, v, causal=causal)
    got = k4.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal)
    for name, g, w in zip("qkv", got, want):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K4_BWD_TOL, msg=f"d{name}")
    del want
    again = k4.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_whisper_serves_and_trains_on_the_card_as_on_the_cpu(cuda):
    """Reduced whisper-medium on the same weights, seeded frames: served
    twice through `generate` (3 K4 launches a layer pair in the prefill,
    one a decoder layer in each decode step under the no-sync fence; the
    same bits) and on the CPU (the same tokens, prefill logits within
    1e-4); the loss's gradients on the card within 1e-4 of each
    gradient's largest element of the CPU's, K4's forward 2 x 6 and its
    backward 6 times under remat "full"."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config("whisper-medium").reduced()
    L = cfg.n_layers + 2 * cfg.n_layers   # encoder, self and cross
    model = build_model(cfg, device="meta", loss_chunks=4)
    params = model.init(prng.PRNGKey(2, device=cuda))
    prompts = serve.make_prompts(cfg.vocab_size, 4, 24, 0, cuda)
    frames = torch.randn((4, cfg.n_audio_frames, cfg.d_model),
                         generator=torch.Generator(device=cuda).manual_seed(5),
                         device=cuda)
    before = k4.flash_attention.launches
    serve.prefill(model, prompts, 12, frames=frames)
    torch.cuda.synchronize()
    assert k4.flash_attention.launches == before + L
    before = k4.flash_attention.launches
    gen = serve.generate(model, params, prompts, 12, frames=frames)
    torch.cuda.synchronize()
    assert k4.flash_attention.launches == before + L + 11 * cfg.n_layers
    again = serve.generate(model, params, prompts, 12, frames=frames)
    assert torch.equal(gen.tokens, again.tokens)
    assert torch.equal(gen.last_logits, again.last_logits)
    cpu_params = {k: t.to("cpu", copy=True) for k, t in params.items()}
    cpu = build_model(cfg, device="meta", loss_chunks=4)
    cpu_gen = serve.generate(cpu, cpu_params, prompts.cpu(), 12,
                             frames=frames.cpu())
    torch.testing.assert_close(gen.prefill_logits.cpu(),
                               cpu_gen.prefill_logits, rtol=0, atol=1e-4)
    assert torch.equal(gen.tokens.cpu(), cpu_gen.tokens)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)))
    grads = {}
    for side, m, dev in (("cpu", cpu, "cpu"), ("card", model, cuda)):
        before = (k4.flash_attention.launches,
                  k4.flash_attention_bwd.launches)
        loss, _ = m.loss({"tokens": tokens.to(dev),
                          "frames": frames[:2].to(dev)})
        grads[side] = [g.cpu() for g in torch.autograd.grad(
            loss, list(m.parameters()))]
        torch.cuda.synchronize()
        launches = (k4.flash_attention.launches - before[0],
                    k4.flash_attention_bwd.launches - before[1])
        assert launches == ((0, 0) if side == "cpu" else (2 * L, L))
    for (name, _), g, w in zip(model.named_parameters(), grads["card"],
                               grads["cpu"]):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K4_BWD_TOL, msg=name)


# ------------------------------------------------------- the client mesh
@pytest.mark.parametrize("world, pods", [(2, 1), (4, 2)])
def test_sharded_mixes_on_the_card(cuda, tmp_path, world, pods):
    """K1-K3 on each rank's row block of the PaperCNN-width mix, the ranks
    on the one card (gloo between them): the dense mixes bit for bit the
    single-device launch's rows, the rotation within 1e-5 of the plain
    version, K2 once per visiting panel on every rank."""
    import torch_mesh_workers as workers

    from repro_torch.launch.mesh import run_on_client_mesh

    N, P = 32, 62006
    c = workers.op_case(N, P, 4, 6201, seed=3)
    got, counts = run_on_client_mesh(
        workers.mix_ops, world, pods=pods, device="cuda:0",
        init_file=str(tmp_path / "store"), timeout=600, args=([c],))[0]
    T = {k: torch.from_numpy(v).to(cuda) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    np.testing.assert_array_equal(
        got["graph_mix"], ops.graph_mix(T["A"], T["W"]).cpu().numpy())
    np.testing.assert_array_equal(
        got["compressed_graph_mix"], ops.compressed_graph_mix(
            T["A"], T["vals"], T["idx"], P).cpu().numpy())
    dec8 = T["q"].float() * T["scale"][:, None]
    for name, peers in (("sparse_graph_mix", T["W"]),
                        ("sparse_graph_mix_int8", dec8)):
        want = ref.sparse_graph_mix_ref(T["sw"], T["nw"], T["nbr"], T["W"],
                                        peers).cpu().numpy()
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-5)
    # per rank: K1 once, K2 once per visiting panel in each of the two
    # rotations, K3 once
    assert counts["launches"] == [[1, 2 * world, 1]] * world


# -------------------------------------------------------- the model axis
def test_psum_and_pmax_of_cuda_tensors_give_every_rank_the_same_bits(
        cuda, tmp_path):
    """gloo's all-reduce of CUDA tensors (`collectives.TRANSPORT`'s
    ("gloo", "all_reduce") row, "device") on a (1, 2) ("data", "model")
    mesh, the ranks on the one card: the sum and the maximum of each
    rank's seeded tensor, the same bits on both ranks."""
    import torch_mesh_workers as workers

    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.sharding.collectives import TRANSPORT

    assert TRANSPORT[("gloo", "all_reduce")] == "device"
    (psum, pmax), = [v for k, v in run_on_mesh(
        workers.reductions, (1, 2), ("data", "model"), device="cuda:0",
        init_file=str(tmp_path / "store"), timeout=600)[0].items()
        if k == ("model",)]
    x = np.stack([torch.randn((3, 5), generator=torch.Generator(
    ).manual_seed(r)).numpy() for r in range(2)])
    assert np.array_equal(psum[0], psum[1]) and np.array_equal(pmax[0],
                                                               pmax[1])
    np.testing.assert_allclose(psum[0], x.sum(0), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pmax[0], x.max(0))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_seqshard_decode_on_the_card_matches_one_device(cuda, tmp_path,
                                                        shape):
    """Reduced qwen3-0.6b decoded over a ring of 16 slots for 24 steps
    (it wraps) with the ring sharded over model: every step's logits
    within 1e-5 of the single-device decode on the card, the same greedy
    tokens, one pmax and two psums a layer a step."""
    import torch_mesh_workers as workers

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import build_model

    got, counts = run_on_mesh(
        workers.card_seqshard, shape, ("data", "model"), device="cuda:0",
        init_file=str(tmp_path / "store"), timeout=600,
        args=("qwen3-0.6b", 16, 24))
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg, device="meta")
    model.init(prng.PRNGKey(0, device=cuda))
    toks = torch.randint(0, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    want = []
    with torch.inference_mode():
        caches = model.init_cache(4, 16)
        for t in range(24):
            lg, caches = model.decode_step(caches, toks[:, t:t + 1], t)
            want.append(lg)
    want = torch.stack(want, 1).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert counts["pmax"][0] == cfg.n_layers
    assert counts["psum"][0] == 2 * cfg.n_layers


# ------------------------------------------------------------ the guards

# the small MLP setting of tests/test_round_engine.py (6 clients)
GUARD_DATA = dict(seed=5, n_clients=6, n_clusters=2,
                  partition="pathological", classes_per_client=3,
                  feature_dim=8, n_train=16, n_val=16, n_test=16, noise=2.0,
                  assign_level="cluster")


@pytest.mark.parametrize("name", ["item", "cpu", "as_tensor numpy",
                                  "tensor scalar", "python scalar operand",
                                  "pinned non_blocking to cuda"])
def test_fence_refuses_the_transfers_it_is_documented_to(cuda, name):
    """Each deliberate transfer of chip_smoke.py's `transfer_probes`
    inside ``no_transfer``: raises where its `TRANSFER_FENCED` says (CUDA's
    sync-debug error), passes where it does not; inside
    ``allow_transfers`` it passes; the mode is restored after."""
    from repro_torch.analysis import guards

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    probes = smoke.transfer_probes(torch, cuda)
    assert set(probes) == set(smoke.TRANSFER_FENCED)
    before = torch.cuda.get_sync_debug_mode()
    with guards.no_transfer(cuda):
        if smoke.TRANSFER_FENCED[name]:
            with pytest.raises(RuntimeError, match="synchroniz"):
                probes[name]()
        else:
            probes[name]()
        with guards.allow_transfers():
            probes[name]()
        assert torch.cuda.get_sync_debug_mode() == 2
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == before


def test_warm_dpfl_round_inside_the_fence(cuda):
    """A dense DPFL round (the small MLP engine on the card), warm, inside
    ``no_transfer`` and ``recompile_sentinel(expect_new=0)``: no host
    sync, no library built or loaded; then `run_dpfl` itself, whose
    rounds run inside `run_rounds`' fence."""
    from repro_torch.analysis import guards
    from repro_torch.core.dpfl import (DPFLConfig, dpfl_initial_state,
                                       dpfl_round_step, run_dpfl)
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP

    engine = FLEngine(MLP(8, 16, 10),
                      make_federated_classification(**GUARD_DATA), lr=0.05,
                      batch_size=8, device=cuda)
    cfg = DPFLConfig(rounds=3, tau_init=1, tau_train=1, budget=3, seed=0)
    state, _ = dpfl_initial_state(engine, cfg)
    step = dpfl_round_step(engine, cfg)
    state = step(state)                      # warm
    torch.cuda.synchronize()
    with guards.recompile_sentinel(expect_new=0), guards.no_transfer(cuda):
        state = step(state)
    torch.cuda.synchronize()
    assert state.t == 2
    with guards.recompile_sentinel(expect_new=0):
        res = run_dpfl(engine, cfg)
    assert len(res.comm_downloads) == 3


def test_serve_decode_runs_inside_the_fence(cuda):
    """`generate`'s decode loop on reduced qwen3-0.6b: every step inside
    the ``no_transfer`` fence, and a warm call builds and loads no
    library."""
    from repro_torch.analysis import guards
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import build_model

    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg, device="meta")
    params = model.init(prng.PRNGKey(0, device=cuda))
    prompts = make_prompts(cfg.vocab_size, 2, 16, 0, "cuda")
    first = generate(model, params, prompts, 6)
    modes = []
    step = model.decode_step

    def spy(*args, **kw):
        modes.append(torch.cuda.get_sync_debug_mode())
        return step(*args, **kw)

    model.decode_step = spy
    with guards.recompile_sentinel(expect_new=0):
        again = generate(model, None, prompts, 6)
    assert modes == [2] * 5
    assert torch.equal(first.tokens, again.tokens)


# K7, PaperCNN's convolution stack: (label, G, B, image, cin, c1, c2). The
# dense cell's reward call (400 probe models x 50 images), image 16, the
# tests' narrow widths, one input channel, one image, and G and B that
# no tile divides (a block takes at most 4 images)
K7_CASES = [("reward call", 400, 50, 32, 3, 6, 16),
            ("image 16", 7, 5, 16, 3, 6, 16),
            ("narrow", 6, 8, 16, 3, 4, 8),
            ("1 channel", 5, 6, 32, 1, 6, 16),
            ("narrow 1 channel", 3, 7, 16, 1, 4, 8),
            ("one image", 9, 1, 32, 3, 6, 16),
            ("ragged", 13, 9, 32, 3, 6, 16)]
#: of the largest feature: each output sums 75 or 150 fp32 products in
#: another order than the float64 plain version (cuDNN's fp32 reads
#: about 1e-7 of it)
K7_TOL = 1e-5


def _k7_inputs(G, B, image, cin, c1, c2, device, seed=0, probe_rows=False):
    """Seeded images and weights (biases non-zero). ``probe_rows``: the
    weights as views of one (G, P) panel, as the reward's probes are."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((G, B, image, image, cin), generator=gen, device=device)
    shapes = [(5, 5, cin, c1), (c1,), (5, 5, c1, c2), (c2,)]
    sizes = [int(np.prod(s)) for s in shapes]
    panel = 0.1 * torch.randn((G, sum(sizes) + 3), generator=gen,
                              device=device)
    if not probe_rows:
        panel = panel.contiguous()
    leaves = torch.split(panel[:, 3:] if probe_rows else panel[:, :sum(sizes)],
                         sizes, dim=1)
    ws = [leaf.reshape((G,) + s) for leaf, s in zip(leaves, shapes)]
    if not probe_rows:
        ws = [w.contiguous() for w in ws]
    return (x, *ws)


def _k7_check(args):
    from repro_torch.kernels import cnn_features as k7

    got = k7.cnn_features(*args)
    want = ref.cnn_features_ref(*[a.double() for a in args])
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= K7_TOL * scale, (err, scale)
    return got


@pytest.mark.parametrize("case", K7_CASES, ids=[c[0] for c in K7_CASES])
def test_cnn_features_kernel_matches_plain_version(cuda, case):
    """K7 against the plain version (grouped convolutions) in float64, one
    launch a call, and the same bits on a repeated call."""
    from repro_torch.kernels import cnn_features as k7

    _, G, B, image, cin, c1, c2 = case
    args = _k7_inputs(G, B, image, cin, c1, c2, cuda)
    before = k7.cnn_features.launches
    got = _k7_check(args)
    assert k7.cnn_features.launches == before + 1
    assert torch.equal(got, k7.cnn_features(*args))


def test_cnn_features_kernel_reads_probe_rows_and_strided_images(cuda):
    """Weights as views of one (G, P) panel (an odd offset: no 16-byte
    alignment) and images at a stride between models and between images
    (a view: the scalar staging path) give the contiguous inputs' bits."""
    from repro_torch.kernels import cnn_features as k7

    args = _k7_inputs(20, 6, 32, 3, 6, 16, cuda, seed=1, probe_rows=True)
    assert not args[1].is_contiguous()
    got = _k7_check(args)
    assert torch.equal(got, k7.cnn_features(
        *[a.contiguous() for a in args]))
    wide = torch.zeros((20, 7, 32, 32, 4), device=cuda)
    wide[:, :6, :, :, :3] = args[0]
    x = wide[:, :6, :, :, :3]
    assert not x.is_contiguous()
    with pytest.raises(ValueError):        # pixels not contiguous
        k7.cnn_features(x, *args[1:])
    wide = torch.zeros((20, 7, 32 * 32 * 3 + 1), device=cuda)
    wide[:, :6, 1:] = args[0].reshape(20, 6, -1)
    x = wide[:, :6, 1:].unflatten(2, (32, 32, 3))
    assert torch.equal(k7.cnn_features(x, *args[1:]), got)


def test_cnn_features_kernel_same_bits_alone_and_among_many(cuda):
    """A model's features are the same bits launched alone, among 400
    models, twice in a row, and for a prefix of its images (another
    tiling): each output is one thread's sum in a fixed order."""
    from repro_torch.kernels import cnn_features as k7

    args = _k7_inputs(400, 50, 32, 3, 6, 16, cuda, seed=2, probe_rows=True)
    many = k7.cnn_features(*args)
    assert torch.equal(many, k7.cnn_features(*args))
    for g in (0, 17, 399):
        alone = k7.cnn_features(*[a[g:g + 1] for a in args])
        assert torch.equal(alone[0], many[g])
    prefix = k7.cnn_features(args[0][:, :7], *args[1:])
    assert torch.equal(prefix, many[:, :7])


def test_cnn_features_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import cnn_features as k7

    args = _k7_inputs(4, 3, 32, 3, 6, 16, cuda)
    with pytest.raises(TypeError):
        k7.cnn_features(args[0].half(), *args[1:])
    with pytest.raises(TypeError):
        k7.cnn_features(*args[:3], args[3].double(), args[4])
    with pytest.raises(ValueError):     # images not contiguous
        k7.cnn_features(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError):     # a leaf not contiguous
        k7.cnn_features(args[0], args[1].transpose(1, 2), *args[2:])
    with pytest.raises(ValueError):     # no kernel for 5 channels
        k7.cnn_features(*_k7_inputs(4, 3, 32, 3, 5, 16, cuda))
    with pytest.raises(ValueError):     # no pooled conv2 output
        k7.cnn_features(*_k7_inputs(4, 3, 12, 3, 6, 16, cuda))
    with pytest.raises(ValueError):     # a CPU tensor among them
        k7.cnn_features(args[0].cpu(), *args[1:])


def test_papercnn_routes_inference_to_k7_and_training_to_cudnn(cuda):
    """On the card PaperCNN's no-grad forward launches K7 once, within
    K7_TOL of the training route's features; a forward whose leaves need
    a gradient launches none and differentiates as before."""
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.kernels import cnn_features as k7
    from repro_torch.models.classifier import PaperCNN

    model = PaperCNN(CNNConfig())
    keys = prng.split(prng.PRNGKey(0, device=cuda), 6)
    params = {k: torch.stack([model.init(keys[i])[k] for i in range(6)])
              for k in model.init(keys[0])}
    x = torch.randn((6, 10, 32, 32, 3), device=cuda)
    before = k7.cnn_features.launches
    with torch.no_grad():
        fast = model.features(params, x)
    assert k7.cnn_features.launches == before + 1
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        slow = model.features(leaves, x)
        slow.sum().backward()
    assert k7.cnn_features.launches == before + 1
    assert all(v.grad is not None for k, v in leaves.items()
               if k not in model.HEAD_KEYS)
    scale = slow.abs().max().item()
    assert (fast - slow.detach()).abs().max().item() <= K7_TOL * scale


def test_dense_and_sparse_ggc_select_the_same_on_the_card(cuda):
    """The dense and the sparse GGC, and BGGC, over the engine's reward on
    the card (PaperCNN, K7 in every reward call: N calls of 4N probe
    models a dense scan, one a slot a sparse one) select the same peers,
    bit for bit."""
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core import graph
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.kernels import cnn_features as k7
    from repro_torch.models.classifier import PaperCNN

    N, budget = 12, 3
    data = make_federated_classification(
        seed=3, n_clients=N, n_clusters=3, partition="pathological",
        classes_per_client=3, image_shape=(32, 32, 3), n_train=50,
        n_val=50, n_test=10, noise=1.0, assign_level="cluster")
    engine = FLEngine(PaperCNN(CNNConfig()), data, lr=0.05, batch_size=25,
                      device=cuda)
    stacked = engine.init_clients(prng.PRNGKey(0, device=cuda))
    trained, _ = engine.local_train(stacked, prng.PRNGKey(1, device=cuda),
                                    epochs=2)
    flat, p = engine.flatten(trained), engine.p
    reward = engine.make_reward_fn()
    key = prng.PRNGKey(7, device=cuda)
    before = k7.cnn_features.launches
    omega_dense = graph.all_clients_bggc(
        key, flat, p, torch.ones((N, N), dtype=torch.bool, device=cuda),
        reward, budget)
    omega_sparse = graph.all_clients_bggc_sparse(key, flat, p, reward,
                                                 budget)
    assert torch.equal(graph.adjacency_from_neighbors(omega_sparse, N),
                       omega_dense)
    cand = graph.neighbors_from_adjacency(omega_dense, budget)
    key = prng.PRNGKey(8, device=cuda)
    dense = graph.all_clients_graph(key, flat, p, omega_dense, reward,
                                    budget)
    launches = k7.cnn_features.launches
    sparse = graph.all_clients_graph_sparse(key, flat, p, cand, reward,
                                            budget)
    assert torch.equal(graph.adjacency_from_neighbors(sparse, N), dense)
    assert k7.cnn_features.launches - launches == budget
    assert launches > before + N


# K5 under torch.func.vmap over clients: (clients, b, l, H, p, n), the
# granite cell's local step and reward call (4 clients of 4 and of 4 x 2
# sequences of 512 at Granite-4.0-H's 64 heads of 64, state 128) and a
# small ragged case
K5_VMAP_SHAPES = [(4, 4, 512, 64, 64, 128), (1, 8, 512, 64, 64, 128),
                  (3, 2, 128, 5, 24, 20)]


@pytest.mark.parametrize("N, b, l, H, p, n", K5_VMAP_SHAPES)
def test_ssd_under_vmap_folds_the_clients(cuda, N, b, l, H, p, n):
    """One forward launch (and one backward call under autograd) on the
    folded (N b) batch, bit for bit the per-client launches, and the
    program's counters of its calls; the gradients within K5_BWD_TOL of
    the plain version's largest element."""
    from repro_torch import obs

    x, dA, Bm, Cm, _ = (t if t is None else t.unflatten(0, (N, b))
                        for t in _k5_inputs(N * b, l, H, p, n, "model",
                                            False, cuda))
    f = torch.func.vmap(lambda *t: ops.ssd(*t, chunk=256))

    def counts():
        return k5.ssd.launches, k5.ssd_bwd.launches
    before = counts()
    obs.reset()
    with torch.no_grad(), obs.tracing():
        y, h_last = f(x, dA, Bm, Cm)
    assert counts() == (before[0] + 1, before[1])
    assert obs.snapshot()["counts"] == {
        "k5.calls": 1, "k5.tokens": N * b * l, f"k5.seqs.l{l}": N * b}
    with torch.no_grad():
        each = [ops.ssd(x[i], dA[i], Bm[i], Cm[i], chunk=256)
                for i in range(N)]
    assert torch.equal(y, torch.stack([e[0] for e in each]))
    assert torch.equal(h_last, torch.stack([e[1] for e in each]))
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm)]
    dy = torch.randn(y.shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    before = counts()
    obs.reset()
    with obs.tracing():
        got = torch.autograd.grad(f(*leaves)[0], leaves, dy)
    assert counts() == (before[0] + 1, before[1] + 1)
    assert obs.snapshot()["counts"]["k5_bwd.calls"] == 1
    obs.reset()
    for i in range(N):
        li = [t[i].clone().requires_grad_(True) for t in (x, dA, Bm, Cm)]
        gi = torch.autograd.grad(ops.ssd(*li, chunk=256)[0], li, dy[i])
        assert all(torch.equal(a[i], c) for a, c in zip(got, gi))
    want = ref.ssd_bwd_ref(x.flatten(0, 1), dA.flatten(0, 1),
                           Bm.flatten(0, 1), Cm.flatten(0, 1), 256, None,
                           dy.flatten(0, 1), None)
    for g, w in zip(got, want):
        w = w.unflatten(0, (N, b))
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0,
                                   atol=K5_BWD_TOL)


def test_granite_model_on_the_card_matches_the_plain_reference(cuda):
    """A granite `DecoderLM` at Granite-4.0-H's head, state and chunk
    sizes (2 Mamba2 layers around an attention layer, d_model 512,
    vocabulary 1,000; K5 and K4 on the card, TF32 off) against the plain
    reference in float64 on the card: logits within 1e-4 of the largest,
    the loss within 1e-5 (relative), every gradient leaf within 1e-3 of
    its largest element; and the vmapped loss over 2 clients (one K4 and
    one K5 launch a layer) within 1e-6 of the per-client losses (cuBLAS
    picks other algorithms for the batched products than for one
    client's)."""
    from repro_torch.configs.granite_4_0_h_micro import CONFIG
    from repro_torch.fl.engine import vmap_clients
    from repro_torch.models import build_model, granite_ref
    from repro_torch.models.common import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIG.replace(n_layers=3, layer_types=("mamba", "attention",
                                                  "mamba"),
                         d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                         vocab_size=1000, dtype="float32")
    model = build_model(cfg, device="meta", remat="none", loss_chunks=1)
    params = model.init(prng.PRNGKey(0, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for v in params.values():
            if v.dim() == 1:
                v.add_(0.3 * torch.randn(v.shape, generator=g, device=cuda))
    named = dict(model.named_parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 513), generator=g,
                         device=cuda)
    wide = {k: v.detach().double() for k, v in named.items()}
    with torch.no_grad():
        x = model._embed(toks[:, :-1])
        h, _ = model._apply_stack(x, torch.arange(512, device=cuda))
        got = model._logits(rms_norm(h, model.final_norm, cfg.norm_eps))
        want = granite_ref.logits(wide, cfg, toks[:, :-1])
    scale = want.abs().max()
    torch.testing.assert_close(got.double() / scale, want / scale, rtol=0,
                               atol=1e-4)
    loss, _ = model.loss({"tokens": toks})
    grads = torch.autograd.grad(loss, list(named.values()))
    leaves = {k: v.clone().requires_grad_(True) for k, v in wide.items()}
    want_loss = granite_ref.loss(leaves, cfg, toks)
    want_grads = torch.autograd.grad(want_loss, list(leaves.values()))
    torch.testing.assert_close(loss.double(), want_loss, rtol=1e-5, atol=0)
    for k, a, w in zip(named, grads, want_grads):
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(a.double() / scale, w / scale, rtol=0,
                                   atol=1e-3, msg=k)
    stacked = {k: torch.stack([v.detach(), v.detach() * 0.9])
               for k, v in named.items()}
    batch = {"x": torch.stack([toks, toks.flip(0)])}
    before = (k4.flash_attention.launches, k5.ssd.launches)
    with torch.no_grad():
        losses = vmap_clients(model, lambda m, b: m.loss(
            {"tokens": b["x"]})[0])(stacked, batch)
    assert (k4.flash_attention.launches - before[0],
            k5.ssd.launches - before[1]) == (1, 2)
    for i in range(2):
        one = build_model(cfg, device="meta", remat="none", loss_chunks=1)
        one.load_state_dict({k: v[i] for k, v in stacked.items()},
                            assign=True)
        with torch.no_grad():
            torch.testing.assert_close(losses[i], one.loss(
                {"tokens": batch["x"][i]})[0], rtol=1e-6, atol=0)
