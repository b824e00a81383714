"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where there is no CUDA card.
The file imports neither jax nor `repro`, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import compressed_graph_mix as k3
from repro_torch.kernels import graph_mix as k1
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_graph_mix as k2

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
