"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where there is no CUDA card.
The file imports neither jax nor `repro`, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import graph_mix as k1

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
