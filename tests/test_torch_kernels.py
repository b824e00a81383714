"""The port's graph_mix (K1) against `repro`'s: on CPU tensors
`repro_torch.kernels.ops.graph_mix` takes the plain version, which must
match the Pallas kernel run in interpret mode and `repro`'s reference
(fp32 1e-5, bf16 5e-2, as tests/test_kernels.py). The CUDA kernel itself
is held to its plain version on the card by tests/test_torch_cuda.py and
by ``chip_smoke.py``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.graph_mix import graph_mix as pallas_graph_mix  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import graph_mix as k1  # noqa: E402

# (M, N, P): M = 1 (one set sum), M = N (Eq. 4), M != N (a BGGC phase-1
# batch, a batch of clients), ragged P (not a multiple of the tile)
SHAPES = [(1, 6, 512), (6, 6, 512), (6, 3, 700), (4, 9, 2048 + 37),
          (9, 4, 1000)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(M, N, P, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.random((M, N)).astype(np.float32)
    A /= A.sum(axis=1, keepdims=True)
    W = rng.standard_normal((N, P)).astype(np.float32)
    return A, W


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ops_graph_mix_cpu_matches_repro(shape, dtype):
    M, N, P = shape
    A, W = _inputs(M, N, P, dtype)
    jW = jnp.asarray(W).astype(dtype)
    want_pallas = np.asarray(
        pallas_graph_mix(jnp.asarray(A), jW, interpret=True)
        .astype(jnp.float32))
    want_ref = np.asarray(jref.graph_mix_ref(jnp.asarray(A), jW)
                          .astype(jnp.float32))
    tW = torch.from_numpy(W).to(getattr(torch, dtype))
    before = k1.graph_mix.launches
    got = ops.graph_mix(torch.from_numpy(A), tW)
    assert k1.graph_mix.launches == before, "a CPU call launched the kernel"
    assert got.dtype == tW.dtype and tuple(got.shape) == (M, P)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want_pallas, rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=tol,
                               atol=tol)


def test_plain_version_is_fp32_matmul():
    A, W = _inputs(5, 5, 64, "float32")
    got = ref.graph_mix_ref(torch.from_numpy(A), torch.from_numpy(W))
    np.testing.assert_allclose(got.numpy(), A @ W, rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: it never computes on the CPU."""
    A, W = _inputs(3, 3, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        k1.graph_mix(torch.from_numpy(A), torch.from_numpy(W))


def test_build_module_imports_without_nvcc(monkeypatch):
    """`_build` imports with no toolkit; asking it to build then raises
    rather than falling back."""
    path = _build.library_path("graph_mix")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert _build.library_path("graph_mix") == path  # content-keyed
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", path.with_name("no-nvcc"))
    monkeypatch.setattr(_build, "library_path",
                        lambda name: path.with_name("absent-" + path.name))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["graph_mix"])
