"""The port's flash attention (K4) against `repro`'s: on CPU tensors
`repro_torch.kernels.ops.flash_attention` takes the plain version, which
must match the Pallas kernel run in interpret mode at the shapes of
tests/test_kernels.py (fp32 2e-5, bf16 3e-2, its tolerances) and
`repro`'s reference at shapes the Pallas wrapper refuses (ragged S,
Sq != Sk, S = 1). The backward's plain version,
`ref.flash_attention_bwd_ref`, against ``jax.grad`` of `repro`'s
reference (GQA, window, ragged, non-causal; 2e-5 relative to each
gradient's largest element), and autograd through `ops.flash_attention`
against it. The CUDA kernels themselves are held to their plain
versions on the card by tests/test_torch_cuda.py and by
``chip_smoke.py``."""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_fa  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402

# tests/test_kernels.py's shapes: (B, S, Hq, Hkv, hd, window, bq, bk)
PALLAS_SHAPES = [
    (1, 128, 2, 2, 32, None, 64, 64),
    (2, 256, 4, 2, 64, None, 128, 64),
    (1, 256, 4, 1, 64, 96, 64, 64),      # MQA + sliding window
    (2, 128, 8, 4, 16, 64, 32, 32),
    (1, 512, 2, 2, 64, 128, 128, 128),
]
# shapes the Pallas wrapper refuses (blocks must divide S), held against
# repro's reference: (B, Sq, Sk, Hq, Hkv, hd, window)
REF_SHAPES = [
    (2, 200, 200, 4, 2, 64, None),       # ragged S
    (1, 200, 200, 4, 1, 64, 96),         # ragged S, MQA, window
    (1, 1, 1, 4, 2, 128, None),          # S = 1
    (1, 128, 256, 4, 2, 64, None),       # Sq != Sk, aligned positions
    (1, 250, 128, 2, 1, 80, 128),        # Sq > Sk, h2o-danube's head
    (1, 70, 70, 2, 1, 256, 64),          # recurrentgemma's local head
    (2, 33, 47, 6, 3, 112, 17),          # kimi's head, odd everything
]


def _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, Hq, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Sk, Hkv, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    return q, k, v


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,win,bq,bk", PALLAS_SHAPES)
def test_ops_flash_attention_cpu_matches_pallas(B, S, Hq, Hkv, hd, win, bq,
                                                bk):
    q, k, v = _qkv(B, S, S, Hq, Hkv, hd)
    want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=win, block_q=bq, block_k=bk,
                     interpret=True)
    got = ops.flash_attention(*_torch(q, k, v), causal=True, window=win)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_ops_flash_attention_cpu_bf16_matches_pallas():
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, seed=2)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = pallas_fa(jq, jk, jv, interpret=True)
    got = ops.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,win", REF_SHAPES)
def test_ops_flash_attention_cpu_matches_reference(B, Sq, Sk, Hq, Hkv, hd,
                                                   win):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=1)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=win)
    got = ops.flash_attention(*_torch(q, k, v), causal=True, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_version_is_attention_ref_over_aligned_positions():
    """Non-causal with a window, and the plain version equal to its
    definition bitwise."""
    from repro_torch.models.common import attention_ref

    q, k, v = _torch(*_qkv(2, 40, 40, 4, 2, 32, seed=3))
    got = ref.flash_attention_ref(q, k, v, causal=False, window=8)
    pos = torch.arange(40, dtype=torch.int32)
    want = attention_ref(q, k, v, pos, pos[None].expand(2, 40),
                         causal=False, window=8, q_chunk=1 << 30)
    assert torch.equal(got, want)
    jwant = jref.flash_attention_ref(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v)),
                                     causal=False, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_refuses_inputs_that_require_grad(dtype):
    """Inputs that require grad differentiate at either dtype (the name
    is kept from when bf16 ones were refused): on the CPU autograd
    follows the plain version (`flash_attention_bwd_ref`'s gradients, at
    bf16 with `repro`'s cast points, in the leaves' dtype), and the
    kernel wrapper launches or, on CPU tensors, raises for the device."""
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 1, 16), dtype=getattr(torch, dtype))
    for i, t in enumerate((q, k, v)):
        t.requires_grad_(True)
        out = ops.flash_attention(q, k, v)
        dout = torch.ones_like(out)
        got, = torch.autograd.grad(out, t, dout)
        assert got.dtype == t.dtype
        assert torch.equal(got, ref.flash_attention_bwd_ref(
            q, k, v, dout)[i])
        with pytest.raises(ValueError, match="CUDA"):
            k4.flash_attention(q, k, v)
        t.requires_grad_(False)
    with torch.no_grad():
        q.requires_grad_(True)
        ops.flash_attention(q * 1, k, v)   # no graph under no_grad


def test_kernel_wrapper_never_takes_the_plain_version():
    """On CPU tensors the wrapper raises (ops picks the plain version by
    device); it refuses what the kernel does not take before any build."""
    q, k, v = _torch(*_qkv(1, 8, 8, 4, 2, 16))
    before = k4.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention(q, k, v)
    with pytest.raises(TypeError):
        k4.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        k4.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        k4.flash_attention(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="match"):
        k4.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        k4.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                           v)
    with pytest.raises(ValueError, match="sees no key"):
        k4.flash_attention(q, k[:, :2], v[:, :2], window=4)
    with pytest.raises(ValueError, match="sees no key"):
        k4.flash_attention(q, k[:, :0], v[:, :0])
    assert k4.flash_attention.launches == before


# (B, Sq, Sk, Hq, Hkv, hd, causal, window): GQA, a window, ragged S,
# Sq != Sk, and non-causal with and without a window
BWD_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 70, 70, 4, 1, 64, True, 24),
    (2, 37, 37, 6, 3, 16, True, None),
    (1, 40, 56, 4, 2, 32, True, None),
    (1, 48, 48, 4, 2, 32, False, None),
    (1, 48, 40, 2, 2, 16, False, 12),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,win", BWD_SHAPES)
def test_backward_plain_version_matches_jax_grad(B, Sq, Sk, Hq, Hkv, hd,
                                                 causal, win):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=4)
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=win), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = ref.flash_attention_bwd_ref(*_torch(q, k, v, dout)[:3],
                                      torch.from_numpy(dout), causal=causal,
                                      window=win)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy() / np.abs(w).max(),
                                   w / np.abs(w).max(), rtol=0, atol=2e-5,
                                   err_msg=f"d{name}")


def test_backward_wrapper_never_takes_the_plain_version():
    """On CPU tensors the backward wrapper raises before any build, at
    either dtype, as do other dtypes and shapes that do not match the
    forward's."""
    q, k, v = _torch(*_qkv(1, 8, 8, 4, 2, 16))
    out, lse = torch.zeros_like(q), torch.zeros((1, 4, 8))
    before = k4.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention_bwd(q, k, v, out, lse, out)
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention_bwd_bf16(q.bfloat16(), k.bfloat16(),
                                    v.bfloat16(), out.bfloat16(), lse,
                                    out.bfloat16())
    with pytest.raises(TypeError, match="bf16"):
        k4.flash_attention_bwd_bf16(q, k, v, out, lse, out)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.flash_attention_bwd(q.half(), k.half(), v.half(), out, lse, out)
    with pytest.raises(ValueError, match="sees no key"):
        k4.flash_attention_bwd(q, k[:, :2], v[:, :2], out, lse, out,
                               window=4)
    assert k4.flash_attention_bwd.launches == before


def test_kernel_source_is_registered_for_nvcc():
    assert _build.SOURCES["flash_attention"] == "flash_attention.cu"
    assert (_build.CSRC / "flash_attention.cu").is_file()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for symbol in ("flash_attention_f32", "flash_attention_bf16",
                   "flash_attention_error_string"):
        assert f'extern "C" int {symbol}(' in src or \
            f'extern "C" const char* {symbol}(' in src
    assert _build.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert 'extern "C" int flash_attention_bwd_f32(' in src
    assert 'extern "C" const char* flash_attention_bwd_error_string(' in src
    # the bf16 backward: a source of its own, and the fp32 source builds
    # one element type
    assert "FA_BWD_BF16" not in src and "bfloat16" not in src
    assert _build.SOURCES["flash_attention_bwd_bf16"] == \
        "flash_attention_bwd_bf16.cu"
    src = (_build.CSRC / "flash_attention_bwd_bf16.cu").read_text()
    assert 'extern "C" int flash_attention_bwd_bf16(' in src
    assert 'extern "C" const char* flash_attention_bwd_bf16_error_string(' \
        in src
    assert "mma_bf16(" in src and "ldmatrix_x4_trans<" in src
    assert _build.library_path("flash_attention_bwd") != \
        _build.library_path("flash_attention_bwd_bf16")
