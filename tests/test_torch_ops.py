"""The port's binary-GEMM ops and flash attention against the reference.

The plain versions of ``bnn_matmul_packed`` and ``bnn_matmul_mxu`` are held
against the reference's Pallas kernels in interpret mode, bit for bit; the
four ``binary_matmul`` implementations and ``pack_weights`` are exact too.
The binary dense layers and ``ste_sign``'s gradient agree within 1e-6.

Flash attention's plain version is held against the reference's plain
causal attention (``layers/attention.py::chunked_attention``) and the
``naive`` formula of ``tests/test_flash_attention.py``, within 2e-3.  The
reference's Pallas flash kernel is not used: it calls ``pl.load``, which the
installed JAX no longer has.  The CUDA kernels are held against these plain
versions on a card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import bnn_matmul as tbnn
from repro_torch.kernels import bnn_matmul_mxu as tmxu
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.layers import attention as tattn

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bnn_matmul import bnn_matmul_packed as j_bnn_matmul_packed
from repro.kernels.bnn_matmul_mxu import bnn_matmul_mxu as j_bnn_matmul_mxu
from repro.layers import attention as jattn

IMPLS = ["ref", "packed_ref", "pallas_packed", "pallas_mxu"]


def _jit(fn, **static):
    """The reference function jitted with ``static`` bound."""
    return jax.jit(functools.partial(fn, **static))


def _sign_words(rng, rows, k):
    """(rows, ceil(k/32)) uint32 words of k random sign bits, zero-padded,
    with an all-ones first row and an all-zero second row."""
    bits = rng.integers(0, 2, (rows, k), dtype=np.uint64)
    bits[0], bits[1] = 1, 0
    pad = (-k) % 32
    bits = np.pad(bits, ((0, 0), (0, pad)))
    lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(rows, -1, 32) * lanes).sum(-1).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("k", [32, 100, 513])
def test_bnn_matmul_packed_plain_matches_pallas_kernel(k):
    rng = np.random.default_rng(k)
    x, w = _sign_words(rng, 8, k), _sign_words(rng, 16, k)
    kw = x.shape[1]
    want = j_bnn_matmul_packed(
        jnp.asarray(x), jnp.asarray(w), k_bits=k, block_m=8, block_n=16, block_kw=kw,
        interpret=True,
    )
    got = tbnn.bnn_matmul_packed(_i32(x), _i32(w), k_bits=k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the all-ones row against the all-zero row disagrees on every true bit
    assert got[0, 1] == -k and got[0, 0] == k


@pytest.mark.parametrize("k", [32, 100, 513])
@pytest.mark.parametrize("binarize", [True, False])
def test_bnn_matmul_mxu_plain_matches_pallas_kernel(k, binarize):
    rng = np.random.default_rng(k + binarize)
    x = rng.standard_normal((8, k)).astype(np.float32)
    if binarize:
        x[0, :3] = [0.0, -0.0, np.nan]  # -0.0 -> +1, NaN -> -1
    else:
        x = rng.integers(-8, 8, (8, k)).astype(np.float32)  # exact in any sum order
    w = np.where(rng.standard_normal((k, 16)) >= 0, 1.0, -1.0).astype(np.float32)
    want = j_bnn_matmul_mxu(
        jnp.asarray(x), jnp.asarray(w, jnp.bfloat16), binarize_x=binarize, block_m=8,
        block_n=16, block_k=k, interpret=True,
    )
    got = tmxu.bnn_matmul_mxu(
        torch.from_numpy(x), torch.from_numpy(w).to(torch.bfloat16), binarize_x=binarize
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [32, 100, 513])
@pytest.mark.parametrize("impl", IMPLS)
def test_binary_matmul_matches_reference(k, impl):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    w = rng.standard_normal((12, k)).astype(np.float32)
    want = _jit(jops.binary_matmul, implementation=impl)(jnp.asarray(x), jnp.asarray(w))
    got = tops.binary_matmul(torch.from_numpy(x), torch.from_numpy(w), implementation=impl)
    assert got.shape == (2, 5, 12) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 32, 100, 513])
def test_pack_weights_and_rows_match_reference(k):
    rng = np.random.default_rng(k)
    w = rng.standard_normal((7, k)).astype(np.float32)
    w[0, 0] = -0.0
    jw, jk = jops.pack_weights(jnp.asarray(w))
    tw, tk = tops.pack_weights(torch.from_numpy(w))
    assert tk == jk == k
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    np.testing.assert_array_equal(
        tops._pack_rows(torch.from_numpy(w)).numpy(),
        np.asarray(jops._pack_rows(jnp.asarray(w))).view(np.int32),
    )


def test_resolve_impl_picks_by_device():
    assert tops.resolve_impl("auto", "cpu") == jops.resolve_impl("auto") == "packed_ref"
    assert tops.resolve_impl("auto", "cuda") == "pallas_packed"
    assert tops.resolve_impl("pallas_mxu", "cpu") == "pallas_mxu"
    with pytest.raises(ValueError):
        tops.resolve_impl("xla")


@pytest.mark.parametrize("scale", ["weight_only", "xnor", "none"])
def test_binary_dense_matches_reference(scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 100)).astype(np.float32)
    w = (rng.standard_normal((24, 100)) * 0.1).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        tops.binary_dense_train(tx, tw, scale=scale).numpy(),
        np.asarray(jops.binary_dense_train(jnp.asarray(x), jnp.asarray(w), scale=scale)),
        rtol=1e-6, atol=1e-6,
    )
    for impl in IMPLS:
        np.testing.assert_allclose(
            tops.binary_dense_infer(tx, tw, scale=scale, implementation=impl).numpy(),
            np.asarray(jops.binary_dense_infer(jnp.asarray(x), jnp.asarray(w), scale=scale,
                                               implementation=impl)),
            rtol=1e-6, atol=1e-6,
        )
    with pytest.raises(ValueError):
        tops.binary_dense_train(tx, tw, scale="bogus")


def test_ste_sign_value_and_gradient_match_reference():
    rng = np.random.default_rng(4)
    v = rng.uniform(-2, 2, (5, 33)).astype(np.float32)
    v[0, :4] = [-1.0, 1.0, 0.0, -0.0]  # the clip edges pass the gradient
    c = rng.standard_normal(v.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jops.ste_sign(a) * jnp.asarray(c)))(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    out = tops.ste_sign(tv)
    (out * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jops.ste_sign(jnp.asarray(v))))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def test_plain_oracles_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, 70)).astype(np.float32)
    w = rng.standard_normal((11, 70)).astype(np.float32)
    alpha = np.abs(w).mean(-1).astype(np.float32)
    beta = np.abs(x).mean(-1, keepdims=True).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(tref.bnn_matmul_ref(tx, tw).numpy(),
                                  np.asarray(jref.bnn_matmul_ref(x, w)))
    np.testing.assert_array_equal(tref.bnn_matmul_mxu_ref(tx, tw).numpy(),
                                  np.asarray(jref.bnn_matmul_mxu_ref(x, w)))
    np.testing.assert_allclose(
        tref.xnor_dense_ref(tx, tw, torch.from_numpy(alpha), torch.from_numpy(beta)).numpy(),
        np.asarray(jref.xnor_dense_ref(x, w, alpha, beta)), rtol=1e-6, atol=1e-6,
    )


def test_kernel_wrappers_reject_bad_operands():
    z = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="K mismatch"):
        tbnn.bnn_matmul_packed(z, torch.zeros((3, 3), dtype=torch.int32), k_bits=64)
    with pytest.raises(ValueError, match="k_bits"):
        tbnn.bnn_matmul_packed(z, z, k_bits=65)
    with pytest.raises(ValueError, match="int32"):
        tbnn.bnn_matmul_packed(z.float(), z, k_bits=64)
    with pytest.raises(ValueError, match="bf16"):
        tmxu.bnn_matmul_mxu(torch.zeros((4, 8)), torch.zeros((8, 3)))
    q = torch.zeros((2, 5, 8))
    with pytest.raises(ValueError, match="shape"):
        tflash.flash_attention(q, q[:, :4], q)
    with pytest.raises(ValueError, match="float32 or all bf16"):
        tflash.flash_attention(q, q.double(), q)


def _naive(q, k, v, causal, scale):
    """``tests/test_flash_attention.py::naive``: (BH, S, D) softmax attention."""
    s = jnp.einsum("bqd,bkd->bqk", q, k).astype(jnp.float32) * scale
    if causal:
        n = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool))[None], s, -jnp.inf)
    return jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, -1).astype(q.dtype), v)


@pytest.mark.parametrize("shape", [(2, 128, 32), (3, 100, 96), (1, 257, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_naive(shape, causal):
    rng = np.random.default_rng(shape[1] + shape[2])
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / shape[2] ** 0.5
    want = _naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale)
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_flash_plain_bf16_matches_naive():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 128, 64)).astype(np.float32) for _ in range(3))
    want = _naive(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True, 1.0 / 8.0)
    got = tflash.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [2, 4])
def test_flash_full_matches_chunked_attention(causal, kvh):
    """GQA through ``_flash_full`` against the reference's plain attention."""
    rng = np.random.default_rng(kvh + 10 * causal)
    b, s, h, d = 2, 40, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32) for _ in range(2))
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_chunk=16, scale=0.25,
    )
    got = tattn._flash_full(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, scale=0.25)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
