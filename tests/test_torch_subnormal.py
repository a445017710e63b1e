"""Signs of subnormals, -0.0 and NaN: every float sign site of the port
against the reference, on the CPU.

The reference computes its signs with subnormals flushed to zero (XLA's CPU
backend, like the TPU, runs with flush-to-zero), so ``x >= 0`` is True for a
negative subnormal.  PyTorch keeps subnormals, so the port takes the sign
bit as ``x > -FLT_MIN`` (``repro_torch.core.bitops.sign_bit``).  Each input
here is random normal data from a seed with subnormals of both signs, the
boundary -FLT_MIN (a normal number: sign bit 0), ±0.0, NaN and ±inf planted
in known columns; both packages see the same numpy values.  Packing and
signs are compared exactly, the packed dense layer within the tolerance of
``tests/test_torch_lm.py``.  The CUDA sign sites are held against these
plain versions on a card by ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core import bitops as tbits
from repro_torch.kernels import bitpack as tbitpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.layers import linear as tlinear

from repro.configs.base import QuantConfig as JQuant
from repro.core import bitops as jbits
from repro.kernels import bitpack as jbitpack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import linear as jlinear

FLT_MIN = np.float32(2.0 ** -126)
# Planted values and the sign bit the reference gives each.
PLANTED = np.array([
    -1e-40,              # negative subnormal: flushed to -0.0 -> 1
    1e-40,               # positive subnormal -> 1
    -1e-45,              # the least negative subnormal -> 1
    -FLT_MIN * 0.5,      # negative subnormal -> 1
    -FLT_MIN,            # the greatest negative normal -> 0
    -0.0, 0.0,           # -> 1, 1
    np.nan,              # -> 0
    -np.inf, np.inf,     # -> 0, 1
], dtype=np.float32)
WANT_BITS = np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 1], dtype=bool)


def _planted(rows, k, seed):
    """(rows, k) float32 normal data with PLANTED in every third row, at
    columns starting at ``row % 7`` (so the planted values fall in several
    words and bit positions), and -1e-39 in every third column of row 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    for r in range(0, rows, 3):
        c = r % 7
        x[r, c:c + len(PLANTED)] = PLANTED[:k - c]
    if rows > 1:
        x[1, ::3] = -1e-39
    return x


def _bf16(x: np.ndarray):
    """The same bf16 bits for both packages: ``x`` rounded to nearest even,
    the planted subnormals still subnormal."""
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = tx.view(torch.int16).numpy().view(jnp.bfloat16)
    assert np.all(np.abs(jx[np.abs(x) < FLT_MIN].astype(np.float32)) < FLT_MIN)
    return jnp.asarray(jx), tx


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def test_planted_values_are_what_the_reference_says():
    got = np.asarray(_jit(lambda a: a >= 0)(jnp.asarray(PLANTED)))
    np.testing.assert_array_equal(got, WANT_BITS)
    np.testing.assert_array_equal(tbits.sign_bit(torch.from_numpy(PLANTED)).numpy(), WANT_BITS)
    bf = torch.from_numpy(PLANTED).to(torch.bfloat16)
    np.testing.assert_array_equal(tbits.sign_bit(bf).numpy(), WANT_BITS)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sign_bit_of_integers_is_x_ge_0(dtype):
    x = np.array([-(2 ** 31), -1, 0, 1, 2 ** 31 - 1], dtype=dtype)
    np.testing.assert_array_equal(tbits.sign_bit(torch.from_numpy(x)).numpy(), x >= 0)


def test_sign_to_bits_matches_reference():
    x = _planted(6, 40, seed=0)
    np.testing.assert_array_equal(
        tbits.sign_to_bits(torch.from_numpy(x)).numpy(),
        np.asarray(jbits.sign_to_bits(jnp.asarray(x))),
    )


@pytest.mark.parametrize("k", [32, 64, 256])
def test_bitpack_float32_matches_pallas_interpret(k):
    x = _planted(9, k, seed=k)
    want = jbitpack.bitpack(jnp.asarray(x), interpret=True)
    got = tbitpack.bitpack(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("k", [32, 64, 256])
def test_bitpack_bf16_matches_pallas_interpret(k):
    jx, tx = _bf16(_planted(9, k, seed=k + 1))
    want = jbitpack.bitpack(jx, interpret=True)
    got = tbitpack.bitpack(tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n", [10, 33, 100])
def test_pack_bits_words_of_signs_matches_pallas_interpret(n):
    x = _planted(7, n, seed=n)
    bits = np.asarray(jnp.asarray(x) >= 0).astype(np.int32)
    want = jbitpack.pack_bits_words(jnp.asarray(bits), interpret=True)
    got = tbitpack.pack_bits_words(tbits.sign_to_bits(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("k", [10, 32, 100, 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_rows_and_weights_match_reference(k, dtype):
    x = _planted(8, k, seed=k)
    jx, tx = _bf16(x) if dtype == "bfloat16" else (jnp.asarray(x), torch.from_numpy(x))
    np.testing.assert_array_equal(
        tops._pack_rows(tx).numpy(), np.asarray(_jit(jops._pack_rows)(jx)).view(np.int32)
    )
    jw, _ = _jit(jops.pack_weights)(jx)
    tw, _ = tops.pack_weights(tx)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))


@pytest.mark.parametrize("k", [32, 100])
def test_signs_and_oracles_match_reference(k):
    x, w = _planted(6, k, seed=k), _planted(12, k, seed=k + 5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        tref.sign(tx).numpy(), np.asarray(_jit(lambda a: jnp.where(a >= 0, 1.0, -1.0))(x))
    )
    np.testing.assert_array_equal(
        tref.bnn_matmul_ref(tx, tw).numpy(), np.asarray(_jit(jref.bnn_matmul_ref)(x, w))
    )
    np.testing.assert_array_equal(
        tref.bnn_matmul_mxu_ref(tx, tw).numpy(), np.asarray(_jit(jref.bnn_matmul_mxu_ref)(x, w))
    )
    np.testing.assert_array_equal(tops.ste_sign(tx).numpy(), np.asarray(_jit(jops.ste_sign)(x)))


@pytest.mark.parametrize("impl", ["ref", "packed_ref", "pallas_packed", "pallas_mxu", "auto"])
@pytest.mark.parametrize("k", [32, 100])
def test_binary_matmul_matches_reference(impl, k):
    x, w = _planted(5, k, seed=k + 2), _planted(12, k, seed=k + 3)
    want = _jit(jops.binary_matmul, implementation=impl)(jnp.asarray(x), jnp.asarray(w))
    got = tops.binary_matmul(torch.from_numpy(x), torch.from_numpy(w), implementation=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", ["weight_only", "xnor", "none"])
def test_binary_dense_train_matches_reference(scale):
    x, w = _planted(5, 64, seed=11), _planted(12, 64, seed=12)
    want = _jit(jops.binary_dense_train, scale=scale)(jnp.asarray(x), jnp.asarray(w))
    got = tops.binary_dense_train(torch.from_numpy(x), torch.from_numpy(w), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [64, 100])
def test_dense_apply_bnn_packed_matches_reference(k):
    quant = JQuant(mode="bnn_packed")
    p = _jit(jlinear.dense_init, in_dim=k, out_dim=48, quant=quant, tag="ffn")(jax.random.PRNGKey(k))
    x = _planted(6, k, seed=k + 9).reshape(2, 3, k)
    want = np.asarray(_jit(jlinear.dense_apply, quant=quant, tag="ffn")(p, jnp.asarray(x)))
    tp = {name: torch.from_numpy(np.array(v).view(np.int32) if v.dtype == jnp.uint32 else np.array(v))
          for name, v in p.items()}
    got = tlinear.dense_apply(tp, torch.from_numpy(x), quant=tbase.QuantConfig(mode="bnn_packed"), tag="ffn")
    scale = max(1.0, float(np.abs(want).max()))  # as tests/test_torch_lm.py::_close
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
