"""Port parity: ``repro_torch.core.bitops`` against ``repro.core.bitops``.

uint32 semantics on int64 carriers must equal the reference's uint32 jnp
arithmetic bit for bit, including the high-bit values (0x80000000,
0xFFFFFFFF) that ``XNOR_IMM``'s ``~imm`` immediates make routine, and
shifts of 32 or more.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import bitops as tb

from repro.core import bitops as jb

EDGES = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF, 0x55555555],
    np.uint64,
)


def _values(seed: int, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return np.concatenate([EDGES, rand]).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _j(a: np.ndarray):
    return jnp.asarray(a.astype(np.uint32))


def _eq(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(port.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("shift", [0, 1, 5, 16, 31, 32, 33, 40])
def test_shifts_match_uint32(shift):
    x = _values(shift)
    _eq(tb.shr(_t(x), shift), _j(x) >> jnp.uint32(shift))
    _eq(tb.shl(_t(x), shift), _j(x) << jnp.uint32(shift))


def test_shifts_by_per_element_amounts():
    x = _values(1, 71)
    k = np.random.default_rng(2).integers(0, 40, x.size).astype(np.uint32)
    _eq(tb.shr(_t(x), _t(k)), _j(x) >> _j(k))
    _eq(tb.shl(_t(x), _t(k)), _j(x) << _j(k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_ge_not_xnor(seed):
    a, b = _values(seed), _values(seed + 100)
    _eq(tb.add(_t(a), _t(b)), _j(a) + _j(b))
    _eq(tb.ge(_t(a), _t(b)), (_j(a) >= _j(b)).astype(jnp.uint32))
    _eq(tb.bit_not(_t(a)), ~_j(a))
    _eq(tb.xnor(_t(a), _t(b)), jb.xnor(_j(a), _j(b)))


@pytest.mark.parametrize("seed", [0, 1])
def test_hakmem_popcount(seed):
    x = _values(seed)
    _eq(tb.hakmem_popcount(_t(x)), jb.hakmem_popcount(_j(x)))
    with pytest.raises(TypeError):
        tb.hakmem_popcount(torch.zeros(3, dtype=torch.int32))


def test_int32_views_round_trip():
    x = _values(3)
    view = tb.u32_to_i32(_t(x))
    assert view.dtype == torch.int32
    np.testing.assert_array_equal(view.numpy(), x.view(np.int32))
    np.testing.assert_array_equal(tb.i32_to_u32(view).numpy(), x.astype(np.int64))
    assert int(tb.u32_to_i32(torch.tensor([0x80000000]))[0]) == -(1 << 31)
    assert int(tb.u32_to_i32(torch.tensor([0xFFFFFFFF]))[0]) == -1


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70, 96])
def test_pack_unpack_pad(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, n)).astype(np.int32)
    padded_t = tb.pad_to_word_multiple(torch.from_numpy(bits))
    padded_j = jb.pad_to_word_multiple(jnp.asarray(bits))
    _eq(padded_t, padded_j)
    words_t = tb.pack_bits(padded_t)
    _eq(words_t, jb.pack_bits(padded_j))
    _eq(tb.unpack_bits(words_t, count=n), jb.unpack_bits(jb.pack_bits(padded_j), count=n))
    # packing along a leading axis
    _eq(tb.pack_bits(padded_t.T.contiguous(), axis=0), jb.pack_bits(padded_j.T, axis=0))


def test_sign_maps_and_packed_dot():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 50)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1e-30]
    _eq(tb.sign_to_bits(torch.from_numpy(x)), jb.sign_to_bits(jnp.asarray(x)))
    b = rng.integers(0, 2, (4, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        tb.bits_to_sign(torch.from_numpy(b)).numpy(), np.asarray(jb.bits_to_sign(jnp.asarray(b)))
    )
    w = rng.integers(0, 2, (7, 50)).astype(np.int32)
    xp_t = tb.pack_bits(tb.pad_to_word_multiple(torch.from_numpy(b)))
    wp_t = tb.pack_bits(tb.pad_to_word_multiple(torch.from_numpy(w)))
    xp_j = jb.pack_bits(jb.pad_to_word_multiple(jnp.asarray(b)))
    wp_j = jb.pack_bits(jb.pad_to_word_multiple(jnp.asarray(w)))
    _eq(tb.packed_dot(xp_t[:, None, :], wp_t, 50), jb.packed_dot(xp_j[:, None, :], wp_j, 50))


def test_pack_rejects_ragged_width():
    with pytest.raises(ValueError):
        tb.pack_bits(torch.zeros((2, 33), dtype=torch.int32))
