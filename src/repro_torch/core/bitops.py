"""Bit-level primitives used by N2Net, on uint32 values held in int64 tensors.

The reference computes in uint32.  PyTorch's ``torch.uint32`` supports almost
no arithmetic on the CPU (no ``>>``, ``>=``, ``+`` or ``~``), and it has no
popcount op.  So the port carries every uint32 value in an **int64 tensor
whose values lie in ``[0, 2**32)``** (an "int64 carrier").  On carriers:

* a right shift is logical, because the value is non-negative;
* ``>=`` is the unsigned compare;
* ``+`` needs a final ``& MASK32`` to wrap mod 2**32;
* ``~x`` is ``x ^ MASK32``;
* a left shift masks first, so no value ever leaves 32 bits.

Shifts by 32 or more give 0, as XLA's do.  Where a uint32 value is stored
compactly (register files and tables on the device, kernel operands) the port
keeps its **int32 bit view**; :func:`u32_to_i32` and :func:`i32_to_u32`
convert between the two forms without losing ``0x80000000`` or
``0xFFFFFFFF``.

Bit order convention: bit ``j`` of word ``i`` holds element ``32*i + j`` of
the unpacked vector (little-endian within a word).  ``pack_bits`` /
``unpack_bits`` are exact inverses under this convention.
"""
from __future__ import annotations

import torch

WORD = 32  # packing word width (uint32)
MASK32 = 0xFFFFFFFF
# The least positive normal float32, 2**-126.  bf16 has float32's exponent
# range and represents it exactly.
FLT_MIN = 2.0 ** -126

# HAKMEM / Hacker's-Delight tree-popcount masks, per level.
_POPCOUNT_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64 carrier) -> their int32 bit view."""
    x = x.to(torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit view -> uint32 values in an int64 carrier."""
    return x.to(torch.int64) & MASK32


def shr(x: torch.Tensor, k) -> torch.Tensor:
    """Logical ``x >> k``; 0 for ``k >= 32``."""
    k = torch.as_tensor(k, dtype=torch.int64, device=x.device).clamp(0, WORD)
    return x >> k


def shl(x: torch.Tensor, k) -> torch.Tensor:
    """``(x << k) mod 2**32``; 0 for ``k >= 32``."""
    k = torch.as_tensor(k, dtype=torch.int64, device=x.device).clamp(0, WORD)
    return (x & (MASK32 >> k)) << k


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b) mod 2**32``."""
    return (a + b) & MASK32


def ge(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a >= b`` as 0/1 in an int64 carrier."""
    return (a >= b).to(torch.int64)


def bit_not(x: torch.Tensor) -> torch.Tensor:
    """Bitwise ``~x`` in uint32."""
    return x ^ MASK32


def hakmem_popcount(x: torch.Tensor) -> torch.Tensor:
    """Tree popcount of uint32 carriers using only shift / AND / add.

    Mirrors the algorithm N2Net schedules onto RMT elements: level ``l``
    ANDs the two shifted copies with the level mask and adds partial counts.
    """
    if x.dtype != torch.int64:
        raise TypeError(f"hakmem_popcount expects an int64 carrier, got {x.dtype}")
    for level, mask in enumerate(_POPCOUNT_MASKS):
        x = (x & mask) + ((x >> (1 << level)) & mask)
    return x


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {0,1} (or boolean) tensor into uint32 words along ``axis``.

    The axis length must be a multiple of 32 (callers pad with
    ``pad_to_word_multiple`` first).  Returns int64 carriers.
    """
    axis = axis % bits.ndim
    n = bits.shape[axis]
    if n % WORD != 0:
        raise ValueError(f"pack axis length {n} not a multiple of {WORD}")
    bits = bits.movedim(axis, -1).to(torch.int64)
    grouped = bits.reshape(bits.shape[:-1] + (n // WORD, WORD))
    weights = 1 << torch.arange(WORD, device=bits.device)
    return (grouped * weights).sum(-1).movedim(-1, axis)


def unpack_bits(
    words: torch.Tensor, axis: int = -1, count: int | None = None
) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; optionally trim to ``count`` bits.

    ``words`` are int64 carriers; returns int32 {0,1}.
    """
    if words.dtype != torch.int64:
        raise TypeError(f"unpack_bits expects an int64 carrier, got {words.dtype}")
    axis = axis % words.ndim
    words = words.movedim(axis, -1)
    shifts = torch.arange(WORD, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    if count is not None:
        bits = bits[..., :count]
    return bits.movedim(-1, axis).to(torch.int32)


def pad_to_word_multiple(
    bits: torch.Tensor, axis: int = -1, value: int = 0
) -> torch.Tensor:
    """Pad the bit axis up to the next multiple of 32 with ``value``."""
    axis = axis % bits.ndim
    rem = (-bits.shape[axis]) % WORD
    if rem == 0:
        return bits
    pad_shape = list(bits.shape)
    pad_shape[axis] = rem
    pad = torch.full(pad_shape, value, dtype=bits.dtype, device=bits.device)
    return torch.cat([bits, pad], dim=axis)


def sign_bit(x: torch.Tensor) -> torch.Tensor:
    """The sign bit the reference gives ``x``: True where ``x >= 0``.

    The reference's signs are computed with subnormals flushed to zero (XLA's
    CPU backend and the TPU), so a negative subnormal counts as -0.0 and gets
    a True bit; PyTorch keeps subnormals.  For floating ``x`` the reference's
    bit is therefore ``x > -FLT_MIN``, which reads the value and not the
    floating-point mode: -0.0 gives True, NaN False.  Integer ``x`` is
    ``x >= 0``.
    """
    if not x.is_floating_point():
        return x >= 0
    if x.dtype == torch.float16:  # -FLT_MIN would round to -0.0 in half
        x = x.float()
    return x > -FLT_MIN


def sign_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Map a ±1 (or real) tensor to {0,1} int32 bits: bit = 1 iff x >= 0
    (:func:`sign_bit`)."""
    return sign_bit(x).to(torch.int32)


def bits_to_sign(b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Map {0,1} bits to ±1 values (0 -> -1, 1 -> +1)."""
    return (2 * b.to(torch.int32) - 1).to(dtype)


def xnor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitwise XNOR on packed uint32 carriers."""
    return bit_not(a ^ b)


def packed_dot(x_words: torch.Tensor, w_words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """±1 dot product of two packed sign vectors via XNOR + popcount.

    ``x_words``/``w_words``: int64 carriers whose last axis packs ``n_bits``
    sign bits, zero-padded in both operands (XNOR of the pad counts one
    agreement per pad bit, which is subtracted).  Returns
    ``2 * popcount(XNOR) - n_bits`` over the genuine positions, as int32.
    """
    agree = hakmem_popcount(xnor(x_words, w_words))
    total = agree.sum(-1)
    pad = x_words.shape[-1] * WORD - n_bits
    return (2 * (total - pad) - n_bits).to(torch.int32)
