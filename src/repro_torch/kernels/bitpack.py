"""Bit packing: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/bitpack.py::bitpack`` and its
any-width front end ``pack_bits_words`` (source: ``csrc/bitpack.cu``).  Both
entry points pack a predicate per element into uint32 words in the
``lowering.pack_bit_rows`` layout (bit ``k`` -> word ``k // 32``, shift
``k % 32``) and return the words as int32 bit views:

* :func:`bitpack` packs ``x >= 0`` of float32 or int32 ``x`` whose width is
  a multiple of 32 (the sign of an activation tile);
* :func:`pack_bits_words` packs ``{0,1}`` int32 bits of any width, padding
  the last word with zero bits — the packed backend's parse step.

Both launch one kernel, and each wrapper counts its own launches
(``bitpack.launches``, ``pack_bits_words.launches``).  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build

WORD = 32

_P = ctypes.c_void_p
_SIGNATURES = {
    "pack_ge_f32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P], ctypes.c_int),
    "pack_ge_i32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
}


def num_words(n: int) -> int:
    """Words holding ``n`` bits (at least one, as ``pack_bit_rows``)."""
    return max(1, -(-n // WORD))


def pack_ge_plain(x: torch.Tensor, thr) -> torch.Tensor:
    """Plain version of both entry points: pack ``x >= thr`` row-wise."""
    m, n = x.shape
    bits = torch.zeros((m, num_words(n) * WORD), dtype=torch.int64, device=x.device)
    bits[:, :n] = x >= thr
    return bitops.u32_to_i32(bitops.pack_bits(bits))


def _pack_ge(x: torch.Tensor, thr, wrapper) -> torch.Tensor:
    what = wrapper.__name__
    if x.ndim != 2:
        raise ValueError(f"{what} expects a 2-D tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_ge_plain(x, thr)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    m, n = x.shape
    out = torch.empty((m, num_words(n)), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    fn = "pack_ge_f32" if x.dtype == torch.float32 else "pack_ge_i32"
    lib = _build.library("bitpack", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = getattr(lib, fn)(
            x.data_ptr(), out.data_ptr(), m, n, thr, _build.stream_of(x)
        )
    _build.check(lib, code, what)
    wrapper.launches += 1
    return out


def bitpack(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits (``x >= 0``) of float32/int32 ``x`` (M, K) into
    (M, K/32) words (``K % 32 == 0``)."""
    if x.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"bitpack takes float32 or int32, got {x.dtype}")
    if x.ndim == 2 and x.shape[1] % WORD:
        raise ValueError(f"K={x.shape[1]} must be a multiple of {WORD}")
    return _pack_ge(x, 0, bitpack)


bitpack.launches = 0


def pack_bits_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(M, N)`` {0,1} int32 bits into ``(M, ceil(N/32))`` words, zero
    bits padding the last word."""
    if bits.dtype != torch.int32:
        raise ValueError(f"pack_bits_words takes int32 bits, got {bits.dtype}")
    return _pack_ge(bits, 1, pack_bits_words)


pack_bits_words.launches = 0
