"""Bit packing: CUDA kernels + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/bitpack.py::bitpack`` and its
any-width front end ``pack_bits_words`` (source: ``csrc/bitpack.cu``).  Both
entry points pack a predicate per element into uint32 words in the
``lowering.pack_bit_rows`` layout (bit ``k`` -> word ``k // 32``, shift
``k % 32``) and return the words as int32 bit views:

* :func:`bitpack` packs the sign bits of float32, bf16 or int32 ``x`` whose
  width is a multiple of 32 (the sign of an activation tile; the TPU kernel
  takes bf16 and float32 as they come): 1 where ``x >= 0``.  On floats that
  is ``bitops.sign_bit``: the reference computes its signs with subnormals
  flushed to zero, so a negative subnormal packs as 1 (-0.0 as 1, NaN as 0);
* :func:`pack_bits_words` packs ``{0,1}`` int32 bits of any width, padding
  the last word with zero bits — the packed backend's parse step.

A CPU tensor runs the plain version (:func:`pack_ge_plain`); a CUDA tensor
launches one of two kernels, chosen by :func:`route`:

* ``"vec"``: the row width a multiple of the elements in 16 bytes (4 for
  float32 and int32, 8 for bf16) and a 16-byte aligned input: 16-byte loads,
  the lanes of a word combine their bits by warp shuffles, 16-byte stores;
* ``"scalar"``: ragged widths and misaligned views: one warp per word, one
  element a lane.

Each wrapper counts its launches in ``launches``, by route in
``launches_by_route`` and by input type in ``launches_by_dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build
from repro_torch.roofline import kernels as costs, ops as op_counts

WORD = 32
ROUTES = ("vec", "scalar")
_ALIGN = 16  # bytes a vec-route load reads
# The kernels index output words with 32-bit integers (element offsets are
# 64-bit).
_MAX_WORDS = 1 << 31

# The input types bitpack takes, and their names in the C entry points.
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "i32"}
_ENTRY = {(dtype, path): f"pack_ge_{name}_{path}" for dtype, name in DTYPES.items() for path in ROUTES}
_P = ctypes.c_void_p
_I = ctypes.c_int
# (x, out, m, n[, thr], stream): only the int32 kernels take a threshold.
_SIGNATURES = {
    name: ([_P, _P, _I, _I, *([_I] if dtype == torch.int32 else []), _P], _I)
    for (dtype, _), name in _ENTRY.items()
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def num_words(n: int) -> int:
    """Words holding ``n`` bits (at least one, as ``pack_bit_rows``)."""
    return max(1, -(-n // WORD))


def route(x: torch.Tensor) -> str:
    """The kernel a CUDA launch on this (contiguous) input takes: ``"vec"``
    or ``"scalar"``.  Pure: it reads dtype, shape and ``data_ptr`` only, so
    it can be asked on any device."""
    n = x.shape[-1]
    per_load = _ALIGN // x.element_size()
    if n and n % per_load == 0 and x.data_ptr() % _ALIGN == 0:
        return "vec"
    return "scalar"


def pack_ge_plain(x: torch.Tensor, thr: int = 0) -> torch.Tensor:
    """Plain version of both entry points: pack, row-wise, the sign bits of
    floating ``x`` (``thr`` must be 0) or ``x >= thr`` of integer ``x``."""
    if x.is_floating_point():
        if thr != 0:
            raise ValueError(f"floats pack their sign bits (thr 0), got thr={thr}")
        pred = bitops.sign_bit(x)
    else:
        pred = x >= thr
    m, n = x.shape
    bits = torch.zeros((m, num_words(n) * WORD), dtype=torch.int64, device=x.device)
    bits[:, :n] = pred
    return bitops.u32_to_i32(bitops.pack_bits(bits))


def _pack(x: torch.Tensor, thr: int, wrapper) -> torch.Tensor:
    what = wrapper.__name__
    if x.ndim != 2:
        raise ValueError(f"{what} expects a 2-D tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_ge_plain(x, thr)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {x.device}")
    _build.refuse_grad(what, x)
    x = x.contiguous()
    m, n = x.shape
    out = torch.empty((m, num_words(n)), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    if m * out.shape[1] >= _MAX_WORDS:
        raise ValueError(f"{what}: a ({m}, {n}) input is beyond the kernels' 32-bit word indices")
    return _launch(x, out, thr, route(x), wrapper)


def _launch(x: torch.Tensor, out: torch.Tensor, thr: int, path: str, wrapper) -> torch.Tensor:
    """Launch route ``path``'s kernel on a checked, contiguous ``x`` into
    ``out``, counting the launch on ``wrapper``."""
    m, n = x.shape
    lib = _build.library("bitpack", _SIGNATURES)
    args = (x.data_ptr(), out.data_ptr(), m, n, *((thr,) if x.dtype == torch.int32 else ()))
    with torch.cuda.device(x.device):
        code = getattr(lib, _ENTRY[x.dtype, path])(*args, _build.stream_of(x))
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    op_counts.charge(wrapper.__name__, costs.bitpack, m, n, x.element_size())
    wrapper.launches_by_route[path] += 1
    wrapper.launches_by_dtype[_dtype_name(x.dtype)] += 1
    return out


def bitpack(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits (``x >= 0``, ``bitops.sign_bit``) of float32, bf16
    or int32 ``x`` (M, K) into (M, K/32) words (``K % 32 == 0``)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"bitpack takes float32, bfloat16 or int32, got {x.dtype}")
    if x.ndim == 2 and x.shape[1] % WORD:
        raise ValueError(f"K={x.shape[1]} must be a multiple of {WORD}")
    return _pack(x, 0, bitpack)


def pack_bits_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(M, N)`` {0,1} int32 bits into ``(M, ceil(N/32))`` words, zero
    bits padding the last word."""
    if bits.dtype != torch.int32:
        raise ValueError(f"pack_bits_words takes int32 bits, got {bits.dtype}")
    return _pack(bits, 1, pack_bits_words)


for _wrapper in (bitpack, pack_bits_words):
    _wrapper.launches = 0
    _wrapper.launches_by_route = dict.fromkeys(ROUTES, 0)
    _wrapper.launches_by_dtype = dict.fromkeys(map(_dtype_name, DTYPES), 0)
del _wrapper
