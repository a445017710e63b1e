"""Bit-packed XNOR-popcount GEMM: CUDA kernels + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/bnn_matmul.py::
bnn_matmul_packed`` (source: ``csrc/bnn_matmul.cu``).  Operands are sign bits
packed 32 to a uint32 word, carried as int32 bit views and zero-padded past
``k_bits`` in both operands::

    out[m, n] = 2 * sum_w popcount(~(x[m, w] ^ w[n, w])) - 2 * Kw * 32 + k_bits

(M, N) int32, exact.  Unlike the TPU kernel, any M, N and Kw are taken: the
kernels mask ragged edges themselves.  A CPU tensor runs the plain version
(``ref.bnn_matmul_packed_ref``); a CUDA tensor launches one of two kernels,
chosen by :func:`route`:

* ``"stream"``: M <= ``STREAM_MAX_M`` (decode), Kw a multiple of 4 and
  16-byte aligned operands: each weight row read once in 16-byte loads by a
  team of lanes, x staged in shared memory;
* ``"mma"``: every other shape (prefill, scoring, ragged Kw, sliced views):
  the words unpacked to +1/-1 int8 inside the kernel and summed by the
  int8 tensor cores (``wgmma`` s8 into s32), in MMA_BLOCK_M x
  :func:`mma_block_n` output tiles and K stages of MMA_STAGE_WORDS words.

``"tiled"``, the first design (popcounts in shared-memory tiles), is reached
only through ``_launch(..., "tiled")``, to time it in turns.  A launch that
fails raises; nothing falls back to another route.  Each launch is counted
in ``bnn_matmul_packed.launches`` and, by route, in
``bnn_matmul_packed.launches_by_route``.

:func:`bnn_matmul_packed_experts` is the same GEMM with an expert axis, the
batched packed expert contraction of ``layers/moe.py`` (the reference's jnp
``_packed_expert_mm``, ``src/repro/layers/moe.py:104-124``; no Pallas kernel):
the same kernels with the expert on grid.z, one C entry point per route,
the route picked by :func:`route` on one expert's (C, Kw).  It counts its own
launches the same way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bnn_matmul_packed_experts_ref, bnn_matmul_packed_ref
from repro_torch.roofline import kernels as costs, ops as op_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUTES = ("stream", "mma", "tiled")
_ENTRY = {path: f"bnn_matmul_packed_{path}" for path in ROUTES}
_EXPERT_ENTRY = {path: f"bnn_matmul_packed_experts_{path}" for path in ROUTES}
# The mma entry points take the tile width before the stream.
_SIGNATURES = {
    **{name: ([_P, _P, _P, _I, _I, _I, _I, *([_I] if path == "mma" else []), _P], _I)
       for path, name in _ENTRY.items()},
    **{name: ([_P, _P, _P, _I, _I, _I, _I, _I, *([_I] if path == "mma" else []), _P], _I)
       for path, name in _EXPERT_ENTRY.items()},
}

# The stream route's limits (csrc/bnn_matmul.cu): at most STREAM_MAX_M rows of
# x, staged whole in the default 48 KB of shared memory, read as 16-byte words.
STREAM_MAX_M = 16
_STREAM_X_BYTES = 48 * 1024
_ALIGN = 16

# The mma kernel's tiles (csrc/bnn_matmul.cu kMmaBM, kMmaStageWords): output
# rows a block, words of K a stage.  Its tile widths (the instantiated
# WgmmaS8 widths), widest first.
MMA_BLOCK_M = 128
MMA_STAGE_WORDS = 8
MMA_BLOCK_NS = (128, 64, 32)

# Row tiles sit on the mma kernel's grid.x (2^31 - 1 blocks), so M is
# bounded by the int the kernel indexes rows with (less a tile, so that the
# tile count cannot overflow).  The forced tiled route keeps its own limit:
# 65535 row blocks of 64 (grid.y).
_MAX_ROWS = 2**31 - 1 - MMA_BLOCK_M
# Experts on grid.z.
_MAX_EXPERTS = 65535


def route(x_packed: torch.Tensor, w_packed: torch.Tensor) -> str:
    """The kernel a CUDA launch on these (contiguous) operands takes:
    ``"stream"`` or ``"mma"``.  Pure: it reads shape and ``data_ptr``
    only, so it can be asked on any device."""
    m, kw = x_packed.shape
    if (1 <= m <= STREAM_MAX_M and kw % 4 == 0 and m * kw * 4 <= _STREAM_X_BYTES
            and x_packed.data_ptr() % _ALIGN == 0 and w_packed.data_ptr() % _ALIGN == 0):
        return "stream"
    return "mma"


def mma_block_n(m: int, n: int, experts: int, sms: int) -> int:
    """The mma kernel's output tile width for an (m, n) product per expert
    on a card of ``sms`` SMs: of MMA_BLOCK_NS, the one whose waves of one
    block an SM cost least, a wave of BN-wide tiles costing BN + 64 (a
    stage's products grow with BN; its barrier, A registers and packed
    copies do not); the widest on a tie.  Wide tiles unpack each weight
    word for fewer rows of x; narrow ones fill the card when M is a
    prefill's 16 to 128 rows (at N = 3072, 24 tiles of 128 would leave 108
    of 132 SMs idle).  Measured on an H100 (PERF.md section 6): 128 at M =
    2048 and at C = 160 experts, 32 or 64 at M = 128."""
    row_tiles = -(-m // MMA_BLOCK_M)

    def cost(bn: int) -> int:
        return -(-row_tiles * -(-n // bn) * experts // sms) * (bn + 64)

    return min(MMA_BLOCK_NS, key=cost)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tile_args(path: str, device, m: int, n: int, experts: int) -> tuple:
    """The mma entry points' tile width argument (none for other routes)."""
    return (mma_block_n(m, n, experts, _sm_count(device)),) if path == "mma" else ()


def _check_operands(x_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int) -> None:
    """The checks both wrappers make: int32 bit views of one K on one device."""
    kw, kw2 = x_packed.shape[-1], w_packed.shape[-1]
    if kw != kw2:
        raise ValueError(f"K mismatch: {kw} vs {kw2}")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise ValueError(
            f"packed operands are int32 bit views, got {x_packed.dtype}, {w_packed.dtype}"
        )
    if not 0 <= k_bits <= kw * 32:
        raise ValueError(f"k_bits={k_bits} outside [0, {kw * 32}]")
    if x_packed.device != w_packed.device:
        raise ValueError(f"x on {x_packed.device}, w on {w_packed.device}")
    if x_packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed GEMMs run on CPU or CUDA tensors, got {x_packed.device}")


def bnn_matmul_packed(
    x_packed: torch.Tensor, w_packed: torch.Tensor, *, k_bits: int
) -> torch.Tensor:
    """``sign(x) @ sign(w).T`` on packed operands.

    x_packed: (M, Kw) int32 views; w_packed: (N, Kw) int32 views;
    ``0 <= k_bits <= Kw * 32``.  Returns (M, N) int32.
    """
    if x_packed.ndim != 2 or w_packed.ndim != 2:
        raise ValueError("x_packed must be (M, Kw), w_packed (N, Kw)")
    (m, kw), n = x_packed.shape, w_packed.shape[0]
    _check_operands(x_packed, w_packed, k_bits)
    if x_packed.device.type == "cpu":
        return bnn_matmul_packed_ref(x_packed, w_packed, k_bits)
    _build.refuse_grad("bnn_matmul_packed", x_packed, w_packed)
    if m > _MAX_ROWS or kw >= 1 << 25:
        raise ValueError(f"M={m} or Kw={kw} is beyond the kernel's grid")
    x_packed, w_packed = x_packed.contiguous(), w_packed.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x_packed.device)
    if m == 0 or n == 0:
        return out
    if kw == 0:
        return out.fill_(k_bits)
    return _launch(x_packed, w_packed, out, k_bits, route(x_packed, w_packed))


def _launch(x_packed, w_packed, out, k_bits: int, path: str) -> torch.Tensor:
    """Launch route ``path``'s kernel on checked, contiguous operands."""
    m, kw = x_packed.shape
    lib = _build.library("bnn_matmul", _SIGNATURES)
    with torch.cuda.device(x_packed.device):
        code = getattr(lib, _ENTRY[path])(
            x_packed.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, out.shape[1], kw, k_bits,
            *_tile_args(path, x_packed.device, m, out.shape[1], 1), _build.stream_of(x_packed),
        )
    _build.check(lib, code, "bnn_matmul_packed")
    bnn_matmul_packed.launches += 1
    op_counts.charge("bnn_matmul_packed", costs.bnn_matmul_packed, m, out.shape[1], kw)
    bnn_matmul_packed.launches_by_route[path] += 1
    return out


def experts_route(x_packed: torch.Tensor, w_packed: torch.Tensor) -> str:
    """The kernel a CUDA launch of :func:`bnn_matmul_packed_experts` on these
    (contiguous, E >= 1) operands takes: :func:`route` on the first expert's
    (C, Kw) and (O, Kw); every expert's slice has its shape and alignment."""
    return route(x_packed[0], w_packed[0])


def bnn_matmul_packed_experts(
    x_packed: torch.Tensor, w_packed: torch.Tensor, *, k_bits: int
) -> torch.Tensor:
    """``sign(x[e]) @ sign(w[e]).T`` for every expert ``e`` on packed operands.

    x_packed: (E, C, Kw) int32 views; w_packed: (E, O, Kw) int32 views, both
    zero-padded past ``k_bits``; ``0 <= k_bits <= Kw * 32``.  Returns
    (E, C, O) int32.  A CPU tensor runs the plain version
    (``ref.bnn_matmul_packed_experts_ref``); a CUDA tensor launches the
    kernel on :func:`experts_route`'s route.
    """
    if x_packed.ndim != 3 or w_packed.ndim != 3:
        raise ValueError("x_packed must be (E, C, Kw), w_packed (E, O, Kw)")
    (e, c, kw), (e2, o, _) = x_packed.shape, w_packed.shape
    if e != e2:
        raise ValueError(f"expert count mismatch: {e} vs {e2}")
    _check_operands(x_packed, w_packed, k_bits)
    if x_packed.device.type == "cpu":
        return bnn_matmul_packed_experts_ref(x_packed, w_packed, k_bits)
    _build.refuse_grad("bnn_matmul_packed_experts", x_packed, w_packed)
    if e > _MAX_EXPERTS or c > _MAX_ROWS or kw >= 1 << 25:
        raise ValueError(f"E={e}, C={c} or Kw={kw} is beyond the kernel's grid")
    x_packed, w_packed = x_packed.contiguous(), w_packed.contiguous()
    out = torch.empty((e, c, o), dtype=torch.int32, device=x_packed.device)
    if out.numel() == 0:
        return out
    if kw == 0:
        return out.fill_(k_bits)
    return _launch_experts(x_packed, w_packed, out, k_bits, experts_route(x_packed, w_packed))


def _launch_experts(x_packed, w_packed, out, k_bits: int, path: str) -> torch.Tensor:
    """Launch route ``path``'s expert kernel on checked, contiguous operands."""
    e, c, kw = x_packed.shape
    lib = _build.library("bnn_matmul", _SIGNATURES)
    with torch.cuda.device(x_packed.device):
        code = getattr(lib, _EXPERT_ENTRY[path])(
            x_packed.data_ptr(), w_packed.data_ptr(), out.data_ptr(), e, c, out.shape[2], kw,
            k_bits, *_tile_args(path, x_packed.device, c, out.shape[2], e), _build.stream_of(x_packed),
        )
    _build.check(lib, code, "bnn_matmul_packed_experts")
    bnn_matmul_packed_experts.launches += 1
    op_counts.charge("bnn_matmul_packed_experts", costs.bnn_matmul_packed_experts, e, c, out.shape[2], kw)
    bnn_matmul_packed_experts.launches_by_route[path] += 1
    return out


bnn_matmul_packed.launches = 0
bnn_matmul_packed.launches_by_route = dict.fromkeys(ROUTES, 0)
bnn_matmul_packed_experts.launches = 0
bnn_matmul_packed_experts.launches_by_route = dict.fromkeys(ROUTES, 0)
