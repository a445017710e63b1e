"""±1 binary GEMM on the tensor cores: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/bnn_matmul_mxu.py::
bnn_matmul_mxu`` (source: ``csrc/bnn_matmul_mxu.cu``): ``binarize(x) @ w``
with float32 accumulation, where x (M, K) is float32 or bf16 and w (K, N) is
bf16 (pre-binarized ±1 weights).  ``binarize_x=True`` takes the sign of x
(``x >= 0 -> +1``, else -1); ``False`` rounds x to bf16.  With ±1 operands
the result is exact, so kernel and plain version agree bit for bit.

Any M, N and K are taken (the kernels mask ragged edges).  A CPU tensor runs
:func:`bnn_matmul_mxu_plain`; a CUDA tensor launches one of two kernels,
chosen by :func:`route`:

* ``"tma"``: bf16 x with K and N multiples of 8 and 16-byte aligned
  operands (the model's path): wgmma fed by TMA;
* ``"staged"``: float32 x, ragged K or N, or a misaligned operand.

Each launch is counted in ``bnn_matmul_mxu.launches`` and, by route, in
``bnn_matmul_mxu.launches_by_route``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sign
from repro_torch.roofline import kernels as costs, ops as op_counts

_P = ctypes.c_void_p
_I = ctypes.c_int
# One C entry point per route (the staged route has one per type of x).
_TMA_ENTRY = "bnn_matmul_mxu_tma"
_STAGED_ENTRY = {torch.float32: "bnn_matmul_mxu_f32", torch.bfloat16: "bnn_matmul_mxu_bf16"}
_SIGNATURES = {
    name: ([_P, _P, _P, _I, _I, _I, _I, _P], _I) for name in (_TMA_ENTRY, *_STAGED_ENTRY.values())
}
ROUTES = ("tma", "staged")
_TMA_ALIGN = 16  # bytes: TMA's rule for a tensor's base address

# Row blocks of the staged kernel's grid (grid.y): at most 65535 tiles of 64 rows.
_MAX_ROWS = 65535 * 64


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA launch on these (contiguous) operands takes:
    ``"tma"`` or ``"staged"``.  Pure: it reads dtype, shape and ``data_ptr``
    only, so it can be asked on any device."""
    k, n = w.shape
    if (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and x.data_ptr() % _TMA_ALIGN == 0 and w.data_ptr() % _TMA_ALIGN == 0):
        return "tma"
    return "staged"


def bnn_matmul_mxu_plain(x: torch.Tensor, w: torch.Tensor, *, binarize_x: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 operands, float32 sums."""
    xb = sign(x, torch.bfloat16) if binarize_x else x.to(torch.bfloat16)
    return xb.float() @ w.float()


def bnn_matmul_mxu(x: torch.Tensor, w: torch.Tensor, *, binarize_x: bool = True) -> torch.Tensor:
    """``binarize(x) @ w`` with float32 accumulation.

    x: (M, K) float32/bf16; w: (K, N) bf16.  Returns (M, N) float32.
    """
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("x must be (M, K), w (K, N)")
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"K mismatch: {k} vs {k2}")
    if x.dtype not in _STAGED_ENTRY or w.dtype != torch.bfloat16:
        raise ValueError(f"x must be float32 or bf16 and w bf16, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return bnn_matmul_mxu_plain(x, w, binarize_x=binarize_x)
    if x.device.type != "cuda":
        raise ValueError(f"bnn_matmul_mxu runs on CPU or CUDA tensors, got {x.device}")
    _build.refuse_grad("bnn_matmul_mxu", x, w)
    if m > _MAX_ROWS:
        raise ValueError(f"M={m} is beyond the kernel's grid")
    x, w = x.contiguous(), w.contiguous()
    if k == 0:  # an empty sum: the one case no kernel writes
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    path = route(x, w)
    lib = _build.library("bnn_matmul_mxu", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = getattr(lib, _TMA_ENTRY if path == "tma" else _STAGED_ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, int(binarize_x),
            _build.stream_of(x),
        )
    _build.check(lib, code, "bnn_matmul_mxu")
    bnn_matmul_mxu.launches += 1
    op_counts.charge("bnn_matmul_mxu", costs.bnn_matmul_mxu, m, k, n)
    bnn_matmul_mxu.launches_by_route[path] += 1
    return out


bnn_matmul_mxu.launches = 0
bnn_matmul_mxu.launches_by_route = dict.fromkeys(ROUTES, 0)
