"""Plain PyTorch oracles for the binary-GEMM kernels (the reference's
``kernels/ref.py``).

They are the kernels' plain versions: the CPU path of every wrapper, and the
ground truth ``chip_smoke.py`` and the CUDA tests hold each kernel against on
the card.  Packed operands are uint32 sign words carried as int32 bit views
(``core/bitops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

WORD = 32

# Elements of the (rows, N, Kw) int64 intermediate the packed oracle builds
# at once; larger M is done in row chunks so the oracle fits device memory.
_CHUNK_ELEMENTS = 1 << 26


def bnn_matmul_packed_ref(
    x_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int
) -> torch.Tensor:
    """±1 GEMM on packed sign bits: ``out[m,n] = sum_k x[m,k] * w[n,k]``.

    ``x_packed``: (M, Kw) int32 views; ``w_packed``: (N, Kw) int32 views; both
    packed from ``k_bits`` genuine sign bits, zero-padded to ``Kw*32``.  Pad
    bits are 0 in both operands, so each contributes one agreement; the affine
    correction removes them:  ``dot = 2*acc - 2*Kw*32 + k_bits``.
    Returns (M, N) int32.
    """
    m, kw = x_packed.shape
    n = w_packed.shape[0]
    w = bitops.i32_to_u32(w_packed)[None, :, :]
    rows = max(1, _CHUNK_ELEMENTS // max(1, n * kw))
    out = torch.empty((m, n), dtype=torch.int32, device=x_packed.device)
    for r0 in range(0, m, rows):
        x = bitops.i32_to_u32(x_packed[r0:r0 + rows])[:, None, :]
        acc = bitops.hakmem_popcount(bitops.xnor(x, w)).sum(-1)
        out[r0:r0 + rows] = (2 * acc - 2 * kw * WORD + k_bits).to(torch.int32)
    return out


def bnn_matmul_packed_experts_ref(
    x_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int
) -> torch.Tensor:
    """:func:`bnn_matmul_packed_ref` for each expert: x_packed (E, C, Kw) and
    w_packed (E, O, Kw) int32 views -> (E, C, O) int32.  The plain version
    of ``bnn_matmul_packed_experts`` (the reference's ``_packed_expert_mm``
    before its affine, ``src/repro/layers/moe.py:120-123``)."""
    e, c, _ = x_packed.shape
    out = torch.empty((e, c, w_packed.shape[1]), dtype=torch.int32, device=x_packed.device)
    for i in range(e):
        out[i] = bnn_matmul_packed_ref(x_packed[i], w_packed[i], k_bits)
    return out


def sign(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``+1`` where ``x >= 0`` (so ``-0.0`` -> +1), else ``-1`` (NaN -> -1).

    A negative subnormal gives +1: the reference's signs are computed with
    subnormals flushed to zero (``bitops.sign_bit``)."""
    one = torch.ones((), dtype=dtype, device=x.device)
    return torch.where(bitops.sign_bit(x), one, -one)


def bnn_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """±1 GEMM oracle in plain arithmetic: sign(x) @ sign(w).T as float32.

    ``x``: (M, K) real; ``w``: (N, K) real.  Returns (M, N) float32 —
    identical to :func:`bnn_matmul_packed_ref` on the packed representations.
    """
    return sign(x) @ sign(w).T


def bnn_matmul_mxu_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for the tensor-core kernel: ±1 bf16 operands, f32 accumulation.

    ``x``: (M, K); ``w``: (N, K).  The ±1 products and their integer sums are
    exact in float32, so the float32 product equals the bf16 one.
    """
    return sign(x, torch.bfloat16).float() @ sign(w, torch.bfloat16).float().T


def xnor_dense_ref(
    x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
) -> torch.Tensor:
    """XNOR-Net style binary dense: scaled ±1 GEMM.

    ``alpha``: per-output-channel |w| mean (N,); ``beta``: per-row |x| mean
    (M, 1).  Either may be None (unscaled).
    """
    out = bnn_matmul_ref(x, w)
    if alpha is not None:
        out = out * alpha[None, :]
    if beta is not None:
        out = out * beta
    return out
