"""XNOR-popcount-threshold layer of the packed backend: CUDA kernel + plain
PyTorch version.

The reference computes this layer in jnp (``repro/dataplane/executor.py``,
``_packed_fn`` and ``_packed_scan_fn``) with ``jax.lax.population_count``;
PyTorch has no popcount op, so the port has a kernel (source:
``csrc/packed_layer.cu``).  For packet ``b`` and neuron ``j``::

    count = sum_w popcount(~(words[b, w] ^ weights[j, w]) & mask[j, w])
    out[b, j] = count >= thresholds[j]      # unsigned, {0,1} int32

All operands are int32 bit views of uint32.  Pad neurons carry the threshold
``0xFFFFFFFF`` (``-1`` as a bit view) and must never fire, so the compare is
unsigned on both paths.  A CPU tensor runs :func:`packed_layer_plain`; a
CUDA tensor launches the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build


_P = ctypes.c_void_p
_SIGNATURES = {
    "packed_layer": (
        [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
}


def _check_args(words, weights, mask, thresholds) -> None:
    if words.ndim != 2 or weights.ndim != 2:
        raise ValueError("words must be (batch, n_words), weights (n_out, n_words)")
    n_out, n_words = weights.shape
    if words.shape[1] != n_words or mask.shape != weights.shape or thresholds.shape != (n_out,):
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)}, weights {tuple(weights.shape)}, "
            f"mask {tuple(mask.shape)}, thresholds {tuple(thresholds.shape)}"
        )
    for t in (words, weights, mask, thresholds):
        if t.dtype != torch.int32:
            raise ValueError(f"packed_layer operands are int32 bit views, got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"operand on {t.device}, words on {words.device}")


def packed_layer(
    words: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """One packed BNN layer: (batch, n_words) input words -> (batch, n_out)
    {0,1} int32 output bits."""
    _check_args(words, weights, mask, thresholds)
    if words.device.type == "cpu":
        return packed_layer_plain(words, weights, mask, thresholds)
    if words.device.type != "cuda":
        raise ValueError(f"packed_layer runs on CPU or CUDA tensors, got {words.device}")
    n_out, n_words = weights.shape
    if (2 * n_out * n_words + n_out) * 4 > _build.MAX_SHARED_BYTES:
        raise ValueError(f"a {n_out}x{n_words}-word layer does not fit shared memory")
    words, weights, mask, thresholds = (
        t.contiguous() for t in (words, weights, mask, thresholds)
    )
    batch = words.shape[0]
    out = torch.empty((batch, n_out), dtype=torch.int32, device=words.device)
    if batch == 0 or n_out == 0:
        return out
    lib = _build.library("packed_layer", _SIGNATURES)
    with torch.cuda.device(words.device):
        code = lib.packed_layer(
            words.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            thresholds.data_ptr(), out.data_ptr(), batch, n_out, n_words,
            _build.stream_of(words),
        )
    _build.check(lib, code, "packed_layer")
    packed_layer.launches += 1
    return out


packed_layer.launches = 0


def packed_layer_plain(
    words: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    thresholds: torch.Tensor,
) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch (uint32 carriers), any device."""
    x = bitops.i32_to_u32(words)[:, None, :]
    w = bitops.i32_to_u32(weights)[None, :, :]
    m = bitops.i32_to_u32(mask)[None, :, :]
    count = bitops.hakmem_popcount(bitops.xnor(x, w) & m).sum(-1)
    return (count >= bitops.i32_to_u32(thresholds)[None, :]).to(torch.int32)
