"""Public binary-GEMM ops: packing, implementation dispatch, STE autodiff
(the reference's ``kernels/ops.py``).

Implementations (``implementation=``), under the reference's names:

  * ``"pallas_packed"`` — the bit-packed XNOR-popcount kernel
    (``bnn_matmul.bnn_matmul_packed``); weights packed offline.
  * ``"pallas_mxu"``    — the ±1 bf16 tensor-core kernel
    (``bnn_matmul_mxu.bnn_matmul_mxu``).
  * ``"packed_ref"``    — the same packed arithmetic in plain PyTorch.
  * ``"ref"``           — the ±1 matmul oracle.
  * ``"auto"``          — ``"pallas_packed"`` on a CUDA device, ``"packed_ref"``
    on the CPU (the reference picks by backend the same way).

The kernels take any M, N and K, so nothing here pads to tile multiples.
Training uses the straight-through estimator: :func:`ste_sign` is the only
custom-gradient primitive.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.bnn import binarize_ste
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bitpack import DTYPES, WORD, bitpack, pack_bits_words
from repro_torch.kernels.bnn_matmul import bnn_matmul_packed
from repro_torch.kernels.bnn_matmul_mxu import bnn_matmul_mxu

_VALID_IMPLS = ("pallas_packed", "pallas_mxu", "packed_ref", "ref", "auto")


def resolve_impl(implementation: str = "auto", device="cuda") -> str:
    """The implementation ``"auto"`` stands for on ``device``."""
    if implementation not in _VALID_IMPLS:
        raise ValueError(f"implementation must be one of {_VALID_IMPLS}")
    if implementation != "auto":
        return implementation
    return "pallas_packed" if torch.device(device).type == "cuda" else "packed_ref"


def _pack_rows(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits (``x >= 0``, ``bitops.sign_bit``) of (M, K) rows
    into (M, ceil(K/32)) int32 word views, zero bits padding the last word.

    On a CUDA tensor this is one launch of the bit-pack kernel: ``bitpack``
    when K is a multiple of 32 (float32, bf16 and int32 as they come; other
    types widened to float32, which keeps every sign bit), else
    ``pack_bits_words`` on the {0,1} bits.  On the meta device (the
    shape-only parameters of ``models.init_params``) it only gives the
    words their shape: nothing is packed and no kernel launches.
    """
    if x.device.type == "meta":
        return torch.empty((x.shape[0], -(-x.shape[-1] // WORD)), dtype=torch.int32, device="meta")
    if x.shape[-1] % WORD == 0 and x.shape[-1]:
        return bitpack(x if x.dtype in DTYPES else x.float())
    return pack_bits_words(bitops.sign_bit(x).to(torch.int32))


def pack_weights(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pack a (N, K) ±1/real weight matrix into (N, ceil(K/32)) int32 word
    views.  Returns (packed, k_bits).  Done once, offline, for inference."""
    return _pack_rows(w), w.shape[1]


def binary_matmul(x: torch.Tensor, w: torch.Tensor, *, implementation: str = "auto") -> torch.Tensor:
    """``sign(x) @ sign(w).T`` — the N2Net contraction for real inputs.

    x: (..., M, K); w: (N, K).  Returns (..., M, N) float32.
    """
    impl = resolve_impl(implementation, x.device)
    lead = x.shape[:-2]
    m, k = x.shape[-2:]
    n = w.shape[0]
    x2 = x.reshape(-1, k)

    if impl == "ref":
        out = _ref.bnn_matmul_ref(x2, w)
    elif impl == "packed_ref":
        wp, _ = pack_weights(w)
        out = _ref.bnn_matmul_packed_ref(_pack_rows(x2), wp, k).float()
    elif impl == "pallas_packed":
        wp, _ = pack_weights(w)
        out = bnn_matmul_packed(_pack_rows(x2), wp, k_bits=k).float()
    else:  # pallas_mxu
        ws = _ref.sign(w, torch.bfloat16).T.contiguous()  # (K, N)
        out = bnn_matmul_mxu(x2 if x2.dtype == torch.bfloat16 else x2.float(), ws, binarize_x=True)
    return out.reshape(*lead, m, n)


# ---------------------------------------------------------------------------
# Straight-through estimator — the only custom-gradient primitive.
# ---------------------------------------------------------------------------

# sign(v) in ±1 with straight-through gradient (clipped at |v|<=1): the
# reference's name here for ``core.bnn.binarize_ste``, the one STE primitive.
ste_sign = binarize_ste


def binary_dense_train(x: torch.Tensor, w_latent: torch.Tensor, *, scale: str = "weight_only") -> torch.Tensor:
    """Differentiable binary dense for training (composes ste_sign + matmul).

    ``scale``:
      * "weight_only" — y = x @ (sign(w) * alpha).T, alpha = per-channel |w|
        mean.  Activations stay real (least lossy; LM default).
      * "xnor"        — y = sign(x) @ (sign(w) * alpha).T * beta,
        beta = per-row |x| mean (full XNOR-Net).
      * "none"        — unscaled fully-binary.
    """
    alpha = w_latent.abs().mean(-1)  # (N,)
    wb = ste_sign(w_latent)
    if scale == "weight_only":
        return x @ (wb * alpha[:, None]).T
    if scale == "xnor":
        beta = x.abs().mean(-1, keepdim=True)
        return (ste_sign(x) @ (wb * alpha[:, None]).T) * beta
    if scale == "none":
        return ste_sign(x) @ wb.T
    raise ValueError(f"unknown scale mode {scale!r}")


def binary_dense_infer(
    x: torch.Tensor, w_latent: torch.Tensor, *, scale: str = "weight_only",
    implementation: str = "auto",
) -> torch.Tensor:
    """Inference-path binary dense using the packed/tensor-core kernels."""
    alpha = w_latent.abs().mean(-1)
    if scale == "weight_only":
        # activations stay real, so this is a plain matmul with scaled signs
        ws = _ref.sign(w_latent, x.dtype) * alpha[:, None]
        dt = torch.promote_types(x.dtype, ws.dtype)  # as jnp promotes
        return x.to(dt) @ ws.to(dt).T
    out = binary_matmul(x, w_latent, implementation=implementation)
    if scale == "xnor":
        beta = x.abs().mean(-1, keepdim=True)
        out = out * alpha[None, :] * beta
    elif scale != "none":
        raise ValueError(f"unknown scale mode {scale!r}")
    return out


__all__ = [
    "binary_dense_infer",
    "binary_dense_train",
    "binary_matmul",
    "bitpack",
    "bnn_matmul_mxu",
    "bnn_matmul_packed",
    "pack_weights",
    "resolve_impl",
    "ste_sign",
]
