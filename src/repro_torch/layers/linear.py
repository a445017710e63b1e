"""Dense and BinaryDense projections (the reference's ``layers/linear.py``).

``BinaryDense`` is the paper's technique as a framework feature, in two
regimes selected by the architecture's ``QuantConfig``:

  * training (``bnn_weight_only`` / ``bnn_xnor``): latent full-precision
    master weights, binarized forward, straight-through gradients
    (``repro_torch.kernels.ops``).
  * inference (``bnn_packed``): weights are *stored* as packed sign words
    (32 weights per uint32 word, int32 bit views) plus a per-channel alpha;
    the contraction is XNOR + popcount + affine — N2Net's arithmetic.  On a
    CUDA tensor it is two kernel launches: ``bitpack`` packs the
    activations' signs (bf16 and float32 activations as they come) and
    ``bnn_matmul_packed`` contracts them with the weight words.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bnn_matmul import bnn_matmul_packed


def dense_init(
    generator: torch.Generator, in_dim: int, out_dim: int, *, std: float = 0.02,
    dtype=torch.float32, quant: QuantConfig | None = None, tag: str = "",
) -> dict:
    """Weights stored (out, in) — the kernels' (N, K) convention — on the
    generator's device.

    With packed quantization active for ``tag``, stores
    {w_packed: (out, ceil(in/32)) int32 word views, alpha: (out,) f32} instead.
    """
    w = torch.randn((out_dim, in_dim), generator=generator, device=generator.device) * std
    if quant is not None and quant.packed and tag in quant.targets:
        w_packed, _ = kops.pack_weights(w)
        return {"w_packed": w_packed, "alpha": w.abs().mean(-1)}
    return {"w": w.to(dtype)}


def _packed_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """XNOR-popcount contraction against packed weights (XNOR-Net scaling).

    x: (..., K) real -> binarized; w_packed: (N, Kw).  Returns (..., N) in
    x.dtype: ``dot * alpha * beta`` in float32, beta the rows' mean |x|.
    """
    wp = params["w_packed"]
    alpha = params["alpha"]
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    beta = x2.float().abs().mean(-1, keepdim=True)
    dot = bnn_matmul_packed(kops._pack_rows(x2), wp, k_bits=k).float()
    y = dot * alpha[None, :] * beta
    return y.reshape(*lead, wp.shape[0]).to(x.dtype)


def dense_apply(
    params: dict, x: torch.Tensor, *, quant: QuantConfig | None = None, tag: str = "",
) -> torch.Tensor:
    """y = x @ W.T, binarized when ``tag`` is in the quant targets.

    x: (..., K); W: (N, K); returns (..., N) in x.dtype.
    """
    if "w_packed" in params:
        return _packed_apply(params, x)
    w = params["w"]
    if quant is not None and quant.enabled and not quant.packed and tag in quant.targets:
        lead = x.shape[:-1]
        y = kops.binary_dense_train(
            x.reshape(-1, x.shape[-1]).float(), w.float(), scale=quant.scale,
        )
        return y.reshape(*lead, w.shape[0]).to(x.dtype)
    return x @ w.T.to(x.dtype)
