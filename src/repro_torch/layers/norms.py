"""Normalization layers (the reference's ``layers/norms.py``)."""
from __future__ import annotations

import torch


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)
