"""Feed-forward blocks: SwiGLU (gated) and GELU MLP (the reference's
``layers/ffn.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import dense_apply, dense_init


# XLA's float32 tanh is exactly +-1 from |a| >= 7.99881172180175781 on, so
# jax.nn.gelu gives -0.0 there: a +1 sign bit for a packed layer after it.
# torch.tanh only reaches +-1 near |a| = 9.01, leaving a tiny negative value
# (a -1 bit).  The port's GELU saturates where XLA's does.
_TANH_SATURATES = 7.99881172180175781


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), formula for formula."""
    a = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)
    t = torch.where(a.abs() >= _TANH_SATURATES, torch.sign(a), torch.tanh(a))
    return x * (0.5 * (1.0 + t))


def ffn_init(
    generator: torch.Generator, d: int, f: int, act: str, *, std: float = 0.02,
    dtype=torch.float32, quant=None,
) -> dict:
    kw = dict(std=std, dtype=dtype, quant=quant, tag="ffn")
    if act == "swiglu":
        return {
            "w_gate": dense_init(generator, d, f, **kw),
            "w_up": dense_init(generator, d, f, **kw),
            "w_down": dense_init(generator, f, d, **kw),
        }
    return {"w_in": dense_init(generator, d, f, **kw), "w_out": dense_init(generator, f, d, **kw)}


def ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = cfg.quant
    if "w_gate" in params:
        g = dense_apply(params["w_gate"], x, quant=q, tag="ffn")
        u = dense_apply(params["w_up"], x, quant=q, tag="ffn")
        h = F.silu(g.float()).to(x.dtype) * u
        return dense_apply(params["w_down"], h, quant=q, tag="ffn")
    h = dense_apply(params["w_in"], x, quant=q, tag="ffn")
    h = _gelu_tanh(h.float()).to(x.dtype)
    return dense_apply(params["w_out"], h, quant=q, tag="ffn")
