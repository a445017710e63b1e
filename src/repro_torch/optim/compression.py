"""Error-feedback gradient compression on trees of tensors (the reference's
``optim/compression.py``).

The exchange it models, per leaf with a carried residual ``e``::

    c_t     = C(g_t + e_t)           # compress
    e_{t+1} = (g_t + e_t) - D(c_t)   # new residual
    exchange c_t, apply D(c_t)

Compressors:
  * ``sign``  — 1-bit sign with per-leaf L1 scale (32x smaller);
  * ``int8``  — linear quantization with per-leaf absmax scale (4x);
  * ``topk``  — magnitude top-k% sparsification (k/100 x).

One card exchanges nothing, so here the compressor is what the reference's
trainer applies between accumulation and the optimizer: the same
decompressed gradients and residuals.  ``torch.sign(0)`` is 0 and
``torch.round`` rounds half to even, as ``jnp.sign`` and ``jnp.round`` do;
``topk``'s threshold is the k-th largest |g|, which ``torch.topk`` gives
whatever its order among ties.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class Compressor:
    kind: str = "sign"        # sign | int8 | topk | none
    topk_frac: float = 0.01

    def init_error(self, params: Any) -> Any:
        return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    def _leaf(self, g: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        gf = g.float() + e
        if self.kind == "sign":
            dec = torch.sign(gf) * torch.mean(torch.abs(gf))
        elif self.kind == "int8":
            amax = torch.max(torch.abs(gf)) + 1e-12
            q = torch.clamp(torch.round(gf / amax * 127.0), -127, 127)
            dec = q * (amax / 127.0)
        elif self.kind == "topk":
            k = max(1, int(gf.numel() * self.topk_frac))
            flat = gf.reshape(-1)
            thresh = torch.topk(torch.abs(flat), k).values[-1]
            dec = torch.where(torch.abs(flat) >= thresh, flat, 0.0).reshape(gf.shape)
        else:
            raise ValueError(self.kind)
        return dec, gf - dec

    @torch.no_grad()
    def compress_decompress(self, grads: Any, error: Any):
        """-> (decompressed grads to exchange/apply, new error, bits ratio)."""
        if self.kind == "none":
            return grads, error, 1.0
        out = [self._leaf(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(error), strict=True)]
        dec = tree.unflatten(grads, [d for d, _ in out])
        err = tree.unflatten(error, [e for _, e in out])
        ratio = {"sign": 1 / 32, "int8": 1 / 4, "topk": self.topk_frac}[self.kind]
        return dec, err, ratio
