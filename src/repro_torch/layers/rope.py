"""Rotary position embeddings, full and partial (the reference's
``layers/rope.py``)."""
from __future__ import annotations

import torch


def rope_frequencies(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for a rot_dim-dimensional rotary block."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)


def rotate(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0,
    rotary_pct: float = 1.0,
) -> torch.Tensor:
    """Apply RoPE to ``x`` (..., S, H, D) at integer ``positions`` (..., S).

    ``rotary_pct < 1`` rotates only the leading ``pct * D`` dims, passing the
    rest through unchanged.
    """
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_frequencies(rot, theta, x.device)
    angles = positions[..., None].float() * inv            # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]                   # broadcast heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
