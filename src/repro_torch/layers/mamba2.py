"""Mamba2 block with the SSD (state-space duality) algorithm (the reference's
``layers/mamba2.py``).

Chunked formulation: the sequence is split into chunks of ``cfg.ssm.chunk``;
within a chunk the recurrence is computed in its closed quadratic
(attention-like) form, and across chunks a loop carries the (H, N, P) state
(the reference's ``lax.scan``).  A single-token decode step is the O(1)
recurrence update.  Plain PyTorch throughout: the reference computes the SSD
with jnp einsums outside Pallas, and never packs a Mamba2 projection.

ngroups == 1 (B/C shared across heads), as in the assigned configs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import dense_apply, dense_init
from repro_torch.layers.norms import rmsnorm, rmsnorm_init


@dataclasses.dataclass
class SsmCache:
    """h: (L, B, H, N, P) SSD state in float32; conv_x/conv_bc: (L, B, W-1, ·)
    window tails in the param dtype; ``index``: tokens seen."""

    h: torch.Tensor
    conv_x: torch.Tensor
    conv_bc: torch.Tensor
    index: int

    @staticmethod
    def init(cfg: ModelConfig, batch: int, layers: int, device="cuda") -> "SsmCache":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        heads = d_inner // s.head_dim
        dtype = cfg.param_dtype()
        return SsmCache(
            h=torch.zeros((layers, batch, heads, s.state_dim, s.head_dim), dtype=torch.float32,
                          device=device),
            conv_x=torch.zeros((layers, batch, s.conv_width - 1, d_inner), dtype=dtype, device=device),
            conv_bc=torch.zeros((layers, batch, s.conv_width - 1, 2 * s.state_dim), dtype=dtype,
                                device=device),
            index=0,
        )


def mamba2_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """z / x / bc / dt / out projections stored separately, each a plain
    ``dense_init`` (never packed).  ``A_log``, ``D`` and ``dt_bias`` are
    float32 whatever ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    heads = d_inner // s.head_dim
    dev = generator.device
    p = {
        "z_proj": dense_init(generator, d, d_inner, std=cfg.init_std, dtype=dtype),
        "x_proj": dense_init(generator, d, d_inner, std=cfg.init_std, dtype=dtype),
        "bc_proj": dense_init(generator, d, 2 * s.state_dim, std=cfg.init_std, dtype=dtype),
        "dt_proj": dense_init(generator, d, heads, std=cfg.init_std, dtype=dtype),
    }
    for name, width in (("conv_x", d_inner), ("conv_bc", 2 * s.state_dim)):
        w = torch.randn((s.conv_width, width), generator=generator, device=dev) * (1.0 / s.conv_width)
        p[f"{name}_w"] = w.to(dtype)
        p[f"{name}_b"] = torch.zeros((width,), dtype=dtype, device=dev)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32, device=dev))
    p["D"] = torch.ones((heads,), dtype=torch.float32, device=dev)
    p["dt_bias"] = torch.zeros((heads,), dtype=torch.float32, device=dev)
    p["norm"] = rmsnorm_init(d_inner, dtype, dev)
    p["out_proj"] = dense_init(generator, d_inner, d, std=cfg.init_std, dtype=dtype)
    return p


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.float())


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` formula for formula: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W.  xbc: (B, S, C); w: (W, C).  The taps
    add in the input's dtype; SiLU runs in float32 and is cast back."""
    width, s = w.shape[0], xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return _silu_f32(out + b).to(xbc.dtype)


def _ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
    chunk: int, h0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x: (B,S,H,P); dt: (B,S,H); a_neg: (H,) negative;
    bmat/cmat: (B,S,N).  Returns (y (B,S,H,P) f32, h_final (B,H,N,P) f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    L = min(chunk, s)
    if s % L:
        pad = L - s % L
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt, bmat, cmat = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, bmat, cmat))
    nc = x.shape[1] // L

    xc = x.reshape(b, nc, L, h, p).float()
    dtc = dt.reshape(b, nc, L, h).float()
    bc = bmat.reshape(b, nc, L, n).float()
    cc = cmat.reshape(b, nc, L, n).float()

    ac = dtc * a_neg                                       # (B,nc,L,H) log-decay, <= 0
    cum = torch.cumsum(ac, dim=2)
    dtx = xc * dtc[..., None]                              # (B,nc,L,H,P)

    # intra-chunk (quadratic, attention-like); the mask applies before the
    # product, since the upper triangle's exp(diff) can be inf
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)           # (B,nc,L,L)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Lt,Ls,H)
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    m = decay * cb[:, :, :, :, None]                       # (B,nc,Lt,Ls,H)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, dtx)

    # chunk states
    last = cum[:, :, -1:, :]                               # (B,nc,1,H)
    state_decay = torch.exp(last - cum)                    # (B,nc,L,H)
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", state_decay, bc, dtx)

    # inter-chunk recurrence; each chunk reads the state before it
    lam = torch.exp(last[:, :, 0, :])                      # (B,nc,H)
    hh = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    prevs = []
    for c in range(nc):
        prevs.append(hh)
        hh = hh * lam[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                    # (B,nc,H,N,P)

    y_inter = torch.einsum("bctn,bchnp->bcthp", cc, h_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * L, h, p)[:, :s]
    return y, hh


def mamba2_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    layer_cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 mixer.  x: (B, S, d) -> (out (B, S, d), new cache or None).

    Decode (``layer_cache`` = {h, conv_x, conv_bc}, S == 1): the O(1)
    recurrence, which reads no position; returns the layer's new state and
    window tails.  Prefill with ``cache_index``: returns the final state and
    the last W-1 rows of the *raw* x and bc projections (before the
    convolution), left-padded with zeros when S < W-1.
    """
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_inner = s_cfg.expand * d
    heads = d_inner // s_cfg.head_dim
    n = s_cfg.state_dim
    q = cfg.quant

    z = dense_apply(params["z_proj"], x, quant=q, tag="ssm_proj")
    xp = dense_apply(params["x_proj"], x, quant=q, tag="ssm_proj")
    bc = dense_apply(params["bc_proj"], x, quant=q, tag="ssm_proj")
    dt_raw = dense_apply(params["dt_proj"], x, quant=q, tag="ssm_proj")
    a_neg = -torch.exp(params["A_log"])                    # (H,)

    if layer_cache is not None:
        win_x = torch.cat([layer_cache["conv_x"], xp.to(layer_cache["conv_x"].dtype)], dim=1)
        win_bc = torch.cat([layer_cache["conv_bc"], bc.to(layer_cache["conv_bc"].dtype)], dim=1)
        cx = torch.einsum("bwc,wc->bc", win_x, params["conv_x_w"].to(win_x.dtype))
        cx = _silu_f32(cx + params["conv_x_b"])
        cbc = torch.einsum("bwc,wc->bc", win_bc, params["conv_bc_w"].to(win_bc.dtype))
        cbc = _silu_f32(cbc + params["conv_bc_b"])

        xs = cx.reshape(b, heads, s_cfg.head_dim)
        bmat, cmat = cbc[:, :n], cbc[:, n:]
        dt = _softplus(dt_raw[:, 0, :].float() + params["dt_bias"])
        lam = torch.exp(dt * a_neg)                        # (B,H)
        dbx = torch.einsum("bh,bn,bhp->bhnp", dt, bmat, xs.float())
        h_new = layer_cache["h"] * lam[:, :, None, None] + dbx
        y = torch.einsum("bn,bhnp->bhp", cmat, h_new)
        y = y + params["D"][:, None] * xs.float()
        y = y.reshape(b, 1, d_inner)
        new_cache = {"h": h_new, "conv_x": win_x[:, 1:, :], "conv_bc": win_bc[:, 1:, :]}
    else:
        cx = _causal_conv(xp, params["conv_x_w"], params["conv_x_b"])
        cbc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"])
        xs = cx.reshape(b, s, heads, s_cfg.head_dim)
        bmat, cmat = cbc[..., :n], cbc[..., n:]
        dt = _softplus(dt_raw.float() + params["dt_bias"])
        y, h_final = _ssd_chunked(xs, dt, a_neg, bmat, cmat, s_cfg.chunk)
        y = y + params["D"][None, None, :, None] * xs.float()
        y = y.reshape(b, s, d_inner)
        new_cache = None
        if cache_index is not None:  # prefill that seeds a decode cache
            w = s_cfg.conv_width - 1

            def tail(arr):
                # A copy: the slice alone would keep the whole (B, S, C)
                # projection alive in the cache, every layer's until the
                # prefill stacks them.
                return torch.nn.functional.pad(arr, (0, 0, max(0, w - s), 0))[:, -w:, :].clone()

            new_cache = {"h": h_final, "conv_x": tail(xp), "conv_bc": tail(bc)}

    gate = _silu_f32(z) * y
    gate = rmsnorm(params["norm"], gate.to(x.dtype), cfg.norm_eps)
    out = dense_apply(params["out_proj"], gate, quant=q, tag="ssm_proj")
    return out, new_cache
