"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), the reference's
``layers/mla.py``.

The KV cache stores only the compressed latent ``c_kv`` (kv_lora_rank) plus
the shared decoupled rope key (qk_rope_dim) per position.  Decode uses the
*absorbed* formulation: query nope components are projected into latent
space so scores are taken directly against the cached latents (no per-step
re-expansion of K/V); prefill expands K and V and runs ``chunked_attention``
(whose V head dim may differ from the QK dim).

MLA projections are never packed: ``mla_init`` gives every projection a
plain ``{"w"}`` (the reference calls ``dense_init`` with no ``quant``), so in
``bnn_packed`` mode they stay dense products in the model's type.  In the
``bnn_weight_only``/``bnn_xnor`` modes ``dense_apply`` binarizes them
(tag ``attn_proj``) — except that absorbed decode reads ``wkv_b``'s raw
weights, while prefill binarizes them.  The port keeps this as the
reference has it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import rope
from repro_torch.layers.attention import chunked_attention
from repro_torch.layers.linear import dense_apply, dense_init
from repro_torch.layers.norms import rmsnorm, rmsnorm_init


@dataclasses.dataclass
class MlaCache:
    """c_kv: (L, B, S_max, kv_lora); k_rope: (L, B, S_max, rope_dim);
    ``index``: current length."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    index: int

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, layers: int, device="cuda") -> "MlaCache":
        m = cfg.mla
        dtype = cfg.param_dtype()
        return MlaCache(
            c_kv=torch.zeros((layers, batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
            k_rope=torch.zeros((layers, batch, max_len, m.qk_rope_dim), dtype=dtype, device=device),
            index=0,
        )


def mla_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dev = generator.device
    kw = dict(std=cfg.init_std, dtype=dtype)
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(generator, d, m.q_lora_rank, **kw)
        p["q_norm"] = rmsnorm_init(m.q_lora_rank, dtype, dev)
        p["wq_b"] = dense_init(generator, m.q_lora_rank, h * qk, **kw)
    else:
        p["wq"] = dense_init(generator, d, h * qk, **kw)
    p["wkv_a"] = dense_init(generator, d, m.kv_lora_rank + m.qk_rope_dim, **kw)
    p["kv_norm"] = rmsnorm_init(m.kv_lora_rank, dtype, dev)
    p["wkv_b"] = dense_init(generator, m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim), **kw)
    p["wo"] = dense_init(generator, h * m.v_head_dim, d, **kw)
    return p


def _project_q(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.mla
    b, s, _ = x.shape
    if m.q_lora_rank:
        cq = dense_apply(params["wq_a"], x, quant=cfg.quant, tag="attn_proj")
        cq = rmsnorm(params["q_norm"], cq, cfg.norm_eps)
        q = dense_apply(params["wq_b"], cq, quant=cfg.quant, tag="attn_proj")
    else:
        q = dense_apply(params["wq"], x, quant=cfg.quant, tag="attn_proj")
    return q.reshape(b, s, cfg.num_heads, m.qk_nope_dim + m.qk_rope_dim)


def mla_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    layer_cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
) -> tuple[torch.Tensor, Optional[dict]]:
    """MLA block.  x: (B, S, d).

    Decode: ``layer_cache={'c_kv', 'k_rope'}`` (B, S_max, ·), read only;
    returns the new position's entries (B, 1, ·) for the caller to commit.
    Prefill/train: ``layer_cache=None``; returns fresh entries (B, S, ·) when
    ``cache_index`` is given, else no cache.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    scale = 1.0 / ((m.qk_nope_dim + m.qk_rope_dim) ** 0.5)

    q = _project_q(params, x, cfg)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = rope.rotate(q_rope, positions, theta=cfg.rope_theta)

    kv_a = dense_apply(params["wkv_a"], x, quant=cfg.quant, tag="attn_proj")
    c_kv, k_rope = kv_a[..., : m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    # shared single-head rope key
    k_rope = rope.rotate(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0, :]

    w_kv_b = params["wkv_b"]["w"].reshape(h, m.qk_nope_dim + m.v_head_dim, m.kv_lora_rank)
    w_uk = w_kv_b[:, : m.qk_nope_dim, :]   # (H, nope, lora)
    w_uv = w_kv_b[:, m.qk_nope_dim:, :]    # (H, v, lora)

    new_cache = None
    if layer_cache is not None:
        # absorbed decode against the read-only latent cache (positions <
        # index) plus the current token as an explicit extra column; the
        # caller commits the (B, 1, ·) entries.  Score and output einsums
        # run in float32 (the reference's preferred_element_type).
        ckv_c, krope_c = layer_cache["c_kv"], layer_cache["k_rope"]
        q_lat = torch.einsum("bshd,hdc->bshc", q_nope, w_uk.to(q_nope.dtype))
        ql, qr = q_lat.float(), q_rope.float()
        scores = (torch.einsum("bshc,btc->bhst", ql, ckv_c.float())
                  + torch.einsum("bshr,btr->bhst", qr, krope_c.float())) * scale  # (B, H, 1, S)
        mask = torch.arange(ckv_c.shape[1], device=x.device) < cache_index
        scores = scores.masked_fill(~mask, float("-inf"))
        s_new = (torch.einsum("bshc,btc->bhst", ql, c_kv.to(q_lat.dtype).float())
                 + torch.einsum("bshr,btr->bhst", qr, k_rope.to(q_rope.dtype).float())) * scale
        p = torch.softmax(torch.cat([scores, s_new], dim=-1), dim=-1)
        out_lat = torch.einsum("bhst,btc->bshc", p[..., :-1], ckv_c.float())
        out_lat = out_lat + torch.einsum("bhst,btc->bshc", p[..., -1:], c_kv.float())
        out = torch.einsum("bshc,hvc->bshv", out_lat, w_uv.float()).to(x.dtype)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}  # (B, 1, ·): new position
    else:
        # prefill / train: expand K, V and run chunked attention
        kv = dense_apply(params["wkv_b"], c_kv, quant=cfg.quant, tag="attn_proj")
        kv = kv.reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
        k_nope, v = kv[..., : m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qq, k, v, causal=causal, q_chunk=cfg.attn_q_chunk, scale=scale)
        if cache_index is not None:
            new_cache = {"c_kv": c_kv, "k_rope": k_rope}

    out = out.reshape(b, s, h * m.v_head_dim)
    return dense_apply(params["wo"], out, quant=cfg.quant, tag="attn_proj"), new_cache
