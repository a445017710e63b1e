"""Attention: GQA with chunked causal prefill, the flash kernel, and cached
decode (the reference's ``layers/attention.py``, GQA only).

Layouts are the reference's: q (B, S, H, D), k/v (B, S, KVH, D), caches
(L, B, S_max, KVH, D).  GQA is computed in grouped form (no KV head
repetition) except on the flash path, whose kernel takes (B*H, S, D).

``chunked_attention``, ``decode_attention_incremental`` and
``decode_attention`` launch the ``chunked_attention`` and
``decode_attention`` kernels on CUDA tensors; their plain versions
(``*_plain``, the reference's jnp in PyTorch, kept in the kernel modules)
run on CPU tensors and wherever autograd records.

The decode paths write the new position into the cache tensors in place
(the reference returns updated copies); a write past the cache's end lands
on its last position, as ``lax.dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import chunked_attention as chunked_kernel
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels.chunked_attention import chunked_attention_plain
from repro_torch.kernels.decode_attention import decode_attention_incremental_plain
from repro_torch.kernels.decode_attention import decode_attention_in_cache_plain as decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.layers import rope
from repro_torch.layers.linear import dense_apply, dense_init


@dataclasses.dataclass
class KVCache:
    """Per-layer-stack KV cache: tensors stacked over layers.

    k, v: (L, B, S_max, KVH, D); ``index``: current length.
    """

    k: torch.Tensor
    v: torch.Tensor
    index: int

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, layers: int, device="cuda") -> "KVCache":
        shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        dtype = cfg.param_dtype()
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            index=0,
        )


def attention_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    kw = dict(std=cfg.init_std, dtype=dtype, quant=cfg.quant, tag="attn_proj")
    return {
        "wq": dense_init(generator, d, h * hd, **kw),
        "wk": dense_init(generator, d, kvh * hd, **kw),
        "wv": dense_init(generator, d, kvh * hd, **kw),
        "wo": dense_init(generator, h * hd, d, **kw),
    }


def _flash_full(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float
) -> torch.Tensor:
    """Full-sequence attention through the flash kernel.

    q: (B, S, H, D); k/v: (B, S, KVH, D).  GQA KV heads are repeated to H and
    heads flattened into the kernel's (B*H, S, D), as the reference does.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)

    def flat(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    out = flash_attention(flat(q), flat(k), flat(v), causal=causal, scale=scale)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _autograd_records(*inputs: torch.Tensor) -> bool:
    """Whether autograd would record through these inputs: grad mode on and
    one of them requiring grad.  There the plain versions run, as the
    reference's training forward reaches no Pallas kernel and the kernels
    have no backward (``kernels/_build.py::refuse_grad``)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_chunk: int,
    scale: float, scores_dtype=torch.float32,
) -> torch.Tensor:
    """Softmax attention over full K/V (``chunked_attention_plain``): the
    ``chunked_attention`` kernel on CUDA tensors, the plain version on CPU
    tensors and where autograd records.

    q: (B, S, H, D); k, v: (B, S, KVH, D).  Returns (B, S, H, D).
    """
    fn = chunked_attention_plain if _autograd_records(q, k, v) else chunked_kernel.chunked_attention
    return fn(q, k, v, causal=causal, q_chunk=q_chunk, scale=scale, scores_dtype=scores_dtype)


def decode_attention_incremental(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
    v_new: torch.Tensor, index: int, *, scale: float,
) -> torch.Tensor:
    """Decode attention WITHOUT writing the token into the cache first
    (``decode_attention_incremental_plain``): the ``decode_attention``
    kernel's incremental mode on CUDA tensors, the plain version on CPU
    tensors and where autograd records.

    q: (B, 1, H, D); caches: (B, S, KVH, D); k_new/v_new: (B, 1, KVH, D).
    """
    if _autograd_records(q, k_cache, v_cache, k_new, v_new):
        return decode_attention_incremental_plain(q, k_cache, v_cache, k_new, v_new, index, scale=scale)
    return decode_kernel.decode_attention(q, k_cache, v_cache, index, scale=scale, k_new=k_new, v_new=v_new)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, index: int, *, scale: float,
) -> torch.Tensor:
    """Single-position attention against a cache (``decode_attention_plain``):
    the ``decode_attention`` kernel's in-cache mode on CUDA tensors, the
    plain version on CPU tensors and where autograd records.

    q: (B, 1, H, D); caches: (B, S_max, KVH, D); ``index`` = position of the
    new token (attends to [0, index]).
    """
    if _autograd_records(q, k_cache, v_cache):
        return decode_attention_plain(q, k_cache, v_cache, index, scale=scale)
    return decode_kernel.decode_attention(q, k_cache, v_cache, index, scale=scale)


def write_position(cache: torch.Tensor, new: torch.Tensor, index: int) -> None:
    """Write ``new`` (B, n, ...) into ``cache`` (B, S_max, ...) at ``index``
    in place, clamping the start as ``lax.dynamic_update_slice`` does."""
    start = max(0, min(index, cache.shape[1] - new.shape[1]))
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


def attention_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    layer_cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA block.  x: (B, S, d).

    Prefill/train: ``layer_cache=None`` -> full attention; returns (out, None)
    or (out, fresh cache entries when ``cache_index`` is given).
    Decode: ``layer_cache={'k','v'}`` (B, S_max, KVH, D) and ``cache_index``
    -> attends against the cache (see ``cfg.decode_cache_carry``).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense_apply(params["wq"], x, quant=cfg.quant, tag="attn_proj").reshape(b, s, h, hd)
    k = dense_apply(params["wk"], x, quant=cfg.quant, tag="attn_proj").reshape(b, s, kvh, hd)
    v = dense_apply(params["wv"], x, quant=cfg.quant, tag="attn_proj").reshape(b, s, kvh, hd)
    if cfg.rotary_pct > 0:
        q = rope.rotate(q, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)
        k = rope.rotate(k, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)
    scale = 1.0 / (hd ** 0.5)

    new_cache = None
    if layer_cache is not None:
        if cfg.decode_cache_carry:
            # read-only cache + explicit current-token column; the caller
            # commits {k, v} (models.decode_step).
            out = decode_attention_incremental(
                q, layer_cache["k"], layer_cache["v"], k, v, cache_index, scale=scale,
            )
            new_cache = {"k": k, "v": v}  # (B, 1, KVH, D): new position only
        else:
            # commit into the cache first, then attend mask <= index
            write_position(layer_cache["k"], k, cache_index)
            write_position(layer_cache["v"], v, cache_index)
            out = decode_attention(q, layer_cache["k"], layer_cache["v"], cache_index, scale=scale)
            new_cache = {"k": layer_cache["k"], "v": layer_cache["v"]}
    elif cfg.attn_impl == "pallas_flash":
        if cache_index is not None:
            raise ValueError(
                "attn_impl='pallas_flash' cannot seed a decode cache (the reference "
                "returns no cache on this path); prefill and serve with attn_impl='xla'"
            )
        out = _flash_full(q, k, v, causal=causal, scale=scale)
    else:
        out = chunked_attention(
            q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk, scale=scale,
            scores_dtype=torch.bfloat16 if cfg.attn_scores_dtype == "bf16" else torch.float32,
        )
        if cache_index is not None:  # prefill that seeds a cache
            new_cache = {"k": k, "v": v}
    out = dense_apply(params["wo"], out.reshape(b, s, h * hd), quant=cfg.quant, tag="attn_proj")
    return out, new_cache
