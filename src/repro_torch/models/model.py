"""Model assembly: init / forward / prefill / decode (the reference's
``models/model.py``, dense family).

  dense — [norm -> attn -> res] [norm -> ffn -> res] x L

The reference scans stacked layer parameters with ``lax.scan``; the port
keeps one parameter dict per layer in ``params["layers"]`` and loops over
them eagerly.  Other families (moe, ssm, hybrid, vlm, audio) are later
slices of the port and raise ``NotImplementedError`` naming their ROADMAP
item.  Every entry point runs where ``params`` lie; ``init_params`` and
``init_cache`` take ``device=`` (default ``"cuda"``, which raises without a
GPU).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache, attention_apply, attention_init, write_position
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.ffn import ffn_apply, ffn_init
from repro_torch.layers.norms import rmsnorm, rmsnorm_init

_LATER = {
    "moe": "ROADMAP Queue 1 item 15 (MoE family and MLA attention)",
    "ssm": "ROADMAP Queue 1 item 16 (SSM and hybrid families)",
    "hybrid": "ROADMAP Queue 1 item 16 (SSM and hybrid families)",
    "vlm": "ROADMAP Queue 1 item 17 (VLM and audio families)",
    "audio": "ROADMAP Queue 1 item 17 (VLM and audio families)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa":
        where = _LATER.get(cfg.family, _LATER["moe"])
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} attention is not "
            f"ported yet; see {where}"
        )


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> KVCache:
    """Decode cache of the dense family: a KV cache over all layers."""
    _check_family(cfg)
    return KVCache.init(cfg, batch, max_len, cfg.num_layers, resolve_device(device))


def _block_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = generator.device
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "ffn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": attention_init(generator, cfg, dtype),
        "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.act, std=cfg.init_std,
                        dtype=dtype, quant=cfg.quant),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``).

    Returns {"embed": {"table"}, "final_norm": {"scale"}, "layers": [one dict
    per layer]}, keys as the reference's parameter paths.  Packed projections
    are packed on the device (the bit-pack kernel on a GPU).
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = cfg.param_dtype()
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, std=cfg.init_std, dtype=dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "layers": [_block_init(gen, cfg, dtype) for _ in range(cfg.num_layers)],
    }


def _attn_block(bp, h, cfg, positions, layer_cache, cache_index, causal):
    """attention + ffn block with residuals.  Returns (h, cache)."""
    a, new_cache = attention_apply(
        bp["attn"], rmsnorm(bp["attn_norm"], h, cfg.norm_eps), cfg,
        positions=positions, layer_cache=layer_cache, cache_index=cache_index, causal=causal,
    )
    h = h + a
    f = ffn_apply(bp["ffn"], rmsnorm(bp["ffn_norm"], h, cfg.norm_eps), cfg)
    return h + f, new_cache


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)).expand(b, s)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / eval / scoring).

    batch: {"tokens": (B, S)}.  Returns (logits (B, S, V) f32, aux loss 0).
    Differentiable, as the reference's training forward is: gradients reach
    every parameter that requires them, through ``ste_sign`` in the
    ``bnn_weight_only``/``bnn_xnor`` modes.  On the CPU that is the plain
    PyTorch path; a CUDA kernel has no backward yet, so on a card a kernel
    reached under grad raises (ROADMAP Queue 1 item 18).  Scoring callers
    run it under ``torch.inference_mode()``.
    """
    _check_family(cfg)
    h = embed(params["embed"], batch["tokens"], cfg.param_dtype())
    b, s, _ = h.shape
    positions = _positions(b, s, 0, h.device)
    for lp in params["layers"]:
        h, _ = _attn_block(lp, h, cfg, positions, None, None, not cfg.encoder_only)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params["embed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def prefill(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence pass that seeds the decode cache.

    Returns (last_logits (B, V) f32, cache of (L, B, S, KVH, D) with
    index = S).  The serving engine right-pads the cache to its budget.
    """
    _check_family(cfg)
    h = embed(params["embed"], batch["tokens"], cfg.param_dtype())
    b, s, _ = h.shape
    positions = _positions(b, s, 0, h.device)
    ks, vs = [], []
    with torch.no_grad():
        for lp in params["layers"]:
            h, nc = _attn_block(lp, h, cfg, positions, None, 0, True)
            ks.append(nc["k"])
            vs.append(nc["v"])
        h = rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, KVCache(torch.stack(ks), torch.stack(vs), s)


def decode_step(
    params: dict, token: torch.Tensor, cache: KVCache, cfg: ModelConfig,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  token: (B,) int.  Returns (logits (B, V), cache).

    The new position is written into ``cache``'s tensors in place; the
    returned cache shares them, with ``index + 1``.
    """
    _check_family(cfg)
    h = embed(params["embed"], token[:, None], cfg.param_dtype())   # (B, 1, d)
    b = h.shape[0]
    idx = cache.index
    positions = _positions(b, 1, idx, h.device)
    with torch.no_grad():
        for i, lp in enumerate(params["layers"]):
            lc = {"k": cache.k[i], "v": cache.v[i]}
            h, nc = _attn_block(lp, h, cfg, positions, lc, idx, True)
            if cfg.decode_cache_carry:
                # commit the single new position after attending
                write_position(cache.k[i], nc["k"], idx)
                write_position(cache.v[i], nc["v"], idx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, dataclasses.replace(cache, index=idx + 1)
