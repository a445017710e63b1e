"""Model assembly: init / forward / prefill / decode (the reference's
``models/model.py``, dense and MoE families).

  dense — [norm -> attn -> res] [norm -> ffn -> res] x L
  moe   — the same, ffn replaced by the MoE FFN (``layers/moe.py``)

Attention is GQA (``layers/attention.py``) or MLA (``layers/mla.py``, whose
cache is an ``MlaCache`` of latents).  The reference scans stacked layer
parameters with ``lax.scan``; the port keeps one parameter dict per layer in
``params["layers"]`` and loops over them eagerly.  The other families (ssm,
hybrid, vlm, audio) are later slices of the port and raise
``NotImplementedError`` naming their ROADMAP item.  Every entry point runs
where ``params`` lie; ``init_params`` and ``init_cache`` take ``device=``
(default ``"cuda"``, which raises without a GPU).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache, attention_apply, attention_init, write_position
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.ffn import ffn_apply, ffn_init
from repro_torch.layers.mla import MlaCache, mla_apply, mla_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import rmsnorm, rmsnorm_init

_LATER = {
    "ssm": "ROADMAP Queue 1 item 16 (SSM and hybrid families)",
    "hybrid": "ROADMAP Queue 1 item 16 (SSM and hybrid families)",
    "vlm": "ROADMAP Queue 1 item 17 (VLM and audio families)",
    "audio": "ROADMAP Queue 1 item 17 (VLM and audio families)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see {_LATER[cfg.family]}"
        )
    if cfg.family not in ("dense", "moe") or cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} attention")


def _cache_class(cfg: ModelConfig):
    """An ``MlaCache`` of latents for MLA attention, else a ``KVCache``."""
    return MlaCache if cfg.attention == "mla" else KVCache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Decode cache over all layers (``_cache_class``)."""
    _check_family(cfg)
    return _cache_class(cfg).init(cfg, batch, max_len, cfg.num_layers, resolve_device(device))


def _block_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = generator.device
    p = {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "ffn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if cfg.attention == "mla":
        p["attn"] = mla_init(generator, cfg, dtype)
    else:
        p["attn"] = attention_init(generator, cfg, dtype)
    if cfg.family == "moe":
        p["moe"] = moe_init(generator, cfg, dtype)
    else:
        p["ffn"] = ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.act, std=cfg.init_std,
                            dtype=dtype, quant=cfg.quant)
    return p


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
    """attention (+ffn/moe) block with residuals.  Returns (h, cache, aux)."""
    apply = mla_apply if cfg.attention == "mla" else attention_apply
    a, new_cache = apply(
        bp["attn"], rmsnorm(bp["attn_norm"], h, cfg.norm_eps), cfg,
        positions=positions, layer_cache=layer_cache, cache_index=cache_index, causal=causal,
    )
    h = h + a
    hn = rmsnorm(bp["ffn_norm"], h, cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = moe_apply(bp["moe"], hn, cfg)
    else:
        f, aux = ffn_apply(bp["ffn"], hn, cfg), torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f, new_cache, aux


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)).expand(b, s)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / eval / scoring).

    batch: {"tokens": (B, S)}.  Returns (logits (B, S, V) f32, the sum of
    every layer's aux loss: the MoE router's, 0 for a dense model).
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
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params["layers"]:
        h, _, a = _attn_block(lp, h, cfg, positions, None, None, not cfg.encoder_only)
        aux = aux + a
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params["embed"], h), aux


def cache_fields(cache) -> tuple[str, ...]:
    """The names of a decode cache's (class or instance) per-layer tensors,
    stacked over layers on axis 0: ``("k", "v")`` for a ``KVCache``,
    ``("c_kv", "k_rope")`` for an ``MlaCache``."""
    return tuple(f.name for f in dataclasses.fields(cache) if f.name != "index")


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence pass that seeds the decode cache.

    Returns (last_logits (B, V) f32, cache with index = S): a ``KVCache`` of
    (L, B, S, KVH, D), or for MLA an ``MlaCache`` of (L, B, S, kv_lora) and
    (L, B, S, rope_dim).  The serving engine right-pads it to its budget.
    """
    _check_family(cfg)
    h = embed(params["embed"], batch["tokens"], cfg.param_dtype())
    b, s, _ = h.shape
    positions = _positions(b, s, 0, h.device)
    cache = _cache_class(cfg)
    names = cache_fields(cache)
    entries = {name: [] for name in names}
    with torch.no_grad():
        for lp in params["layers"]:
            h, nc, _ = _attn_block(lp, h, cfg, positions, None, 0, True)
            for name in names:
                entries[name].append(nc[name])
        h = rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, cache(*(torch.stack(entries[name]) for name in names), s)


def decode_step(params: dict, token: torch.Tensor, cache, cfg: ModelConfig):
    """One decode step.  token: (B,) int.  Returns (logits (B, V), cache).

    The new position is written into ``cache``'s tensors in place; the
    returned cache shares them, with ``index + 1``.  A GQA layer with
    ``decode_cache_carry`` attends the read-only cache plus the new token,
    then the position is committed; without it the layer commits first.
    An MLA layer always returns the new position's latents, committed after
    it attends (the reference's carry and ys-rewrite paths write the same
    position).
    """
    _check_family(cfg)
    h = embed(params["embed"], token[:, None], cfg.param_dtype())   # (B, 1, d)
    b = h.shape[0]
    idx = cache.index
    positions = _positions(b, 1, idx, h.device)
    names = cache_fields(cache)
    commit = cfg.attention == "mla" or cfg.decode_cache_carry
    with torch.no_grad():
        for i, lp in enumerate(params["layers"]):
            lc = {name: getattr(cache, name)[i] for name in names}
            h, nc, _ = _attn_block(lp, h, cfg, positions, lc, idx, True)
            if commit:
                for name in names:
                    write_position(getattr(cache, name)[i], nc[name], idx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, dataclasses.replace(cache, index=idx + 1)
