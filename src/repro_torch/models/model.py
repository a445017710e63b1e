"""Model assembly: init / forward / prefill / decode for every family (the
reference's ``models/model.py``).

  dense  — [norm -> attn -> res] [norm -> ffn -> res] x L
  moe    — the same, ffn replaced by the MoE FFN (``layers/moe.py``)
  ssm    — [norm -> mamba2 -> res] x L (``layers/mamba2.py``)
  hybrid — SSM layers in groups of ``hybrid_period``, each group followed by
           the one *shared* attention + FFN block, which keeps its own KV
           slot per application; a tail of SSM layers past the last group
  vlm    — the dense stack over [patch embeddings ; token embeddings]
  audio  — encoder-only (bidirectional) over frame embeddings

Attention is GQA (``layers/attention.py``) or MLA (``layers/mla.py``, whose
cache is an ``MlaCache`` of latents).  The reference scans stacked layer
parameters with ``lax.scan``; the port keeps one parameter dict per layer
and loops over them eagerly: ``params["layers"]`` is a list of layer dicts,
and for the hybrid a list of groups, each a list of ``hybrid_period`` layer
dicts, beside ``params["tail"]`` (a list, present when ``num_layers`` is
not a multiple of the period) and ``params["shared"]`` (one dict).  Every
entry point runs where ``params`` lie; ``init_params`` and ``init_cache``
take ``device=`` (default ``"cuda"``, which raises without a GPU).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache, attention_apply, attention_init, write_position
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.ffn import ffn_apply, ffn_init
from repro_torch.layers.mamba2 import SsmCache, mamba2_apply, mamba2_init
from repro_torch.layers.mla import MlaCache, mla_apply, mla_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import rmsnorm, rmsnorm_init


@dataclasses.dataclass
class HybridCache:
    """SSM states for every layer + a KV cache for the shared block's
    applications (stacked over ``num_layers // hybrid_period``)."""

    ssm: SsmCache
    kv: KVCache

    @property
    def index(self) -> int:
        return self.kv.index


_ATTENTION = {"dense": ("gqa", "mla"), "moe": ("gqa", "mla"), "vlm": ("gqa", "mla"),
              "audio": ("gqa", "mla"), "hybrid": ("gqa",), "ssm": None}


def _check_family(cfg: ModelConfig) -> None:
    """Refuse a family, or a family's attention, that the reference lacks
    (an SSM model has no attention; the hybrid's shared block is GQA)."""
    if cfg.family not in _ATTENTION:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    allowed = _ATTENTION[cfg.family]
    if allowed is not None and cfg.attention not in allowed:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} attention")


def _cache_class(cfg: ModelConfig):
    """An ``MlaCache`` of latents for MLA attention, else a ``KVCache``."""
    return MlaCache if cfg.attention == "mla" else KVCache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Decode cache for a model family: ``None`` for an encoder-only model,
    an ``SsmCache`` (ssm), a ``HybridCache`` (hybrid), else
    ``_cache_class``'s over all layers."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.encoder_only:
        return None
    if cfg.family == "ssm":
        return SsmCache.init(cfg, batch, cfg.num_layers, dev)
    if cfg.family == "hybrid":
        return HybridCache(
            ssm=SsmCache.init(cfg, batch, cfg.num_layers, dev),
            kv=KVCache.init(cfg, batch, max_len, cfg.num_layers // cfg.hybrid_period, dev),
        )
    return _cache_class(cfg).init(cfg, batch, max_len, cfg.num_layers, dev)


def _block_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = generator.device
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": rmsnorm_init(cfg.d_model, dtype, dev), "mamba": mamba2_init(generator, cfg, dtype)}
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


def _shared_block_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The hybrid's shared block: GQA attention and an FFN, both taking
    ``cfg.quant`` (packed in ``bnn_packed``)."""
    dev = generator.device
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": attention_init(generator, cfg, dtype),
        "ffn_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.act, std=cfg.init_std,
                        dtype=dtype, quant=cfg.quant),
    }


class _ShapeOnly(torch.Generator):
    """A generator that names the meta device.  The layers' inits make their
    tensors on ``generator.device``, so under it they allocate nothing and
    draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``).

    Returns {"embed": {"table"}, "final_norm": {"scale"}, "layers": [...]}
    (and for the hybrid "tail" and "shared"; module docstring), keys as the
    reference's parameter paths.  Packed projections are packed on the
    device (the bit-pack kernel on a GPU).  ``device="meta"`` gives the same
    tree shape-only (the reference's ``jax.eval_shape(init_params)``):
    meta tensors of the same shapes and types, packed words at their packed
    shapes, nothing allocated, drawn or packed.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = _ShapeOnly() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dtype = cfg.param_dtype()
    p = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, std=cfg.init_std, dtype=dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if cfg.family == "hybrid":
        period = cfg.hybrid_period
        n_groups = cfg.num_layers // period
        p["layers"] = [[_block_init(gen, cfg, dtype) for _ in range(period)] for _ in range(n_groups)]
        tail = cfg.num_layers - n_groups * period
        if tail:
            p["tail"] = [_block_init(gen, cfg, dtype) for _ in range(tail)]
        p["shared"] = _shared_block_init(gen, cfg, dtype)
    else:
        p["layers"] = [_block_init(gen, cfg, dtype) for _ in range(cfg.num_layers)]
    return p


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


def _ssm_block(bp, h, cfg, layer_cache, cache_index):
    out, new_cache = mamba2_apply(
        bp["mamba"], rmsnorm(bp["norm"], h, cfg.norm_eps), cfg,
        layer_cache=layer_cache, cache_index=cache_index,
    )
    return h + out, new_cache


def _schedule(params: dict, cfg: ModelConfig):
    """The layers in the order they run, as (kind, layer params, cache
    slot): ``"ssm"`` for a Mamba2 layer (slot: its SSM cache layer),
    ``"attn"`` for an attention block (slot: its KV cache layer).  In the
    hybrid each group's SSM layers come before the shared block's
    application ``g`` (slot ``g``), and the tail comes last."""
    if cfg.family == "ssm":
        yield from (("ssm", lp, i) for i, lp in enumerate(params["layers"]))
    elif cfg.family == "hybrid":
        i = 0
        for g, group in enumerate(params["layers"]):
            for lp in group:
                yield "ssm", lp, i
                i += 1
            yield "attn", params["shared"], g
        for lp in params.get("tail", ()):
            yield "ssm", lp, i
            i += 1
    else:
        yield from (("attn", lp, i) for i, lp in enumerate(params["layers"]))


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """(B, S_total, d) in the param dtype: ``frames`` as given, or the token
    embeddings, after the ``patches`` for ``tokens+patches``."""
    dtype = cfg.param_dtype()
    if cfg.input_mode == "frames":
        return batch["frames"].to(dtype)
    if cfg.input_mode == "tokens+patches":
        tok = embed(params["embed"], batch["tokens"], dtype)
        return torch.cat([batch["patches"].to(dtype), tok], dim=1)
    return embed(params["embed"], batch["tokens"], dtype)


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)).expand(b, s)


def _segments(params: dict, cfg: ModelConfig):
    """The forward's layers in the order they run, cut where the reference's
    scans recompute under ``remat``: one layer a segment (dense, moe, vlm,
    audio, ssm); for the hybrid one group's SSM layers with the shared
    block's application after them, then each tail layer.  A segment is a
    list of (kind, layer params) as in :func:`_schedule`."""
    if cfg.family != "hybrid":
        yield from ([(kind, lp)] for kind, lp, _ in _schedule(params, cfg))
        return
    for group in params["layers"]:
        yield [("ssm", lp) for lp in group] + [("attn", params["shared"])]
    for lp in params.get("tail", ()):
        yield [("ssm", lp)]


def _run_segment(segment: list, h: torch.Tensor, cfg: ModelConfig, positions, causal: bool):
    """A segment's layers over ``h``: (h, the sum of their aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, lp in segment:
        if kind == "ssm":
            h, _ = _ssm_block(lp, h, cfg, None, None)
        else:
            h, _, a = _attn_block(lp, h, cfg, positions, None, None, causal)
            aux = aux + a
    return h, aux


def forward(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / eval / scoring).

    batch: {"tokens": (B, S)} (+ "patches" (B, num_patches, d), or
    {"frames": (B, S, d)}, per ``cfg.input_mode``).  Returns (logits
    (B, S_total, V) f32, the sum of every layer's aux loss: the MoE
    router's, 0 for the other families).  Bidirectional for an
    encoder-only model; the hybrid's shared block is always causal.
    Differentiable, as the reference's training forward is: gradients reach
    every parameter that requires them, through ``ste_sign`` in the
    ``bnn_weight_only``/``bnn_xnor`` modes.  On the CPU that is the plain
    PyTorch path; a CUDA kernel has no backward, so on a card a kernel
    reached under grad raises (train with ``attn_impl="xla"`` and latent
    weights, as the reference does).  Scoring callers run it under
    ``torch.inference_mode()``.

    With ``remat`` and ``cfg.remat`` set and grad mode on, each segment
    (:func:`_segments`: a layer, or a hybrid group with its shared block)
    runs under ``torch.utils.checkpoint``, as the reference's scans run
    under ``jax.checkpoint``: only its input is kept, and the backward
    recomputes it.  The gradients are the same bits either way.
    """
    _check_family(cfg)
    h = _embed_inputs(params, batch, cfg)
    b, s, _ = h.shape
    positions = _positions(b, s, 0, h.device)
    causal = not cfg.encoder_only
    recompute = remat and cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for segment in _segments(params, cfg):
        if recompute:
            h, a = checkpoint(_run_segment, segment, h, cfg, positions, causal, use_reentrant=False)
        else:
            h, a = _run_segment(segment, h, cfg, positions, causal)
        aux = aux + a
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params["embed"], h), aux


def cache_fields(cache) -> tuple[str, ...]:
    """The names of a flat decode cache's (class or instance) per-layer
    tensors, stacked over layers on axis 0: ``("k", "v")`` for a
    ``KVCache``, ``("c_kv", "k_rope")`` for an ``MlaCache``, ``("h",
    "conv_x", "conv_bc")`` for an ``SsmCache``."""
    return tuple(f.name for f in dataclasses.fields(cache) if f.name != "index")


def cache_tensors(cache) -> list[torch.Tensor]:
    """Every tensor of a decode cache, nested caches (a ``HybridCache``'s
    ``ssm`` and ``kv``) walked in field order.  Each is stacked over layers
    on axis 0 with the batch on axis 1."""
    out = []
    for f in dataclasses.fields(cache):
        value = getattr(cache, f.name)
        if dataclasses.is_dataclass(value):
            out += cache_tensors(value)
        elif isinstance(value, torch.Tensor):
            out.append(value)
    return out


def set_index(cache, value: int):
    """``cache`` with ``index`` = ``value``, in every nested cache too."""
    changes = {f.name: set_index(getattr(cache, f.name), value)
               for f in dataclasses.fields(cache) if dataclasses.is_dataclass(getattr(cache, f.name))}
    if any(f.name == "index" for f in dataclasses.fields(cache)):
        changes["index"] = int(value)
    return dataclasses.replace(cache, **changes)


def _stacked(cls, entries: list[dict], index: int):
    """``cls`` of per-layer cache entries stacked over layers."""
    return cls(*(torch.stack([e[name] for e in entries]) for name in cache_fields(cls)), index)


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence pass that seeds the decode cache.

    Returns (last_logits (B, V) f32, cache with index = S_total): a
    ``KVCache`` of (L, B, S, KVH, D), for MLA an ``MlaCache`` of
    (L, B, S, kv_lora) and (L, B, S, rope_dim), an ``SsmCache`` of every
    layer's final state and raw-projection tails, or a ``HybridCache`` of
    both (one KV entry per shared-block application).  The serving engine
    right-pads the sequence axes to its budget.  A VLM's S_total counts its
    patches.  An encoder-only model raises ``ValueError``.
    """
    _check_family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no prefill/decode")
    with torch.no_grad():
        h = _embed_inputs(params, batch, cfg)
        b, s, _ = h.shape
        positions = _positions(b, s, 0, h.device)
        ssm, attn = [], []
        for kind, lp, _ in _schedule(params, cfg):
            if kind == "ssm":
                h, nc = _ssm_block(lp, h, cfg, None, 0)
                ssm.append(nc)
            else:
                h, nc, _ = _attn_block(lp, h, cfg, positions, None, 0, True)
                attn.append(nc)
        if cfg.family == "ssm":
            cache = _stacked(SsmCache, ssm, s)
        elif cfg.family == "hybrid":
            cache = HybridCache(ssm=_stacked(SsmCache, ssm, s), kv=_stacked(KVCache, attn, s))
        else:
            cache = _stacked(_cache_class(cfg), attn, s)
        h = rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, cache


def _ssm_step(lp, h, cfg, cache: SsmCache, i: int, idx: int):
    """Layer ``i``'s decode step, its new state and tails written into
    ``cache`` in place."""
    lc = {name: getattr(cache, name)[i] for name in cache_fields(cache)}
    h, nc = _ssm_block(lp, h, cfg, lc, idx)
    for name, t in lc.items():
        t.copy_(nc[name])
    return h


def _attn_step(lp, h, cfg, cache, i: int, idx: int, positions):
    """Attention layer (or shared-block application) ``i``'s decode step
    against ``cache``'s slot ``i``, the new position committed in place."""
    names = cache_fields(cache)
    lc = {name: getattr(cache, name)[i] for name in names}
    h, nc, _ = _attn_block(lp, h, cfg, positions, lc, idx, True)
    if cfg.attention == "mla" or cfg.decode_cache_carry:
        for name in names:
            write_position(lc[name], nc[name], idx)
    return h


def decode_step(params: dict, token: torch.Tensor, cache, cfg: ModelConfig):
    """One decode step.  token: (B,) int.  Returns (logits (B, V), cache).

    The new position (an SSM layer's new state and window tails) is written
    into ``cache``'s tensors in place; the returned cache shares them, with
    ``index + 1``.  A GQA layer with ``decode_cache_carry`` attends the
    read-only cache plus the new token, then the position is committed;
    without it the layer commits first.  An MLA layer always returns the new
    position's latents, committed after it attends (the reference's carry
    and ys-rewrite paths write the same position).  In the hybrid, each
    group's SSM layers run, then the shared block against its own KV slot
    ``g``; the tail runs last.  An encoder-only model raises ``ValueError``.
    """
    _check_family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    with torch.no_grad():
        h = embed(params["embed"], token[:, None], cfg.param_dtype())   # (B, 1, d)
        idx = cache.index
        positions = _positions(h.shape[0], 1, idx, h.device)
        ssm, attn = (cache.ssm, cache.kv) if cfg.family == "hybrid" else (cache, cache)
        for kind, lp, slot in _schedule(params, cfg):
            if kind == "ssm":
                h = _ssm_step(lp, h, cfg, ssm, slot, idx)
            else:
                h = _attn_step(lp, h, cfg, attn, slot, idx, positions)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = unembed(params["embed"], h)[:, 0, :]
    return logits, set_index(cache, idx + 1)
