"""Assigned input shapes and per-(arch x shape) input stand-ins (the
reference's ``launch/shapes.py``).

Shapes (LM-family, per the assignment):
  train_4k    — seq 4096,    global batch 256 (training step)
  prefill_32k — seq 32768,   global batch 32  (inference prefill)
  decode_32k  — seq 32768,   global batch 128 (one token vs 32k cache)
  long_500k   — seq 524288,  global batch 1   (long-context decode)

``decode_*`` / ``long_*`` run ``decode_step`` (one new token with a KV/SSM
cache of seq_len), not a training step.  Skips, as the reference's:
``long_500k`` for pure full-attention archs; ``decode_32k``/``long_500k``
for encoder-only archs.

The stand-ins are tensors on the ``meta`` device (the reference's
``jax.ShapeDtypeStruct``): shapes and types, no storage.  ``batch=``
replaces the shape's global batch (the dry run's batch on one card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_cache


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and the reason when skipped."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (full-attn arch)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: Shape, batch: int | None = None) -> dict:
    """Meta stand-ins for a training batch."""
    b, s = batch or shape.global_batch, shape.seq_len
    if cfg.input_mode == "frames":
        return {
            "frames": _meta((b, s, cfg.d_model), cfg.param_dtype()),
            "labels": _meta((b, s), torch.int32),
        }
    if cfg.input_mode == "tokens+patches":
        st = s - cfg.num_patches
        return {
            "tokens": _meta((b, st), torch.int32),
            "patches": _meta((b, cfg.num_patches, cfg.d_model), cfg.param_dtype()),
            "labels": _meta((b, st), torch.int32),
        }
    return {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
    }


def prefill_inputs(cfg: ModelConfig, shape: Shape, batch: int | None = None) -> dict:
    out = train_inputs(cfg, shape, batch)
    out.pop("labels", None)
    return out


def decode_inputs(cfg: ModelConfig, shape: Shape, batch: int | None = None) -> tuple:
    """(token, cache) stand-ins for a decode step: the cache is
    ``init_cache`` on the meta device."""
    b, s = batch or shape.global_batch, shape.seq_len
    return _meta((b,), torch.int32), init_cache(cfg, b, s, device="meta")


def microbatches_for(cfg: ModelConfig, shape: Shape, dp_size: int) -> int:
    """Gradient-accumulation factor: as many microbatches as the batch allows
    without dropping below one sequence per data shard."""
    if shape.kind != "train":
        return 1
    want = getattr(cfg, "microbatches", 1) or 1
    return max(1, min(want, shape.global_batch // max(1, dp_size)))
