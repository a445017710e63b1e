"""Token embedding and output head (the reference's ``layers/embedding.py``)."""
from __future__ import annotations

import torch


def embedding_init(
    generator: torch.Generator, vocab: int, d: int, *, std: float = 0.02,
    dtype=torch.float32,
) -> dict:
    table = torch.randn((vocab, d), generator=generator, device=generator.device) * std
    return {"table": table.to(dtype)}


def embed(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ params["table"].float().T
