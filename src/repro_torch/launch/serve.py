"""Serving launcher: stand up an Engine for an architecture and drain a
synthetic request stream (the reference's ``launch/serve.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced --device cpu

``--device`` defaults to ``cuda``.  ``--reduced`` serves :func:`small` of
the architecture: the port's copy of ``examples/serve_batched.py::small``
(which imports JAX), every family's branch kept.  As the reference's
launcher, it serves eight of the ten archs and fails on two: hubert-xlarge
is encoder-only (the ``Engine`` raises ``ValueError``), and the ``Engine``
prefills internvl2-2b's tokens without the patch embeddings its
``tokens+patches`` input needs (``KeyError: 'patches'``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.base import ModelConfig


def small(cfg: ModelConfig) -> ModelConfig:
    """The same family at 4 layers of width 128 (the reference's per-arch
    serving recipe, ``examples/serve_batched.py:23-42``)."""
    extra = {}
    if cfg.ssm is not None:
        extra["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk=16)
    if cfg.moe is not None:
        extra["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, expert_ffn_dim=64
        )
    if cfg.mla is not None:
        extra["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, q_lora_rank=64, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16,
        )
    if cfg.family == "hybrid":
        extra["hybrid_period"] = 2
    return dataclasses.replace(
        cfg, num_layers=4, d_model=128, num_heads=8, num_kv_heads=4,
        head_dim=16, d_ff=256, vocab_size=512, attn_q_chunk=32, fsdp=False,
        **extra,
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = small(cfg)

    params = init_params(cfg, 0, device=args.device)
    eng = Engine(cfg, params, max_batch=args.max_batch, max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 24))).astype(np.int32),
            max_new_tokens=args.new_tokens,
        ))
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s")


if __name__ == "__main__":
    main()
