"""Training launcher: train an architecture with the ``Trainer`` (the
reference's ``launch/train.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 100 --batch 8 --seq 128 [--reduced] [--quant bnn_weight_only]

``--device`` defaults to ``cuda``.  ``--reduced`` trains :func:`reduced` of
the architecture: the port's copy of ``examples/train_lm.py::reduced``
(which imports JAX), every family's branch kept.  ``--inject-failure N``
raises inside step N to exercise recovery (``examples/train_lm.py``'s
flag).  The reference's ``--distributed`` starts a multi-host JAX run; one
card has no other host, so the flag exits with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ModelConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The same family at 6 layers of width 256 (the reference's training
    recipe, ``examples/train_lm.py:23-42``)."""
    extra = {}
    if cfg.ssm is not None:
        extra["ssm"] = dataclasses.replace(cfg.ssm, state_dim=32, head_dim=32, chunk=32)
    if cfg.moe is not None:
        extra["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, expert_ffn_dim=128
        )
    if cfg.mla is not None:
        extra["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, q_lora_rank=96, qk_nope_dim=32,
            qk_rope_dim=16, v_head_dim=32,
        )
    if cfg.family == "hybrid":
        extra["hybrid_period"] = 3
    return dataclasses.replace(
        cfg, num_layers=6, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=512, vocab_size=2048, attn_q_chunk=64,
        fsdp=False, **extra,
    )


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns the ``Trainer.run`` result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_launch_train"))
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which to simulate a node failure")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training (no meaning on one card: raises)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.distributed:
        ap.error("--distributed starts a multi-host run (the reference's jax.distributed.initialize); "
                 "the port trains on one card, where it has no meaning")

    from repro_torch.configs.base import QuantConfig, get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.quant != "none":
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode=args.quant))

    tcfg = TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=max(10, args.steps // 4),
        checkpoint_dir=args.ckpt_dir,
        microbatches=args.microbatches,
        compression=args.compression,
        global_batch=args.batch,
        seq_len=args.seq,
        fail_at_steps=(args.inject_failure,) if args.inject_failure >= 0 else (),
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    out = trainer.run()
    print(f"done at step {out['final_step']}; recoveries={out['recoveries']}")
    return out


if __name__ == "__main__":
    main()
