"""Perf hillclimbing on one card: run named variants of three cells
beside their base cells and print before -> after roofline terms (the
reference's ``launch/hillclimb.py``).

Cells (the reference's selection):
  A. deepseek-v2-236b  train_4k   — collective-bound on the pod.
  B. chatglm3-6b       train_4k   — f32 all-reduces and score traffic.
  C. phi3-mini-3.8b    decode_32k / prefill_32k — the paper's technique:
     packed-weight (XNOR-popcount) inference.

Each variant and its base run in the same process on the card (the
reference compares against a stored pod record).  A cell whose base does
not fit one card is reported as such and not run: A and B do not (their
training state alone is beyond 80 GB), and the knob of A1 and B1,
``ar_bf16``, has no meaning on one device, which makes no all-reduce.

Usage: python -m repro_torch.launch.hillclimb [--only C1,C2]
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp

EXPERIMENTS = {
    # --- cell A: deepseek train (collective-bound: FSDP gathers + f32 AR) ---
    "A1": ("deepseek-v2-236b", "train_4k", {"ar_bf16": True}, "+arbf16"),
    "A2": ("deepseek-v2-236b", "train_4k",
           {"ar_bf16": True, "microbatches": 8}, "+arbf16+mb8"),
    "A3": ("deepseek-v2-236b", "train_4k",
           {"ar_bf16": True, "microbatches": 8, "attn_scores_dtype": "bf16"},
           "+arbf16+mb8+sbf16"),
    # --- cell B: chatglm train (f32 AR + score traffic) ---
    "B1": ("chatglm3-6b", "train_4k", {"ar_bf16": True}, "+arbf16"),
    "B2": ("chatglm3-6b", "train_4k",
           {"ar_bf16": True, "attn_scores_dtype": "bf16"}, "+arbf16+sbf16"),
    "B3": ("chatglm3-6b", "train_4k",
           {"ar_bf16": True, "attn_scores_dtype": "bf16", "microbatches": 4},
           "+arbf16+sbf16+mb4"),
    # --- cell C: phi3 decode (the paper's technique: packed BNN weights) ---
    "C1": ("phi3-mini-3.8b", "decode_32k",
           {"quant": QuantConfig(mode="bnn_packed",
                                 targets=("ffn", "attn_proj"))}, "+bnnpacked"),
    "C2": ("phi3-mini-3.8b", "prefill_32k",
           {"quant": QuantConfig(mode="bnn_packed",
                                 targets=("ffn", "attn_proj"))}, "+bnnpacked"),
}


def compare_lines(name: str, arch: str, shape: str, tag: str, base: dict, rec: dict) -> str:
    """The reference's before -> after lines, with the batches, the measured
    step and the mfu."""
    b, r = base["roofline"], rec["roofline"]
    return (
        f"[{name}] {arch} {shape} {tag} (batch {base['batch']} -> {rec['batch']} of {rec['global_batch']})\n"
        f"  compute    {b['compute_s']:.4g} -> {r['compute_s']:.4g}\n"
        f"  memory     {b['memory_s']:.4g} -> {r['memory_s']:.4g}\n"
        f"  collective {b['collective_s']:.4g} -> {r['collective_s']:.4g}\n"
        f"  step(max)  {b['step_time_s']:.4g} -> {r['step_time_s']:.4g} "
        f"({b['step_time_s'] / max(r['step_time_s'], 1e-12):.2f}x)\n"
        f"  measured   {b['measured_step_s']:.4g} -> {r['measured_step_s']:.4g} "
        f"({b['measured_step_s'] / max(r['measured_step_s'], 1e-12):.2f}x)\n"
        f"  roofline_frac {b['roofline_fraction']:.4f} -> {r['roofline_fraction']:.4f}\n"
        f"  mfu        {b['mfu']:.4f} -> {r['mfu']:.4f}\n"
        f"  peak GiB   {base['memory']['peak_bytes'] / 2**30:.2f} -> {rec['memory']['peak_bytes'] / 2**30:.2f}"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="all")
    ap.add_argument("--out", default=os.path.join("experiments", "hillclimb"))
    ap.add_argument("--steps", type=int, default=dryrun.DEFAULT_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = list(EXPERIMENTS) if args.only == "all" else args.only.split(",")
    dev = resolve_device(args.device)
    card_bytes = dryrun.card_bytes_of(dev)
    print(dryrun.card_line(dev), flush=True)

    bases: dict = {}
    failed = 0
    for name in names:
        arch, shape, overrides, tag = EXPERIMENTS[name]
        plan = dryrun.choose_batch(get_config(arch), shp.SHAPES[shape], card_bytes, None)
        if plan["batch"] is None:
            need = plan["resident"]["total"]
            note = " (ar_bf16 has no meaning on one device: it makes no all-reduce)" if "ar_bf16" in overrides else ""
            print(f"[{name}] {arch} {shape} {tag}: does not fit one card: batch 1's resident bytes are "
                  f"{need / 2**30:.2f} GiB > {plan['budget'] / 2**30:.2f} GiB; not run{note}", flush=True)
            continue
        try:
            if (arch, shape) not in bases:
                bases[arch, shape] = dryrun.run_cell(arch, shape, args.out, device=dev, steps=args.steps)
            rec = dryrun.run_cell(arch, shape, args.out, overrides, tag, device=dev, steps=args.steps)
        except Exception as e:  # noqa: BLE001 — report, keep going
            print(f"[{name}] ERROR: {type(e).__name__}: {e}", flush=True)
            failed += 1
            continue
        print(compare_lines(name, arch, shape, tag, bases[arch, shape], rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
