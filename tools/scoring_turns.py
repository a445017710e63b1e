"""phi3-mini-3.8b scoring time of two source trees, timed in turns on one card.

Scores one 2048-token sequence with ``models.forward`` as ``chip_smoke.py``
does (phi3-mini-3.8b at its published widths and 32 layers, bf16,
``bnn_packed`` on ``ffn`` and ``attn_proj``, flash attention, weights and
tokens from seed 0): one warm-up pass (kernel builds), then ``--reps`` timed
passes, each ending in ``torch.cuda.synchronize()``.  The line gives every
pass's seconds, their median and the packed GEMM's launches by route over
the timed passes.

Each tree runs in a process of its own (``multitenant_turns.run_turns``),
from the tree's root with ``PYTHONPATH=<tree>/src``, so each imports and
builds its own ``repro_torch``, in the order given: pass the parent and the
change as ``--trees PARENT CHANGE --order ABBA`` to time parent, change,
change, parent::

    python tools/scoring_turns.py --trees tree_check/parent . --out scoring_turns.jsonl

Each line it prints (and appends to ``--out``) is one JSON object per tree
and run; ``--device cpu --reduced`` rehearses it on a 2-layer phi3 of width
128 over 64 tokens on the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ARCH = "phi3-mini-3.8b"
LENGTH = 2048
REDUCED = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=97)


def worker(device: str, reps: int, reduced: bool) -> dict:
    """The timed passes on this process's ``repro_torch``; returns the record."""
    import torch

    from repro_torch import models
    from repro_torch.configs.base import QuantConfig, get_config
    from repro_torch.kernels import bnn_matmul

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scoring_turns: no CUDA device")
    cfg = get_config(ARCH, quant=QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj")),
                     attn_impl="pallas_flash", **(REDUCED if reduced else {}))
    length = 64 if reduced else LENGTH
    params = models.init_params(cfg, 0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=torch.Generator().manual_seed(0)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    seconds = []
    with torch.inference_mode():
        models.forward(params, {"tokens": tokens}, cfg)
        sync()
        before = dict(bnn_matmul.bnn_matmul_packed.launches_by_route)
        for _ in range(reps):
            t0 = time.perf_counter()
            logits, _ = models.forward(params, {"tokens": tokens}, cfg)
            sync()
            seconds.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("scoring_turns: non-finite logits")
    routes = {p: n - before.get(p, 0) for p, n in bnn_matmul.bnn_matmul_packed.launches_by_route.items()}
    return {"tree": os.environ.get("PYTHONPATH", ""),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "arch": ARCH, "layers": cfg.num_layers, "tokens": length, "scoring_s": seconds,
            "median_s": statistics.median(seconds), "bnn_matmul_packed_launches_by_route": routes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees (directories holding src/repro_torch)")
    ap.add_argument("--order", default="ABBA", help="letters naming --trees in turn (A is the first)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal on the plain versions")
    ap.add_argument("--reduced", action="store_true", help="a 2-layer phi3 of width 128 over 64 tokens")
    ap.add_argument("--out", help="append each run's JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.device, args.reps, args.reduced)))
        return 0
    from multitenant_turns import run_turns  # the same turns, one process a tree

    return run_turns(__file__, args.trees, args.order,
                     ["--reps", str(args.reps), "--device", args.device, *(["--reduced"] if args.reduced else [])],
                     args.out)


if __name__ == "__main__":
    sys.exit(main())
