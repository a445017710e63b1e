"""The served attention of two or more source trees, timed in turns on one card.

Two measurements, each tree in a process of its own (``multitenant_turns.run_turns``,
from the tree's root with ``PYTHONPATH=<tree>/src``, so each imports and
builds its own ``repro_torch``):

* ``kernels``: ``chunked_attention`` at phi3-mini-3.8b's prefill (32 heads
  of 96) and qwen3-moe-30b-a3b's (32 query heads over 4 KV heads of 128),
  1 x 2048 and 1 x 32,768 tokens, bf16, causal; ``decode_attention`` at
  their decode_32k layers (4 slots over 32,768 keys: phi3 incremental,
  qwen3 in the cache).  CUDA events over back-to-back launches after two
  warm-up calls, in ms a call.  Then ``decode_attention`` at short caches,
  phi3 at index 128 and chatglm3-6b (32 query heads over 2 KV heads of
  128, in the cache) at index 2047 of 2048: CUDA events over replays of a
  CUDA graph of 20 calls, in ms a call (a call takes microseconds, so the
  host's launch time would set a back-to-back figure).  A tree without the
  kernels records none.
* ``cells``: ``chip_smoke.py``'s dry-run cells of that tree (phi3
  ``bnn_packed`` decode_32k and prefill_32k at 4 layers, zamba2 long_500k)
  through ``launch/dryrun.py::run_cell``, each at the batch it chooses, and
  the prefill cell again at batch 4: batch, median step s and launches.

Pass the parent and the change as ``--trees PARENT CHANGE --order ABBA`` to
time parent, change, change, parent::

    python tools/attention_turns.py --trees tree_check/parent . --what cells --out turns.jsonl

Each line it prints (and appends to ``--out``) is one JSON object per tree
and run.  ``--device cpu`` rehearses ``kernels`` on the plain versions at 1
x 64 tokens and 4 x 64 keys (host clock).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# (name, query heads, KV heads, head dim, decode mode)
MODELS = (("phi3", 32, 32, 96, "incremental"), ("qwen3", 32, 4, 128, "in_cache"))
PREFILLS = (2048, 32768)
DECODE_KEYS = 32768
DECODE_SLOTS = 4
PREFILL_BATCH = 4   # the batch the dry run chose for the prefill cell while scores were float32 blocks
# (name, query heads, KV heads, head dim, decode mode, cache positions, index)
SHORT_DECODES = (("phi3", 32, 32, 96, "incremental", 32768, 128), ("chatglm3", 32, 2, 128, "in_cache", 2048, 2047))
GRAPH_CALLS = 20


def _timer(device):
    import torch

    def ms(fn, iters: int) -> float:
        for _ in range(2):
            fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    return ms


def _graph_ms(fn, replays: int = 20) -> float:
    """ms a call of ``fn`` from replays of a CUDA graph of GRAPH_CALLS calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * GRAPH_CALLS)


def kernels(device) -> dict:
    """ms a call of each kernel at the shapes of MODELS."""
    import torch

    try:
        from repro_torch.kernels import chunked_attention as ck, decode_attention as dk
    except ImportError:
        return {"kernels": None}
    ms = _timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    cpu = device.type == "cpu"
    out = {}
    for name, h, kvh, d, mode in MODELS:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

        for s in ((64,) if cpu else PREFILLS):
            q, k, v = randn(1, s, h, d), randn(1, s, kvh, d), randn(1, s, kvh, d)
            out[f"chunked_{name}_s{s}_ms"] = ms(
                lambda: ck.chunked_attention(q, k, v, causal=True, q_chunk=1024, scale=d ** -0.5),
                20 if s <= 2048 else 3)
            del q, k, v
        keys = 64 if cpu else DECODE_KEYS
        q = randn(DECODE_SLOTS, 1, h, d)
        kc, vc = randn(DECODE_SLOTS, keys, kvh, d), randn(DECODE_SLOTS, keys, kvh, d)
        new = dict(k_new=randn(DECODE_SLOTS, 1, kvh, d), v_new=randn(DECODE_SLOTS, 1, kvh, d)) \
            if mode == "incremental" else {}
        out[f"decode_{name}_{keys}_ms"] = ms(
            lambda: dk.decode_attention(q, kc, vc, keys - 1, scale=d ** -0.5, **new), 50)
        del q, kc, vc, new
    for name, h, kvh, d, mode, s_max, index in SHORT_DECODES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

        s_max = min(s_max, 64) if cpu else s_max
        index = min(index, s_max - 1)
        q = randn(DECODE_SLOTS, 1, h, d)
        kc, vc = randn(DECODE_SLOTS, s_max, kvh, d), randn(DECODE_SLOTS, s_max, kvh, d)
        new = dict(k_new=randn(DECODE_SLOTS, 1, kvh, d), v_new=randn(DECODE_SLOTS, 1, kvh, d)) \
            if mode == "incremental" else {}
        call = lambda: dk.decode_attention(q, kc, vc, index, scale=d ** -0.5, **new)  # noqa: E731
        out[f"decode_{name}_index{index}_ms"] = ms(call, 50) if cpu else _graph_ms(call)
        del q, kc, vc, new
    return out


def cells(device) -> dict:
    """The tree's chip_smoke.py dry-run cells (phi3 decode_32k and 4-layer
    prefill_32k, zamba2 long_500k), and the prefill cell at PREFILL_BATCH."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, overrides, tag, steps in cs.DRYRUN_CELLS[:3]:
            batches = (None, PREFILL_BATCH) if shape == "prefill_32k" else (None,)
            for batch in batches:
                torch.cuda.empty_cache()
                rec = cs.dryrun.run_cell(arch, shape, d, overrides, tag, device=device, steps=steps, batch=batch)
                key = f"{arch}{tag} {shape}" + (f" at batch {batch}" if batch else "")
                out[key] = {"batch": rec["batch"], "step_s": rec["step_s"]["median"], "launches": rec["launches"]}
    return out


def worker(device: str, what: list) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("attention_turns: no CUDA device")
    rec = {"tree": os.environ.get("PYTHONPATH", ""),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if "kernels" in what:
        rec.update(kernels(dev))
    if "cells" in what:
        if dev.type != "cuda":
            raise SystemExit("attention_turns: the dry-run cells run on the card only")
        rec.update(cells(dev))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees (directories holding src/repro_torch)")
    ap.add_argument("--order", default="ABBA", help="letters naming --trees in turn (A is the first)")
    ap.add_argument("--what", default="kernels", help="kernels, cells or kernels,cells")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse the kernels on the plain versions")
    ap.add_argument("--out", help="append each run's JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    what = args.what.split(",")
    if args.worker:
        print(json.dumps(worker(args.device, what)))
        return 0
    from multitenant_turns import run_turns  # the same turns, one process a tree

    return run_turns(__file__, args.trees, args.order, ["--what", args.what, "--device", args.device], args.out)


if __name__ == "__main__":
    sys.exit(main())
