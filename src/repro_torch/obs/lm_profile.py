"""Where an LM decode or training step's time goes, on one GPU: a
``torch.profiler`` trace.

Builds ``--arch`` (default phi3-mini-3.8b; any arch the ``Engine`` serves,
such as qwen3-moe-30b-a3b, mamba2-1.3b or zamba2-1.2b) at its published
config (weights from a seed, bf16, ``bnn_packed`` projections and experts),
fills the 4 slots of an ``Engine`` with 128-token prompts, takes 3 warm-up decode steps, then traces ``--steps``
decode steps and prints, per step:

* the host wall time (each step ends with its tokens on the host);
* the device's busy time (the union of kernel intervals) and idle share;
* kernel launches, and device time by kernel name;
* the host operators with the most self time.

With ``--train`` it traces ``make_train_step`` instead, at
``chip_smoke.py``'s training configuration (bf16, ``bnn_weight_only`` on
``ffn`` and ``attn_proj``, remat, ``AdamW(lr=1e-3)`` in place, batches of
8 x 128 from ``SyntheticTokens``), after a
warm-up step and one step timed in two parts: the gradients
(``_accumulate_grads``) and the optimizer (``AdamW.update_``).

Run from the repository root on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.obs.lm_profile [--arch A] [--steps 5] [--trace out.json]
    PYTHONPATH=src python -m repro_torch.obs.lm_profile --train [--steps 2]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import models
from repro_torch.configs.base import QuantConfig, get_config
from repro_torch.serving.engine import Engine, Request

# chip_smoke.py's serving configuration: every slot full, prompts as long as
# its longest.
ARCH = "phi3-mini-3.8b"
SLOTS = 4
PROMPT = 128
SEED = 0
# chip_smoke.py's training configuration: launch/train.py's batch and sequence.
TRAIN_BATCH, TRAIN_SEQ = 8, 128


def _busy_us(events) -> float:
    """Length of the union of the device intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _report(prof, label: str, wall_ms: float, steps: int) -> None:
    """Print a traced window's per-step wall and busy time, idle share,
    kernel launches and device time by kernel, and the host's top operators."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us(kernels) / 1e3 / steps
    print(f"{label}: {wall_ms} ms on the host clock; device busy {busy_ms} ms per step "
          f"(idle share {1 - busy_ms / wall_ms}); {len(kernels) / steps} kernels per step")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    print("device time per step by kernel (ms, launches):")
    for name, times in rows[:15]:
        print(f"  {sum(times) / 1e3 / steps:.6f}  {len(times) / steps:g}  {name[:110]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


@torch.inference_mode()  # serving records no autograd graph
def _decode(args) -> None:
    cfg = get_config(args.arch, quant=QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj", "moe")))
    params = models.init_params(cfg, SEED, device="cuda")
    eng = Engine(cfg, params, max_batch=SLOTS, max_len=PROMPT + 3 + args.steps + 8)
    rng = np.random.default_rng(SEED)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32),
                           max_new_tokens=10_000))
    eng._admit()
    for _ in range(3):
        eng._step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng._step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    _report(prof, f"{cfg.name}, {cfg.num_layers} layers, {SLOTS} slots, index {eng.cache.index}: decode step",
            wall_ms, args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)


def _train(args) -> None:
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import _accumulate_grads, make_train_step

    cfg = get_config(args.arch, quant=QuantConfig(mode="bnn_weight_only"))
    params = models.init_params(cfg, SEED, device="cuda")
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    data = SyntheticTokens(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)

    def batch():
        return {k: torch.from_numpy(v).cuda() for k, v in data.next_batch().items()}

    step = make_train_step(cfg, opt)
    params, state, _ = step(params, state, batch())
    b = batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = _accumulate_grads(params, b, cfg, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, state, _ = opt.update_(grads, state, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    print(f"{cfg.name} training step, {cfg.num_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: gradients "
          f"{(t1 - t0) * 1e3} ms, optimizer {(t2 - t1) * 1e3} ms (host clock, synchronized); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9} GB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, state, metrics = step(params, state, batch())
            float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    _report(prof, f"{cfg.name} training step ({cfg.num_layers} layers)", wall_ms, args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, help="a ported architecture")
    ap.add_argument("--steps", type=int, default=5, help="steps to trace")
    ap.add_argument("--train", action="store_true", help="trace training steps instead of decode steps")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_profile needs a CUDA device")
    if args.train:
        _train(args)
    else:
        _decode(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
