"""One-card dry run: run every (arch x shape) cell on one H100 at the batch
the card holds (the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for a fake 256/512-chip TPU mesh and never runs it).

Per cell (:func:`run_cell`):

  1. the batch: the largest power of two <= the shape's global batch whose
     resident bytes plus its activations fit ``CARD_FRACTION`` of the
     card's memory (:func:`choose_batch`).  Resident bytes are exact and
     shape-only (``init_params``/``init_cache`` on the meta device):
     params, AdamW state, gradients and the float32 gradient accumulator
     of more than one microbatch for ``train``; params and the KV/SSM cache
     for ``prefill`` and ``decode``.  The activations are measured: one
     step at batch 1 (:func:`measure_per_row`), its peak beyond the
     resident bytes, times the sequences a pass holds (an estimate: batch
     1's fixed bytes scale with it, and some steps' activations grow
     faster than their batch, so a larger batch's peak can fall on either
     side of it).  A cell whose
     resident bytes, or batch 1's measured need, pass the budget (or that
     runs out of memory at batch 1) is recorded as ``does_not_fit`` (the
     reference's ``fits_16GiB`` on the card's own memory).  On the CPU
     nothing is measured and resident bytes alone choose;
  2. seeded weights, inputs and (decode) cache on the device; decode
     attends over the whole cache: its index is ``seq_len - 1``;
  3. one step under ``roofline.ops.count`` (FLOPs by type, bytes by op,
     the kernels' costs) and its kernel launches from the wrappers'
     counters; it is the warm-up at the cell's batch (at batch 1 the
     measurement's step was one already), and is kept apart from the
     timed steps because the count slows the host;
  4. ``steps`` timed steps (CUDA events; min, median, max), and the peak
     of ``torch.cuda.max_memory_allocated`` over the cell at its batch,
     less what the process held before the cell;
  5. a JSON record in ``out_dir`` with the roofline
     (``roofline.analysis``: the counted terms, and a floor from the
     resident bytes and inputs read once and the model FLOPs at the bf16
     peak) and the card's name and power limit.

Run:  python -m repro_torch.launch.dryrun [--arch A,B] [--shape S]
      [--quant bnn_packed] [--batch N] [--steps N] [--out DIR]
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import time
import traceback

import torch

from repro_torch import tree
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.configs.base import ModelConfig, QuantConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import bitpack, bnn_matmul, bnn_matmul_mxu, flash_attention, optable_exec, packed_layer
from repro_torch.kernels import chunked_attention, decode_attention
from repro_torch.launch import shapes as shp
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.model import cache_tensors, set_index
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline import analysis
from repro_torch.roofline import ops as op_counts
from repro_torch.train.train_step import make_train_step

MESH = "h100"
CARD_FRACTION = 0.9       # of the card's memory a cell may plan to use
DEFAULT_STEPS = 3
DEFAULT_OUT = os.path.join("experiments", "dryrun")
MEASURED = ("cuda",)      # device types whose memory a batch-1 step measures
SEED = 0                  # weights, inputs and decode caches

# Every hand-written kernel's wrapper, by name: each counts its launches.
KERNELS = {
    "optable_run": optable_exec.optable_run,
    "bitpack": bitpack.bitpack,
    "pack_bits_words": bitpack.pack_bits_words,
    "packed_layer": packed_layer.packed_layer,
    "packed_layer_routed": packed_layer.packed_layer_routed,
    "bnn_matmul_packed": bnn_matmul.bnn_matmul_packed,
    "bnn_matmul_packed_experts": bnn_matmul.bnn_matmul_packed_experts,
    "bnn_matmul_mxu": bnn_matmul_mxu.bnn_matmul_mxu,
    "flash_attention": flash_attention.flash_attention,
    "chunked_attention": chunked_attention.chunked_attention,
    "decode_attention": decode_attention.decode_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def count_params(cfg: ModelConfig, params) -> tuple[float, float]:
    """(total, active) parameter counts; MoE routed experts scale by k/E."""
    total = active = 0.0
    for ps, leaf in tree.leaves_with_paths(params):
        n = float(leaf.numel())
        if re.search(r"(/|_)packed$", ps):
            n *= 32.0  # packed sign words: 32 logical weights per uint32
        if ps.endswith("/alpha"):
            continue   # scales, not weights
        total += n
        if cfg.moe and re.search(r"moe/w_(gate|up|down)", ps):
            active += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            active += n
    return total, active


def tree_bytes(t) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree.leaves(t) if isinstance(leaf, torch.Tensor))


def optimizer_for(cfg: ModelConfig) -> AdamW:
    """The reference's dry-run optimizer: bf16 moments and no master where
    the config asks for them."""
    return AdamW(moment_dtype=torch.bfloat16 if cfg.opt_half_moments else torch.float32,
                 use_master=cfg.opt_master)


def microbatches(cfg: ModelConfig, shape: shp.Shape, batch: int) -> int:
    """``microbatches_for`` on one device, capped at the batch."""
    return max(1, min(shp.microbatches_for(cfg, shape, 1), batch))


@functools.lru_cache(maxsize=64)
def _shape_only(cfg: ModelConfig) -> tuple[int, int, int]:
    """(parameter bytes, AdamW state bytes, parameter count) of ``cfg``,
    from its shape-only tree."""
    params = init_params(cfg, device="meta")
    return tree_bytes(params), tree_bytes(optimizer_for(cfg).init(params)), sum(t.numel() for t in tree.leaves(params))


def resident_bytes(cfg: ModelConfig, shape: shp.Shape, batch: int) -> dict:
    """The exact bytes a cell holds whatever its activations, shape-only:
    {"params", "optimizer", "grads", "grad_accumulator"} for train, else
    {"params", "cache"}; "total" their sum."""
    param_bytes, opt_bytes, n = _shape_only(cfg)
    out = {"params": param_bytes}
    if shape.kind == "train":
        out["optimizer"] = opt_bytes
        out["grads"] = param_bytes
        out["grad_accumulator"] = 4 * n if microbatches(cfg, shape, batch) > 1 else 0
    else:
        cache = init_cache(cfg, batch, shape.seq_len, device="meta")
        out["cache"] = sum(t.numel() * t.element_size() for t in cache_tensors(cache)) if cache else 0
    out["total"] = sum(out.values())
    return out


def input_bytes(cfg: ModelConfig, shape: shp.Shape, batch: int) -> int:
    """Bytes of the step's inputs (tokens, patches, frames, labels; a
    decode step's token), from their stand-ins."""
    if shape.kind == "train":
        stand_ins = shp.train_inputs(cfg, shape, batch)
    elif shape.kind == "prefill":
        stand_ins = shp.prefill_inputs(cfg, shape, batch)
    else:
        stand_ins = {"token": shp.decode_inputs(cfg, shape, batch)[0]}
    return sum(t.numel() * t.element_size() for t in stand_ins.values())


def rows_per_pass(cfg: ModelConfig, shape: shp.Shape, batch: int) -> int:
    """The sequences one pass of the step holds activations for: a
    microbatch's for ``train``, else the batch."""
    return batch // microbatches(cfg, shape, batch) if shape.kind == "train" else batch


def card_bytes_of(device: torch.device) -> int:
    """The memory a cell may plan against: the card's, or the host's for
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def choose_batch(cfg: ModelConfig, shape: shp.Shape, card_bytes: int, per_row: int | None) -> dict:
    """The largest power of two b <= the global batch whose resident bytes
    plus ``per_row`` activation bytes for each of its ``rows_per_pass``
    sequences fit ``CARD_FRACTION`` of ``card_bytes`` (``per_row`` None:
    resident bytes alone).  Returns {"batch" (None if 1 does not fit),
    "resident", "estimate" (None without ``per_row``), "budget"} at the
    chosen batch (at 1 when none fits)."""
    budget = int(CARD_FRACTION * card_bytes)

    def plan(b):
        estimate = None if per_row is None else per_row * rows_per_pass(cfg, shape, b)
        return {"batch": b, "resident": resident_bytes(cfg, shape, b), "estimate": estimate, "budget": budget}

    best, b = None, 1
    while b <= shape.global_batch:
        p = plan(b)
        if p["resident"]["total"] + (p["estimate"] or 0) > budget:
            break
        best, b = p, 2 * b
    return best or {**plan(1), "batch": None}


# -- building and running a cell ---------------------------------------------

def _materialize(stand_ins: dict, cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Seeded tensors for a dict of meta stand-ins: ids in [0, vocab) for
    integer ones, standard normals for float ones."""
    out = {}
    for name, t in stand_ins.items():
        if t.dtype.is_floating_point:
            out[name] = torch.randn(t.shape, generator=gen, device=device).to(t.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device=device, dtype=t.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: shp.Shape, batch: int, device, params=None):
    """-> (step, microbatches): ``step()`` runs one step of the cell at
    ``batch`` on ``device`` and returns its small output (logits or the
    training metrics); everything it needs is made here from ``SEED``
    (``params`` may be given: the tree ``init_params(cfg, SEED)`` gives)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    if params is None:
        params = init_params(cfg, SEED, device=device)
    if shape.kind == "train":
        mb = microbatches(cfg, shape, batch)
        opt = optimizer_for(cfg)
        state = opt.init(params)
        data = _materialize(shp.train_inputs(cfg, shape, batch), cfg, gen, device)
        fn = make_train_step(cfg, opt, microbatches=mb)

        def step():
            _, _, metrics = fn(params, state, data)
            return metrics["loss"]

        return step, mb

    if shape.kind == "prefill":
        data = _materialize(shp.prefill_inputs(cfg, shape, batch), cfg, gen, device)

        def step():
            with torch.inference_mode():
                if cfg.encoder_only:
                    return forward(params, data, cfg, remat=False)[0][:, -1, :]
                return prefill(params, data, cfg)[0]

        return step, 1

    token_sds, _ = shp.decode_inputs(cfg, shape, batch)
    token = _materialize({"token": token_sds}, cfg, gen, device)["token"]
    cache = init_cache(cfg, batch, shape.seq_len, device=device)
    for t in cache_tensors(cache):
        t.normal_(generator=gen)
    cache = set_index(cache, shape.seq_len - 1)

    def step():
        with torch.inference_mode():
            return decode_step(params, token, cache, cfg)[0]

    return step, 1


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def measure_per_row(cfg: ModelConfig, shape: shp.Shape, params, device):
    """Run one step at batch 1 on the card.  -> (activation bytes, step):
    the step's peak allocation beyond what was allocated with ``params``
    and beyond the rest of its exact resident bytes (cache, or optimizer
    state and gradients), and the batch-1 step, warmed up; (None, None)
    when it runs out of the card's memory."""
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    step = None
    try:
        step, _ = build_cell(cfg, shape, 1, device, params)
        step()
        _sync(device)
        oom = False
    except torch.cuda.OutOfMemoryError:
        oom = True
    if oom:
        step = None
        _free(device)
        return None, None
    resident = resident_bytes(cfg, shape, 1)
    peak = torch.cuda.max_memory_allocated(device) - before
    return max(0, peak - (resident["total"] - resident["params"])), step


def card_line(device: torch.device) -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, steps: int, device) -> list[float]:
    """Seconds of each of ``steps`` calls: CUDA events on a card, the host
    clock on the CPU."""
    if device.type != "cuda":
        out = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            out.append(time.perf_counter() - t0)
        return out
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in events:
        start.record()
        step()
        end.record()
    torch.cuda.synchronize(device)
    return [start.elapsed_time(end) / 1e3 for start, end in events]


def _write(out_dir: str | None, rec: dict) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{rec['cell']}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def run_cell(arch: str, shape_name: str, out_dir: str | None = DEFAULT_OUT, overrides: dict | None = None,
             tag: str = "", *, device="cuda", shape: shp.Shape | None = None, batch: int | None = None,
             card_bytes: int | None = None, steps: int = DEFAULT_STEPS) -> dict:
    """Run one cell (module docstring) and write its record.  ``shape``
    replaces ``SHAPES[shape_name]`` and ``overrides`` the config's fields
    (the tests run tiny cells on the CPU); ``batch`` replaces the chosen
    batch (no batch-1 measurement then); ``card_bytes`` the device's
    memory less what the process already holds on it."""
    dev = resolve_device(device)
    cfg = get_config(arch, **(overrides or {}))
    shape = shape or shp.SHAPES[shape_name]
    cell_id = f"{arch}{tag}_{shape_name}_{MESH}"
    head = {"cell": cell_id, "arch": arch + tag, "shape": shape_name, "quant": cfg.quant.mode}
    ok, reason = shp.runnable(cfg, shape)
    if not ok:
        return _write(out_dir, {**head, "status": "skipped", "reason": reason})

    card = card_line(dev)
    _free(dev)
    baseline = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0   # held before the cell
    card_bytes = card_bytes or card_bytes_of(dev) - baseline
    n_total, n_active = count_params(cfg, init_params(cfg, device="meta"))
    tokens_global = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)

    def refused(plan, why):
        return _write(out_dir, {
            **head, "status": "does_not_fit", "card": card, "global_batch": shape.global_batch, "batch": None,
            "n_params": n_total, "n_active_params": n_active,
            "model_flops": analysis.model_flops_estimate(n_active, tokens_global, shape.kind),
            "memory": {"resident_bytes": plan["resident"], "estimate_bytes": plan["estimate"],
                       "budget_bytes": plan["budget"], "card_bytes": card_bytes, "fits_card": False, "why": why},
        })

    plan = choose_batch(cfg, shape, card_bytes, None)
    if batch is None and plan["batch"] is None:
        return refused(plan, "resident bytes")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    step = measure_s = None
    if batch is None and dev.type in MEASURED:
        t0 = time.perf_counter()
        per_row, step = measure_per_row(cfg, shape, params, dev)
        measure_s = time.perf_counter() - t0
        if per_row is None:
            del params
            _free(dev)
            return refused({**plan, "batch": None, "resident": resident_bytes(cfg, shape, 1)},
                           "out of memory at batch 1")
        plan = choose_batch(cfg, shape, card_bytes, per_row)
        if plan["batch"] is None:
            del params, step
            _free(dev)
            return refused(plan, "resident bytes + batch 1's activations")
        if plan["batch"] > 1:
            step = None   # the batch-1 step's state goes before the cell's is made
            _free(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
    batch = batch or plan["batch"]
    if batch != plan["batch"]:
        plan.update(batch=batch, resident=resident_bytes(cfg, shape, batch), estimate=None)
    if step is None:
        t0 = time.perf_counter()
        step, _ = build_cell(cfg, shape, batch, dev, params)
        _sync(dev)
        init_s += time.perf_counter() - t0
    del params
    mb = microbatches(cfg, shape, batch) if shape.kind == "train" else 1

    # The counted step comes first: at a batch above 1 it is the warm-up.
    before = launch_counts()
    t0 = time.perf_counter()
    with op_counts.count() as counts:
        out = step()
        _sync(dev)
    count_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    times = _timed(step, steps, dev)
    peak = torch.cuda.max_memory_allocated(dev) - baseline if dev.type == "cuda" else None

    median = statistics.median(times)
    tokens = batch * (shape.seq_len if shape.kind != "decode" else 1)
    resident = plan["resident"]["total"]
    roof = analysis.build(
        arch=arch + tag, shape=shape_name, counts=counts,
        model_flops=analysis.model_flops_estimate(n_active, tokens, shape.kind),
        per_device_hbm_bytes=float(resident), measured_step_s=median,
        floor_bytes=float(resident + input_bytes(cfg, shape, batch)),
    )
    record = {
        **head, "status": "ok", "card": card, "device": str(dev),
        "global_batch": shape.global_batch, "batch": batch, "microbatches": mb, "seq_len": shape.seq_len,
        "tokens_per_step": tokens, "n_params": n_total, "n_active_params": n_active,
        "init_s": init_s, "measure_s": measure_s, "count_s": count_s,
        "step_s": {"min": min(times), "median": median, "max": max(times), "all": times},
        "tokens_per_s": tokens / median,
        "memory": {"resident_bytes": plan["resident"], "estimate_bytes": plan["estimate"],
                   "budget_bytes": plan["budget"], "card_bytes": card_bytes, "peak_bytes": peak,
                   "baseline_bytes": baseline,
                   "fits_card": resident + (plan["estimate"] or 0) <= plan["budget"]},
        "roofline": roof.row(),
        "counts": counts.summary(),
        "launches": launches,
        "output": {"shape": list(out.shape), "finite": bool(torch.isfinite(out).all())},
    }
    return _write(out_dir, record)


def _need(m: dict) -> float:
    """GiB of a record's resident bytes plus its activation estimate."""
    return (m["resident_bytes"]["total"] + (m["estimate_bytes"] or 0)) / 2**30


def summary_line(rec: dict) -> str:
    """The one line the sweep prints for a record."""
    status = rec["status"]
    if status == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f"batch={rec['batch']}/{rec['global_batch']} step={rec['step_s']['median']:.4g}s "
                 f"tokens/s={rec['tokens_per_s']:.4g} peak={m['peak_bytes'] / 2**30 if m['peak_bytes'] else 0:.2f}GiB "
                 f"est={_need(m):.2f}GiB bound={r['step_time_s']:.4g}s bottleneck={r['bottleneck']} "
                 f"floor={r['floor_s']:.4g}s roofline_frac={r['roofline_fraction']:.3f} mfu={r['mfu']:.4f}")
    elif status == "skipped":
        extra = rec["reason"]
    elif status == "does_not_fit":
        m = rec["memory"]
        if m["why"] == "out of memory at batch 1":
            extra = f"out of memory at batch 1 ({_need(m):.2f}GiB resident, budget {m['budget_bytes'] / 2**30:.2f}GiB)"
        else:
            extra = f"batch 1 needs {_need(m):.2f}GiB > {m['budget_bytes'] / 2**30:.2f}GiB ({m['why']})"
    else:
        extra = rec["error"]
    return f"[{status}] {rec['cell']} {extra}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="N2Net framework one-card dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--quant", default="none", help="bnn quant mode override")
    ap.add_argument("--batch", type=int, default=None, help="run every cell at this batch")
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS, help="timed steps a cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else args.arch.split(",")
    shape_names = list(shp.SHAPES) if args.shape == "all" else args.shape.split(",")
    overrides, tag = {}, ""
    if args.quant != "none":
        overrides["quant"] = QuantConfig(mode=args.quant)
        tag = f"+{args.quant}"
    print(card_line(resolve_device(args.device)), flush=True)

    results = []
    for arch in archs:
        for shape_name in shape_names:
            cell = f"{arch}{tag}_{shape_name}_{MESH}"
            path = os.path.join(args.out, cell + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip-existing] {cell}")
                continue
            try:
                rec = run_cell(arch, shape_name, args.out, overrides, tag, device=args.device,
                               batch=args.batch, steps=args.steps)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                rec = _write(args.out, {"cell": cell, "arch": arch + tag, "shape": shape_name,
                                        "status": "error", "error": f"{type(e).__name__}: {e}",
                                        "trace": traceback.format_exc()[-2000:]})
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            results.append(rec)
            print(summary_line(rec), flush=True)

    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "skipped", "does_not_fit", "error")}
    print(f"\ndone: {n['ok']} ok, {n['skipped']} skipped, {n['does_not_fit']} do not fit, {n['error']} errors")
    return 0 if n["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
