"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

What it does, in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from this checkout and prints the build time;
3. holds every kernel of the packet path against its plain PyTorch version on
   the card, bit for bit (``torch.equal``), at the shapes the main path gives
   it: ``optable_run`` on the headline model's tables for the default and the
   native-popcount chip (all six opcodes) and on FIVE_TUPLE's (the 64-thread
   shared-memory case); ``pack_bits_words`` and ``bitpack`` at ragged widths;
   ``packed_layer`` including pad neurons.  Each kernel and its plain version
   are timed with CUDA events;
4. drives the main path: the headline model (``BnnSpec((32, 64, 32))``,
   weights from a fixed seed) streams 2**20 ``ddos_burst`` packets at chunk
   32768 through ``execute_stream`` with the op-table backend and with the
   packed backend.  The launch count of every kernel is zeroed just before
   and read just after each run.  The two outputs must agree on every
   packet, and on the first chunk with the port's interpreter and the BNN
   oracle;
5. prints one JSON line of per-kernel numbers, then the status line.

Any failure raises, so the script exits non-zero; it also exits non-zero
without a CUDA device, before doing anything.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.n2net_paper import FIVE_TUPLE, HEADLINE  # noqa: E402
from repro_torch.core import bnn, compiler, interpreter  # noqa: E402
from repro_torch.core.pipeline import RMT, RMT_NATIVE_POPCNT  # noqa: E402
from repro_torch.dataplane import executor, lowering, traffic  # noqa: E402
from repro_torch.kernels import _build, bitpack, optable_exec, packed_layer  # noqa: E402

PACKETS = 1 << 20
CHUNK = 1 << 15
SEED = 0
SCENARIO = "ddos_burst"

# Peak rates of one H100 SXM at its 700 W limit.  Bytes: NVIDIA's data sheet
# (3.35 TB/s HBM3).  The kernels do 32-bit integer work outside the tensor
# cores: 64 INT32 lanes per SM (Hopper architecture white paper) x 132 SMs
# x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, *args, iters: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs integer
    operations over the INT32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def same(what: str, out: torch.Tensor, ref: torch.Tensor) -> int:
    """Fail unless ``out`` equals ``ref`` bit for bit; returns the max
    absolute difference measured (0 when it returns)."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: kernel gives {out.dtype} {tuple(out.shape)}, "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    diff = int((out.long() - ref.long()).abs().max().item()) if out.numel() else 0
    if diff or not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max diff {diff})")
    print(f"  {what}: bit-exact")
    return diff


def build_kernels() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {len(logs)} sources (nvcc in parallel)")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "bytes smem" in line:
                print(f"  {name}: {line.strip()}")


def check_optable(dev, programs: dict, lp, pkt) -> dict:
    """``optable_run`` against its plain version on each program's parsed
    chunk; timed on the headline model's (the main path's) shapes."""

    def parsed(lowered, packets):
        t = executor._device_tables(lowered, dev)
        return executor.parse_packets(packets, *t.io[:2], num_regs=lowered.num_regs), t

    err = 0
    for label, (lowered, packets) in programs.items():
        regs, t = parsed(lowered, packets)
        threads = optable_exec.block_threads(lowered.num_regs, lowered.max_rows)
        err = max(err, same(
            f"optable_run {label} ({lowered.num_regs} regs x {CHUNK} packets, {threads} threads/block)",
            optable_exec.optable_run(regs, *t.ops, t.first_write),
            optable_exec.optable_run_plain(regs, *t.ops, t.first_write),
        ))
    regs, t = parsed(lp, pkt)
    nbytes = 2 * lp.num_regs * CHUNK * 4 + 8 * lp.opcode.size * 4
    b_ms, b_by = bound_ms(nbytes, 3 * lp.num_ops * CHUNK)  # ALU, mask, write-back per true row
    return dict(
        source="src/repro_torch/csrc/optable_exec.cu",
        replaces="src/repro/kernels/optable_exec.py:87",
        max_abs_err=err,
        ms=time_ms(optable_exec.optable_run, regs, *t.ops, t.first_write),
        plain_ms=time_ms(optable_exec.optable_run_plain, regs, *t.ops, t.first_write, iters=3),
        bound_ms=b_ms, bound_by=b_by,
    )


def check_bitpack(dev, layer_inputs) -> dict:
    """``pack_bits_words`` (and ``bitpack``) against the plain packer at
    ragged widths and at the main path's per-layer inputs; timed per chunk
    (one launch per layer)."""
    err = 0
    gen = torch.Generator().manual_seed(SEED)
    for n in (1, 31, 33, 100, 2048):
        bits = torch.randint(0, 2, (4099, n), generator=gen, dtype=torch.int32).to(dev)
        err = max(err, same(f"pack_bits_words (4099, {n})", bitpack.pack_bits_words(bits),
                            bitpack.pack_ge_plain(bits, 1)))
    x = torch.randn((4099, 256), generator=gen).to(dev)
    err = max(err, same("bitpack float32 (4099, 256)", bitpack.bitpack(x), bitpack.pack_ge_plain(x, 0)))
    ms = plain = nbytes = ops = 0.0
    for h in layer_inputs:
        err = max(err, same(f"pack_bits_words {tuple(h.shape)}", bitpack.pack_bits_words(h),
                            bitpack.pack_ge_plain(h, 1)))
        m, n = h.shape
        ms += time_ms(bitpack.pack_bits_words, h)
        plain += time_ms(bitpack.pack_ge_plain, h, 1, iters=5)
        nbytes += m * n * 4 + m * bitpack.num_words(n) * 4
        ops += m * n
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(
        source="src/repro_torch/csrc/bitpack.cu",
        replaces="src/repro/kernels/bitpack.py:35",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
    )


def check_packed_layer(dev, lp, layer_inputs) -> dict:
    """``packed_layer`` against its plain version on the main path's layers
    and on the scan plan's padded layer (pad neurons must never fire); timed
    per chunk (one launch per layer)."""

    def operands(weights, mask, thresholds, h):
        return (bitpack.pack_bits_words(h), executor._i32(weights).to(dev),
                executor._i32(mask).to(dev), executor._i32(thresholds).to(dev))

    err = 0
    ms = plain = nbytes = ops = 0.0
    for pl, h in zip(lp.packed.layers, layer_inputs):
        args = operands(pl.weights, pl.mask, pl.thresholds, h)
        err = max(err, same(f"packed_layer {pl.n_in}->{pl.n_out} ({CHUNK} packets)",
                            packed_layer.packed_layer(*args), packed_layer.packed_layer_plain(*args)))
        (b, w), n_out = args[0].shape, pl.n_out
        ms += time_ms(packed_layer.packed_layer, *args)
        plain += time_ms(packed_layer.packed_layer_plain, *args, iters=5)
        nbytes += (b * w + 2 * n_out * w + n_out + b * n_out) * 4
        ops += b * n_out * (5 * w + 1)  # xor, not, and, popc, add per word; compare
    sp = lowering.stack_packed_layers(lp.packed)
    n_true = lp.packed.layers[1].n_out
    args = operands(sp.weights[1], sp.mask[1], sp.thresholds[1], layer_inputs[1])
    out = packed_layer.packed_layer(*args)
    err = max(err, same(f"packed_layer stacked layer 1 with {sp.max_out - n_true} pad neurons",
                        out, packed_layer.packed_layer_plain(*args)))
    if out[:, n_true:].any():
        raise AssertionError("a pad neuron (threshold 0xFFFFFFFF) fired")
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(
        source="src/repro_torch/csrc/packed_layer.cu",
        replaces="src/repro/dataplane/executor.py:213",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
    )


def drive_main_path(dev, lp, records: dict) -> dict:
    """Stream the packets through each backend with every launch count
    zeroed just before and read just after; returns the stream results."""
    counters = {
        "optable_run": optable_exec.optable_run,
        "pack_bits_words": bitpack.pack_bits_words,
        "packed_layer": packed_layer.packed_layer,
    }
    path_kernels = {"jnp": ("optable_run",), "packed": ("pack_bits_words", "packed_layer")}
    results = {}
    for backend, label in (("jnp", "op-table"), ("packed", "packed")):
        for fn in counters.values():
            fn.launches = 0
        sr = executor.execute_stream(
            lp,
            traffic.stream(SCENARIO, PACKETS, HEADLINE.input_bits, chunk_size=CHUNK, seed=SEED),
            backend=backend, chunk_size=CHUNK, collect=True, device=dev,
        )
        launches = {name: fn.launches for name, fn in counters.items()}
        for name in path_kernels[backend]:
            if launches[name] <= 0:
                raise AssertionError(f"the {label} backend never launched {name}")
            records[name]["launches"] = launches[name]
        results[backend] = sr
        print(
            f"main path, {label} backend: {sr.packets} packets in {sr.chunks} chunks, "
            f"{sr.seconds:.4f} s -> {sr.packets_per_second:.6e} pkt/s "
            f"(warm-up {sr.warmup_seconds:.2f} s), launches {launches}"
        )
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line())
    build_kernels()

    params = bnn.init_params(HEADLINE, torch.Generator().manual_seed(SEED))
    prog = compiler.compile_bnn([w.numpy() for w in params], RMT)
    lp = prog.lower()
    five = bnn.init_params(FIVE_TUPLE, torch.Generator().manual_seed(SEED + 1))
    print(lp.summary())
    first = traffic.generate(SCENARIO, CHUNK, HEADLINE.input_bits, seed=SEED)
    pkt = torch.from_numpy(first).to(dev)
    # The packed backend packs each layer's input: (CHUNK, 32), then (CHUNK, 64).
    layer_inputs = (pkt, bnn.layer_forward(pkt, params[0].to(dev)))

    print("kernel vs plain PyTorch, on the card:")
    programs = {
        "HEADLINE/rmt": (lp, pkt),
        "HEADLINE/rmt+popcnt32": (
            compiler.compile_bnn([w.numpy() for w in params], RMT_NATIVE_POPCNT).lower(), pkt),
        "FIVE_TUPLE/rmt": (
            compiler.compile_bnn([w.numpy() for w in five], RMT).lower(),
            torch.from_numpy(traffic.generate(SCENARIO, CHUNK, FIVE_TUPLE.input_bits, seed=SEED)).to(dev)),
    }
    records = {
        "optable_run": check_optable(dev, programs, lp, pkt),
        "pack_bits_words": check_bitpack(dev, layer_inputs),
        "packed_layer": check_packed_layer(dev, lp, layer_inputs),
    }
    unrolled = executor.execute(lp, first, backend="packed", device=dev)
    if not np.array_equal(executor.execute(lp, first, backend="packed", scan_hops=True, device=dev), unrolled):
        raise AssertionError("packed scan-over-layers plan disagrees with the unrolled plan")

    results = drive_main_path(dev, lp, records)
    opt, packed = results["jnp"].outputs, results["packed"].outputs
    if opt.shape != (PACKETS, HEADLINE.output_bits) or opt.max() > 1:
        raise AssertionError(f"unexpected output {opt.shape}, max {opt.max()}")
    if not np.array_equal(opt, packed):
        bad = int((opt != packed).any(axis=1).sum())
        raise AssertionError(f"op-table and packed backends disagree on {bad} packets")
    witness = interpreter.run_program(prog, first, device=dev).cpu().numpy()
    oracle = bnn.forward([p.to(dev) for p in params], pkt).cpu().numpy()
    if not (np.array_equal(opt[:CHUNK], witness) and np.array_equal(witness, oracle)):
        raise AssertionError("first chunk disagrees with run_program or the BNN oracle")
    print(f"both backends agree on all {PACKETS} packets; first chunk == run_program == bnn.forward")

    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=None)
        for name, r in records.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
