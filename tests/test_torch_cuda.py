"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and skips
where ``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the reference package, so it also runs on a GPU machine without them::

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Bit-exact
throughout.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bitops, compiler, pipeline
from repro_torch.dataplane import executor, traffic
from repro_torch.kernels import bitpack, optable_exec, packed_layer

TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lowered(sizes, native_popcnt=False, seed=0):
    rng = np.random.default_rng(seed)
    params = [
        rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32)
        for i in range(len(sizes) - 1)
    ]
    chip = pipeline.RMT_NATIVE_POPCNT if native_popcnt else pipeline.RMT
    return compiler.compile_bnn(params, chip).lower()


@pytest.mark.parametrize(
    "sizes,native", [((32, 64, 32), False), ((32, 64, 32), True), ((128, 64, 32, 2), False)]
)
@pytest.mark.parametrize("batch", [1, 1000])
def test_optable_kernel_matches_plain(cuda, sizes, native, batch):
    lp = _lowered(sizes, native, seed=5)
    rng = np.random.default_rng(6)
    regs = rng.integers(0, 1 << 32, (lp.num_regs, batch), dtype=np.uint64)
    regs[-1] = 0  # the null register
    regs = bitops.u32_to_i32(torch.from_numpy(regs.astype(np.int64))).to(cuda)
    tables = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES)
    before = optable_exec.optable_run.launches
    out = optable_exec.optable_run(regs, *tables)
    torch.cuda.synchronize()
    assert optable_exec.optable_run.launches == before + 1
    assert torch.equal(out, optable_exec.optable_run_plain(regs, *tables))


def test_optable_kernel_rejects_malformed_tables(cuda):
    lp = _lowered((5, 3))
    tables = [executor._i32(getattr(lp, n)).to(cuda) for n in TABLES]
    tables[0][0, 0] = 6
    with pytest.raises(ValueError):
        optable_exec.optable_run(torch.zeros((lp.num_regs, 4), dtype=torch.int32, device=cuda), *tables)


def _hand_tables(cuda):
    """Two elements over r0..r4 and the null register r5, padded as
    ``lowering`` pads: a FOLD (rows 0-1) whose first writer is deferred,
    since row 2 reads r1 after it; r2 rewritten in place twice (rows 3-4,
    both deferred, the later first write wins); r4 written at once."""
    full = 0xFFFFFFFF
    rows = [
        [(0, 1, 0, 5, 0, 0, full, 1), (4, 1, 2, 5, 1, 0, full, 0), (0, 3, 1, 5, 5, 0, full, 1),
         (0, 2, 2, 5, 0xF, 0, full, 1), (2, 2, 2, 4, 0, 0, full, 1), (1, 4, 0, 5, 4, 0xFF, full, 1)],
        [(2, 0, 1, 2, 0, 0, 0xFFFF, 1)],
    ]
    pad = (1, 5, 5, 5, 0, 0, 0, 1)
    arr = np.array([el + [pad] * (7 - len(el)) for el in rows], np.int64)
    return tuple(torch.from_numpy(arr[:, :, i].astype(np.uint32).view(np.int32)).to(cuda)
                 for i in range(len(TABLES)))


def _any_regs(num_regs, batch, cuda, seed):
    """Arbitrary registers, the null (last) one nonzero."""
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 1 << 32, (num_regs, batch), dtype=np.uint64).astype(np.uint32)
    regs[-1] = 0xDEADBEEF
    return torch.from_numpy(regs.view(np.int32)).to(cuda)


@pytest.mark.parametrize("program", ["hand", "headline", "headline_popcnt", "five_tuple"])
@pytest.mark.parametrize("batch", [1, 257, 40000])
def test_optable_kernel_hazards_pads_and_nonzero_null(cuda, program, batch):
    if program == "hand":
        tables, num_regs = _hand_tables(cuda), 6
    else:
        sizes = (128, 64, 32, 2) if program == "five_tuple" else (32, 64, 32)
        lp = _lowered(sizes, program == "headline_popcnt", seed=9)
        tables, num_regs = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES), lp.num_regs
    regs = _any_regs(num_regs, batch, cuda, seed=batch)
    out = optable_exec.optable_run(regs, *tables)
    want = optable_exec.optable_run_plain(regs, *tables)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not out[-1].any()  # every element here ends in pads into the null register


def test_optable_second_launch_makes_no_host_sync(cuda):
    lp = _lowered((32, 64, 32), seed=11)
    tables = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES)
    regs = _any_regs(lp.num_regs, 1000, cuda, seed=3)
    executor._TABLE_CACHE.clear()
    t = executor._device_tables(lp, cuda)  # planned from the host's copy
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with pytest.raises(RuntimeError):  # the first launch reads its tables back once
            optable_exec.optable_run(regs, *tables)
        torch.cuda.set_sync_debug_mode(0)
        optable_exec.optable_run(regs, *tables)
        torch.cuda.set_sync_debug_mode("error")
        out = optable_exec.optable_run(regs, *tables)
        out_exec = optable_exec.optable_run(regs, *t.ops, t.first_write)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = optable_exec.optable_run_plain(regs, *tables)
    assert torch.equal(out, want) and torch.equal(out_exec, want)


def test_optable_kernel_rejects_a_table_edited_after_a_launch(cuda):
    lp = _lowered((5, 3))
    tables = [executor._i32(getattr(lp, n)).to(cuda) for n in TABLES]
    regs = torch.zeros((lp.num_regs, 4), dtype=torch.int32, device=cuda)
    optable_exec.optable_run(regs, *tables)
    tables[2][0, 0] = lp.num_regs  # src0 outside the register file
    with pytest.raises(ValueError):
        optable_exec.optable_run(regs, *tables)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100])
def test_bitpack_kernels_match_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    bits = torch.randint(0, 2, (777, n), generator=gen, dtype=torch.int32).to(cuda)
    assert torch.equal(bitpack.pack_bits_words(bits), bitpack.pack_ge_plain(bits, 1))
    x = torch.randn((300, 32 * (1 + n // 32)), generator=gen).to(cuda)
    assert torch.equal(bitpack.bitpack(x), bitpack.pack_ge_plain(x, 0))
    xi = torch.randint(-5, 5, (300, 64), generator=gen, dtype=torch.int32).to(cuda)
    assert torch.equal(bitpack.bitpack(xi), bitpack.pack_ge_plain(xi, 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_layer_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    words, weights, mask = u32(5000, 3), u32(9, 3), u32(9, 3)
    thr = rng.integers(0, 98, 9).astype(np.uint32)
    weights[-2:], mask[-2:], thr[-2:] = 0, 0, 0xFFFFFFFF  # pad neurons
    args = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in (words, weights, mask, thr)]
    out = packed_layer.packed_layer(*args)
    assert torch.equal(out, packed_layer.packed_layer_plain(*args))
    assert not out[:, -2:].any()


def _shifted(t, nbytes):
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a 16-byte
    boundary."""
    itemsize = t.element_size()
    buf = torch.zeros(t.numel() + 32 // itemsize, dtype=t.dtype, device=t.device)
    skip = ((16 - buf.data_ptr() % 16) % 16 + nbytes) // itemsize
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


# Subnormals of both signs, the boundary -FLT_MIN (a normal number), ±0.0,
# NaN and ±inf, with the sign bit the reference gives each: it computes its
# signs with subnormals flushed to zero (kernels/ref.py, core/bitops.py::
# sign_bit), so a negative subnormal packs as 1.
FLT_MIN = 2.0 ** -126
PLANTED = [-1e-40, 1e-40, -1e-45, -FLT_MIN / 2, -FLT_MIN, -0.0, 0.0, float("nan"),
           float("-inf"), float("inf")]
PLANTED_BITS = [1, 1, 1, 1, 0, 1, 1, 0, 0, 1]


def _planted(shape, dtype, gen):
    """Random data with PLANTED in row 0 from column 3 and -1e-39 (a
    negative subnormal) in every third column of the last row."""
    x = torch.randn(shape, generator=gen)
    width = min(len(PLANTED), shape[1] - 3)
    x[0, 3:3 + width] = torch.tensor(PLANTED[:width])
    x[-1, ::3] = -1e-39
    return x.to(dtype)


WIDTHS = [1, 4, 8, 31, 32, 33, 64, 100, 2048]


# pack_bits_words: widths that are whole 16-byte vectors take vec (flat at
# multiples of 32, row by row otherwise), the rest and misaligned views take
# scalar; the row counts leave partial warp iterations.
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("m", [1, 3, 777])
def test_pack_bits_words_routes_match_plain(cuda, n, m):
    gen = torch.Generator().manual_seed(n * 10 + m)
    bits = torch.randint(0, 2, (m, n), generator=gen, dtype=torch.int32)
    bits[0] = 1
    want = bitpack.pack_ge_plain(bits, 1)
    fn = bitpack.pack_bits_words
    path = "vec" if n % 4 == 0 else "scalar"
    assert torch.equal(_launched(fn, path, lambda: fn(bits.to(cuda))).cpu(), want)
    for nbytes in (4, 8):
        view = _shifted(bits.to(cuda), nbytes)
        assert torch.equal(_launched(fn, "scalar", lambda: fn(view)).cpu(), want)


# bitpack in float32, bf16 and int32 on both routes, with the planted signs.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("k", [32, 64, 2048])
@pytest.mark.parametrize("m", [1, 4, 777])
def test_bitpack_routes_match_plain(cuda, dtype, k, m):
    gen = torch.Generator().manual_seed(k + m)
    if dtype == torch.int32:
        x = torch.randint(-5, 5, (m, k), generator=gen, dtype=torch.int32)
    else:
        x = _planted((m, k), dtype, gen)
    want = bitpack.pack_ge_plain(x, 0)
    fn = bitpack.bitpack
    before = dict(fn.launches_by_dtype)
    assert torch.equal(_launched(fn, "vec", lambda: fn(x.to(cuda))).cpu(), want)
    for nbytes in (4, 8):
        view = _shifted(x.to(cuda), nbytes)
        assert torch.equal(_launched(fn, "scalar", lambda: fn(view)).cpu(), want)
    name = str(dtype).removeprefix("torch.")
    assert fn.launches_by_dtype[name] == before[name] + 3
    if dtype != torch.int32:
        bits = bitops.unpack_bits(bitops.i32_to_u32(want[:1]))
        assert bits[0, 3:13].tolist() == PLANTED_BITS


# The tensor-core GEMM's three sign sites: the staged route's float32 and
# bf16 staging, and the tma route's bf16x2 compare.
@pytest.mark.parametrize("dtype,k,path", [
    (torch.float32, 64, "staged"), (torch.bfloat16, 100, "staged"), (torch.bfloat16, 64, "tma"),
])
def test_bnn_matmul_mxu_signs_of_subnormals(cuda, dtype, k, path):
    gen = torch.Generator().manual_seed(k)
    x = _planted((130, k), dtype, gen)
    w = ref.sign(torch.randn((k, 72), generator=gen), torch.bfloat16)
    mxu = bnn_matmul_mxu.bnn_matmul_mxu
    got = _launched(mxu, path, lambda: mxu(x.to(cuda), w.to(cuda)))
    assert torch.equal(got.cpu(), bnn_matmul_mxu.bnn_matmul_mxu_plain(x, w))
    # Negative subnormals and -0.0 sign to +1, -FLT_MIN to -1.
    xs = torch.full((2, k), -1e-39)
    xs[0, ::2], xs[1] = -0.0, -FLT_MIN
    ones = torch.ones((k, 8), dtype=torch.bfloat16, device=cuda)
    got = _launched(mxu, path, lambda: mxu(xs.to(cuda, dtype), ones))
    assert got.cpu().tolist() == [[float(k)] * 8, [-float(k)] * 8]


def _layer_operands(rng, batch, n_out, n_words, pad):
    """Random packed operands with ``pad`` never-firing pad neurons."""
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    words, weights, mask = u32(batch, n_words), u32(n_out, n_words), u32(n_out, n_words)
    thr = rng.integers(0, 32 * n_words + 2, n_out).astype(np.uint32)
    if pad:
        weights[-pad:], mask[-pad:], thr[-pad:] = 0, 0, 0xFFFFFFFF
    words[0], weights[0], mask[0] = 0xFFFFFFFF, 0, 0xFFFFFFFF
    return [torch.from_numpy(a.view(np.int32)) for a in (words, weights, mask, thr)]


# quad for n_out % 4 == 0 and 1, 2 or 4 words, general otherwise; the batch
# leaves partial block steps.
@pytest.mark.parametrize("n_out", [2, 4, 32, 64])
@pytest.mark.parametrize("n_words", [1, 2, 4, 5])
@pytest.mark.parametrize("batch", [1, 1000, 40000])
def test_packed_layer_routes_match_plain(cuda, n_out, n_words, batch):
    rng = np.random.default_rng(n_out * 100 + n_words * 10 + batch)
    pad = min(2, n_out - 1)
    args = _layer_operands(rng, batch, n_out, n_words, pad)
    want = packed_layer.packed_layer_plain(*args)
    fn = packed_layer.packed_layer
    path = "quad" if n_out % 4 == 0 and n_words in (1, 2, 4) else "general"
    dev = [a.to(cuda) for a in args]
    got = _launched(fn, path, lambda: fn(*dev))
    assert torch.equal(got.cpu(), want)
    assert not got[:, n_out - pad:].any()
    for nbytes in (4, 8):
        words = _shifted(dev[0], nbytes)
        shifted = "quad" if path == "quad" and nbytes % (4 * n_words) == 0 else "general"
        assert torch.equal(_launched(fn, shifted, lambda: fn(words, *dev[1:])).cpu(), want)


# Tables past one block's shared memory ((2 * n_out * n_words + n_out) * 4
# bytes over 232,448) take the tiled route; the cached route, forced, gives
# the same bits, and the general route, forced, refuses them.  916 x 32 words
# is the block-diagonal layer of 32 merged tenants, 3540 x 128 and 1510 x 150
# those of 128; 1030 x 29 has ragged K (4-byte staging) and 1030 % 64 a
# ragged last tile; 1001 packets a ragged last tile of packets.
@pytest.mark.parametrize("n_out,n_words", [(916, 32), (1030, 29), (600, 48), (3540, 128), (1510, 150)])
@pytest.mark.parametrize("batch", [1, 1001])
def test_packed_layer_tiled_route_past_shared_memory(cuda, n_out, n_words, batch):
    assert (2 * n_out * n_words + n_out) * 4 > 232448
    rng = np.random.default_rng(n_out + n_words + batch)
    args = _layer_operands(rng, batch, n_out, n_words, 3)
    fn = packed_layer.packed_layer
    dev = [a.to(cuda) for a in args]
    want = packed_layer.packed_layer_plain(*args)
    got = _launched(fn, "tiled", lambda: fn(*dev))
    assert torch.equal(got.cpu(), want)
    assert not got[:, n_out - 3:].any()
    cached = _launched(fn, "cached", lambda: packed_layer._launch(*dev, torch.empty_like(got), "cached"))
    assert torch.equal(cached.cpu(), want)
    with pytest.raises(RuntimeError, match="CUDA error"):
        packed_layer._launch(*dev, torch.empty_like(got), "general")


# The tiled route forced on other layers: a ragged n_out (one int at a time
# at the edge), one neuron, misaligned words, weights or masks (4-byte
# staging) and an output whose rows are not whole int4s; batch 0 launches
# nothing; a layer of no words is refused.
@pytest.mark.parametrize("n_out,n_words", [(2, 1), (13, 5), (65, 4), (916, 32), (1, 128)])
@pytest.mark.parametrize("batch", [0, 1, 1001])
def test_packed_layer_tiled_route_edges(cuda, n_out, n_words, batch):
    rng = np.random.default_rng(n_out * 3 + n_words + batch)
    args = _layer_operands(rng, max(batch, 1), n_out, n_words, min(2, n_out - 1))
    args[0] = args[0][:batch]
    dev = [a.to(cuda) for a in args]
    want = packed_layer.packed_layer_plain(*args)
    fn = packed_layer.packed_layer
    if batch == 0:
        before = dict(fn.launches_by_route)
        assert fn(*dev).shape == (0, n_out) and fn.launches_by_route == before
        return
    tiled = lambda ops: packed_layer._launch(*ops, torch.empty((batch, n_out), dtype=torch.int32,  # noqa: E731
                                                               device=cuda), "tiled")
    assert torch.equal(_launched(fn, "tiled", lambda: tiled(dev)).cpu(), want)
    for which in range(3):
        ops = list(dev)
        ops[which] = _shifted(dev[which], 4)
        assert torch.equal(_launched(fn, "tiled", lambda: tiled(ops)).cpu(), want)
    empty = [torch.zeros((batch, 0), dtype=torch.int32, device=cuda),
             *(torch.zeros((n_out, 0), dtype=torch.int32, device=cuda) for _ in range(2)), dev[3]]
    with pytest.raises(RuntimeError, match="CUDA error"):
        packed_layer._launch(*empty, torch.empty((batch, n_out), dtype=torch.int32, device=cuda), "tiled")


# The cached route on tables that fit shared memory too: the same bits as the
# general route's staged tables.
@pytest.mark.parametrize("n_out,n_words", [(2, 1), (13, 5), (64, 2)])
def test_packed_layer_cached_route_matches_general(cuda, n_out, n_words):
    rng = np.random.default_rng(n_out * 7 + n_words)
    args = _layer_operands(rng, 1001, n_out, n_words, min(2, n_out - 1))
    dev = [a.to(cuda) for a in args]
    want = packed_layer.packed_layer_plain(*args)
    for path in ("general", "cached"):
        got = _launched(packed_layer.packed_layer, path,
                        lambda: packed_layer._launch(*dev, torch.empty((1001, n_out), dtype=torch.int32,
                                                                      device=cuda), path))
        assert torch.equal(got.cpu(), want)


# FIVE_TUPLE's packed layers at their shapes (4, 2 and 1 words; the 2-neuron
# output layer takes general) and the scan plan's stacked layers, whose pad
# neurons must never fire.
def test_packed_layer_five_tuple_layers(cuda):
    from repro_torch.configs.n2net_paper import FIVE_TUPLE
    from repro_torch.dataplane import lowering

    lp = _lowered(FIVE_TUPLE.layer_sizes, seed=5)
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.integers(0, 2, (5000, FIVE_TUPLE.input_bits)).astype(np.int32)).to(cuda)
    fn = packed_layer.packed_layer
    for pl, path in zip(lp.packed.layers, ("quad", "quad", "general")):
        args = (bitpack.pack_bits_words(h), executor._i32(pl.weights).to(cuda),
                executor._i32(pl.mask).to(cuda), executor._i32(pl.thresholds).to(cuda))
        out = _launched(fn, path, lambda: fn(*args))
        assert torch.equal(out, packed_layer.packed_layer_plain(*args))
        h = out
    sp = lowering.stack_packed_layers(lp.packed)
    h = torch.from_numpy(rng.integers(0, 2, (5000, sp.max_bits)).astype(np.int32)).to(cuda)
    for li, pl in enumerate(lp.packed.layers):
        args = (bitpack.pack_bits_words(h)[:, :sp.max_words].contiguous(),
                executor._i32(sp.weights[li]).to(cuda), executor._i32(sp.mask[li]).to(cuda),
                executor._i32(sp.thresholds[li]).to(cuda))
        out = _launched(fn, "quad", lambda: fn(*args))
        assert torch.equal(out, packed_layer.packed_layer_plain(*args))
        assert not out[:, pl.n_out:].any()
        h = torch.nn.functional.pad(out, (0, sp.max_bits - out.shape[1]))


@pytest.mark.parametrize("scan_hops", [False, True])
def test_execute_five_tuple_packed_on_cuda_matches_cpu(cuda, scan_hops):
    from repro_torch.configs.n2net_paper import FIVE_TUPLE

    lp = _lowered(FIVE_TUPLE.layer_sizes, seed=6)
    packets = traffic.generate("ddos_burst", 5000, FIVE_TUPLE.input_bits, seed=3)
    cpu = executor.execute(lp, packets, backend="packed", scan_hops=scan_hops, device="cpu")
    gpu = executor.execute(lp, packets, backend="packed", scan_hops=scan_hops, chunk_size=2048)
    np.testing.assert_array_equal(gpu, cpu)


@pytest.mark.parametrize("backend,scan_hops", [("jnp", False), ("packed", False), ("packed", True)])
def test_execute_on_cuda_matches_cpu(cuda, backend, scan_hops):
    lp = _lowered((32, 64, 32), seed=7)
    packets = traffic.generate("ddos_burst", 5000, 32, seed=2)
    cpu = executor.execute(lp, packets, backend=backend, scan_hops=scan_hops, device="cpu")
    gpu = executor.execute(lp, packets, backend=backend, scan_hops=scan_hops, chunk_size=2048)
    np.testing.assert_array_equal(gpu, cpu)



def _ragged_streams(count, seed=0):
    """Distinct streams (seeded by index) of unequal lengths, one empty."""
    lengths = [(37 * i) % 301 for i in range(count)]
    return [traffic.generate("ddos_burst", n, 32, seed=seed + i) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("backend,scan_hops", [("jnp", False), ("packed", False), ("packed", True)])
def test_execute_fleet_on_cuda_matches_cpu(cuda, backend, scan_hops):
    """Ragged distinct streams, some exhausted blocks before the others:
    every stream, its count and the bit counts as on the CPU."""
    from repro_torch.dataplane.fleet import execute_fleet
    from repro_torch.dataplane.plan import ExecutionPlan

    lp = _lowered((32, 64, 32), seed=7)
    streams = _ragged_streams(70)
    plan = ExecutionPlan(backend=backend, scan_hops=scan_hops, chunk_size=16, collect=True)
    gpu = execute_fleet(lp, streams, plan=plan)
    cpu = execute_fleet(lp, streams, plan=plan, device="cpu")
    assert (gpu.packets, gpu.chunks) == (cpu.packets, cpu.chunks)
    np.testing.assert_array_equal(gpu.per_stream_packets, cpu.per_stream_packets)
    np.testing.assert_array_equal(gpu.bit_counts, cpu.bit_counts)
    for a, b in zip(gpu.outputs, cpu.outputs):
        np.testing.assert_array_equal(a, b)
    assert gpu.warmup_seconds > 0 and gpu.seconds > 0


def test_fleet_engine_on_cuda_matches_execute_fleet(cuda):
    import threading

    from repro_torch.dataplane.fleet import execute_fleet
    from repro_torch.dataplane.plan import ExecutionPlan
    from repro_torch.serving.engine import FleetEngine

    lp = _lowered((32, 64, 32), seed=7)
    streams = _ragged_streams(70, seed=3)
    plan = ExecutionPlan(backend="packed", chunk_size=16, collect=True)
    want = execute_fleet(lp, streams, plan=plan)
    got = FleetEngine(lp, plan=plan).serve(streams, collect=True)
    assert (got.packets, got.chunks) == (want.packets, want.chunks)
    np.testing.assert_array_equal(got.per_stream_packets, want.per_stream_packets)
    for a, b in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(a, b)
    assert not [t for t in threading.enumerate() if t.name == "fleet-ingest"]


def test_fleet_engine_dispatch_failure_reraises_and_joins_its_producer(cuda):
    """A dispatch that raises mid-serve is re-raised, and the ingest thread,
    blocked on the full queue, is stopped and joined."""
    import threading

    from repro_torch.dataplane.plan import ExecutionPlan
    from repro_torch.serving.engine import FleetEngine

    lp = _lowered((32, 64, 32), seed=7)
    eng = FleetEngine(lp, plan=ExecutionPlan(backend="packed", chunk_size=1), queue_depth=1)
    run, calls = eng.fn, []

    def failing(blocks):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("dispatch failed")
        return run(blocks)

    eng.fn = failing
    with pytest.raises(RuntimeError, match="dispatch failed"):
        eng.serve(_ragged_streams(4, seed=5)[1:])
    assert len(calls) == 4
    assert not [t for t in threading.enumerate() if t.name == "fleet-ingest"]


# ---------------------------------------------------------------------------
# The LM slice: packed and tensor-core binary GEMMs, flash attention, and the
# model they run in.  The GEMMs are exact; flash is held to 2e-3 in float32
# and 3e-2 in bf16 (the tolerances of the reference's flash tests).
# ---------------------------------------------------------------------------

from repro_torch.configs.base import QuantConfig, get_config  # noqa: E402
from repro_torch.kernels import bnn_matmul, bnn_matmul_mxu, flash_attention, ops, ref  # noqa: E402


def _words(rng, *shape):
    return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("m,n,k", [(1, 64, 32), (4, 3072, 3072), (5, 70, 100), (17, 200, 513), (130, 129, 8192)])
def test_bnn_matmul_packed_kernel_matches_plain(cuda, m, n, k):
    rng = np.random.default_rng(m + n + k)
    kw = -(-k // 32)
    x, w = _words(rng, m, kw), _words(rng, n, kw)
    if k % 32:  # the pad bits are zero in both operands
        keep = (1 << (k % 32)) - 1
        x[:, -1] &= keep
        w[:, -1] &= keep
    x[0], w[0] = -1, 0  # all-ones and all-zero words
    before = bnn_matmul.bnn_matmul_packed.launches
    out = bnn_matmul.bnn_matmul_packed(x.to(cuda), w.to(cuda), k_bits=k)
    torch.cuda.synchronize()
    assert bnn_matmul.bnn_matmul_packed.launches == before + 1
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_ref(x, w, k))


def _packed_operands(rng, m, n, kw, k_bits):
    """Random packed operands whose bits past ``k_bits`` are zero in both."""
    x, w = _words(rng, m, kw), _words(rng, n, kw)
    x[0], w[0] = -1, 0  # all-ones and all-zero words
    keep = [(1 << min(32, max(0, k_bits - 32 * i))) - 1 for i in range(kw)]
    keep = torch.from_numpy(np.array(keep, np.uint64).astype(np.uint32).view(np.int32))
    return x & keep, w & keep


# M from 1 to the decode route's threshold takes the stream kernel when Kw
# is a multiple of 4; one row more, or a ragged Kw, takes the mma one.
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 12, bnn_matmul.STREAM_MAX_M, bnn_matmul.STREAM_MAX_M + 1])
@pytest.mark.parametrize("kw,k_bits,n", [(96, 3072, 3072), (256, 8192, 3000), (99, 3163, 301),
                                          (96, 3000, 1027), (8, 1, 77)])
def test_bnn_matmul_packed_decode_route(cuda, m, kw, k_bits, n):
    rng = np.random.default_rng(m * 1000 + kw)
    x, w = _packed_operands(rng, m, n, kw, k_bits)
    path = "stream" if m <= bnn_matmul.STREAM_MAX_M and kw % 4 == 0 else "mma"
    fn = bnn_matmul.bnn_matmul_packed
    out = _launched(fn, path, lambda: fn(x.to(cuda), w.to(cuda), k_bits=k_bits))
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_ref(x, w, k_bits))


@pytest.mark.parametrize("which", ["x", "w", "both"])
@pytest.mark.parametrize("words", [1, 2, 3])
def test_bnn_matmul_packed_misaligned_views_take_tiled(cuda, which, words):
    rng = np.random.default_rng(words)
    x, w = _packed_operands(rng, 4, 500, 96, 3072)

    def shifted(t):  # a contiguous view ``words`` int32 past a 16-byte boundary
        buf = torch.zeros(t.numel() + 4, dtype=torch.int32, device=cuda)
        out = buf[words:words + t.numel()].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 == 4 * words
        return out

    xc = shifted(x) if which in ("x", "both") else x.to(cuda)
    wc = shifted(w) if which in ("w", "both") else w.to(cuda)
    fn = bnn_matmul.bnn_matmul_packed
    out = _launched(fn, "mma", lambda: fn(xc, wc, k_bits=3072))
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_ref(x, w, 3072))
    # A row slice of aligned weights stays aligned (Kw = 96 words) and streams.
    ws = w.to(cuda)[3:]
    out = _launched(fn, "stream", lambda: fn(x.to(cuda), ws, k_bits=3072))
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_ref(x, w[3:], 3072))


# The mma route at the shapes that stress it: Kw not a multiple of its
# 8-word stage (its zero-filled tail), M of 17 and 2047 (a second warpgroup
# and a last row tile mostly past M), ragged N (tiles of 32, 64 and 128
# columns past N, stores one int at a time where N is not a multiple of 4),
# a K of one word, and all-ones and all-zero words; each launch also on the
# first design, tiled, forced.
@pytest.mark.parametrize("m,n,kw,k_bits", [
    (17, 3072, 96, 3072), (2047, 3072, 96, 3072), (17, 3001, 99, 3163), (2047, 1027, 13, 400),
    (128, 8192, 96, 3072), (128, 3002, 256, 8192), (33, 129, 5, 150), (300, 77, 1, 1),
    (1000, 50, 9, 270), (129, 4099, 12, 384),
])
def test_bnn_matmul_packed_mma_route(cuda, m, n, kw, k_bits):
    rng = np.random.default_rng(m * 7 + n + kw)
    x, w = _packed_operands(rng, m, n, kw, k_bits)
    assert m > bnn_matmul.STREAM_MAX_M
    fn = bnn_matmul.bnn_matmul_packed
    want = ref.bnn_matmul_packed_ref(x, w, k_bits)
    out = _launched(fn, "mma", lambda: fn(x.to(cuda), w.to(cuda), k_bits=k_bits))
    assert torch.equal(out.cpu(), want)
    tiled = _launched(fn, "tiled", lambda: bnn_matmul._launch(
        x.to(cuda), w.to(cuda), torch.empty_like(out), k_bits, "tiled"))
    assert torch.equal(tiled.cpu(), want)


@pytest.mark.parametrize("block_n", bnn_matmul.MMA_BLOCK_NS)
def test_bnn_matmul_packed_mma_every_tile_width(cuda, block_n, monkeypatch):
    """Each tile width the wrapper can pick, forced, on one ragged shape."""
    rng = np.random.default_rng(block_n)
    x, w = _packed_operands(rng, 200, 301, 19, 600)
    monkeypatch.setattr(bnn_matmul, "mma_block_n", lambda *args: block_n)
    fn = bnn_matmul.bnn_matmul_packed
    out = _launched(fn, "mma", lambda: fn(x.to(cuda), w.to(cuda), k_bits=600))
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_ref(x, w, 600))


def _launched(fn, path, call):
    """``call()``, asserting it launched ``fn`` once, on route ``path``."""
    before = dict(fn.launches_by_route)
    out = call()
    torch.cuda.synchronize()
    assert {p: fn.launches_by_route[p] - before[p] for p in before} == {p: int(p == path) for p in before}
    return out


# bf16 with K and N multiples of 8 takes the tma kernel, the rest the staged
# one.
@pytest.mark.parametrize("m,n,k", [(64, 64, 32), (100, 70, 513), (3, 130, 64), (130, 264, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bnn_matmul_mxu_kernel_matches_plain(cuda, m, n, k, dtype):
    gen = torch.Generator().manual_seed(m * n + k)
    path = "tma" if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 else "staged"
    x = torch.randn((m, k), generator=gen).to(dtype)
    x[0, :4] = torch.tensor([0.0, -0.0, float("nan"), -1.0]).to(dtype)
    w = ref.sign(torch.randn((k, n), generator=gen), torch.bfloat16)
    mxu = bnn_matmul_mxu.bnn_matmul_mxu
    got = _launched(mxu, path, lambda: mxu(x.to(cuda), w.to(cuda)))
    assert torch.equal(got.cpu(), bnn_matmul_mxu.bnn_matmul_mxu_plain(x, w))
    xi = torch.randint(-8, 8, (m, k), generator=gen).to(dtype)  # exact without binarizing
    got = _launched(mxu, path, lambda: mxu(xi.to(cuda), w.to(cuda), binarize_x=False))
    assert torch.equal(got.cpu(), bnn_matmul_mxu.bnn_matmul_mxu_plain(xi, w, binarize_x=False))


# Every edge of the tma kernel's 128 x 256 x 64 tiles: M one row, one short
# of a tile and one past it; N and K at the smallest width, one box past a
# tile and a ragged box.
@pytest.mark.parametrize("m", [1, 127, 129, 2048])
@pytest.mark.parametrize("n", [8, 136, 264])
@pytest.mark.parametrize("k", [8, 72, 520])
def test_bnn_matmul_mxu_tma_route_edges(cuda, m, n, k):
    gen = torch.Generator().manual_seed(m + 7 * n + 31 * k)
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    x[0, :4] = torch.tensor([0.0, -0.0, float("nan"), -1.0]).to(torch.bfloat16)
    w = ref.sign(torch.randn((k, n), generator=gen), torch.bfloat16)
    mxu = bnn_matmul_mxu.bnn_matmul_mxu
    got = _launched(mxu, "tma", lambda: mxu(x.to(cuda), w.to(cuda)))
    assert torch.equal(got.cpu(), bnn_matmul_mxu.bnn_matmul_mxu_plain(x, w))
    xi = torch.randint(-8, 8, (m, k), generator=gen).to(torch.bfloat16)
    got = _launched(mxu, "tma", lambda: mxu(xi.to(cuda), w.to(cuda), binarize_x=False))
    assert torch.equal(got.cpu(), bnn_matmul_mxu.bnn_matmul_mxu_plain(xi, w, binarize_x=False))


def test_bnn_matmul_mxu_misaligned_operand_takes_staged_route(cuda):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((130, 64), generator=gen).to(cuda, torch.bfloat16)
    w = ref.sign(torch.randn((64, 72), generator=gen), torch.bfloat16).to(cuda)
    want = bnn_matmul_mxu.bnn_matmul_mxu_plain(x, w)
    mxu = bnn_matmul_mxu.bnn_matmul_mxu
    for xa, wa in ((_shifted(x, 2), w), (x, _shifted(w, 2))):
        assert torch.equal(_launched(mxu, "staged", lambda: mxu(xa, wa)), want)


@pytest.mark.parametrize("k", [100, 513])
def test_binary_matmul_implementations_agree_on_cuda(cuda, k):
    gen = torch.Generator().manual_seed(k)
    x, w = torch.randn((3, 37, k), generator=gen), torch.randn((45, k), generator=gen)
    want = ops.binary_matmul(x, w, implementation="ref")
    for impl in ("ref", "packed_ref", "pallas_packed", "pallas_mxu", "auto"):
        assert torch.equal(ops.binary_matmul(x.to(cuda), w.to(cuda), implementation=impl).cpu(), want)


@pytest.mark.parametrize("s,d", [(1, 16), (64, 96), (100, 128), (257, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_f32(cuda, s, d, causal):
    gen = torch.Generator().manual_seed(s * d)
    q, k, v = (torch.randn((3, s, d), generator=gen).to(cuda) for _ in range(3))
    fa = flash_attention.flash_attention
    before = fa.launches
    got = _launched(fa, "f32", lambda: fa(q, k, v, causal=causal))
    assert fa.launches == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# D a multiple of 8 takes the tma kernel (S at and around its 128-row tiles,
# D padded to 64, 96 or 128), D = 20 the wmma one.
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 300, 2048])
@pytest.mark.parametrize("d", [16, 20, 40, 64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain_bf16(cuda, s, d, causal):
    gen = torch.Generator().manual_seed(s + d)
    bh = 2 if s > 1000 else 4
    q, k, v = (torch.randn((bh, s, d), generator=gen).to(cuda, torch.bfloat16) for _ in range(3))
    fa = flash_attention.flash_attention
    got = _launched(fa, "wmma" if d % 8 else "tma", lambda: fa(q, k, v, causal=causal))
    assert got.dtype == torch.bfloat16
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("scale", [0.7, 0.0, -0.3])
@pytest.mark.parametrize("d", [64, 20])
def test_flash_attention_kernel_takes_any_scale_bf16(cuda, scale, d):
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn((2, 130, d), generator=gen).to(cuda, torch.bfloat16) for _ in range(3))
    fa = flash_attention.flash_attention
    got = _launched(fa, "wmma" if d % 8 else "tma", lambda: fa(q, k, v, scale=scale))
    want = flash_attention.flash_attention_plain(q, k, v, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_misaligned_operand_takes_wmma_route(cuda, which):
    gen = torch.Generator().manual_seed(which)
    qkv = [torch.randn((3, 100, 64), generator=gen).to(cuda, torch.bfloat16) for _ in range(3)]
    want = flash_attention.flash_attention_plain(*qkv)
    qkv[which] = _shifted(qkv[which], 2)
    fa = flash_attention.flash_attention
    got = _launched(fa, "wmma", lambda: fa(*qkv))
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


def _tiny_lm(**kw):
    return get_config(
        "phi3-mini-3.8b", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=97, attn_q_chunk=16, init_std=0.5,
        dtype="float32", **kw,
    )


def test_lm_forward_on_cuda_matches_cpu(cuda):
    from repro_torch import models

    for quant, impl in ((QuantConfig(mode="bnn_packed"), "xla"), (QuantConfig(), "pallas_flash")):
        cfg = _tiny_lm(quant=quant, attn_impl=impl)
        params = models.init_params(cfg, 0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 33)))
        want, _ = models.forward(params, {"tokens": tokens}, cfg)
        moved = _to(params, cuda)
        got, _ = models.forward(moved, {"tokens": tokens.to(cuda)}, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_engine_on_cuda_serves_the_cpu_tokens(cuda):
    from repro_torch import models
    from repro_torch.serving.engine import Engine, Request

    cfg = _tiny_lm(quant=QuantConfig(mode="bnn_packed"))
    params = models.init_params(cfg, 1, device="cpu")
    outs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_len=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=(np.arange(4 + 5 * i) * 7 + i) % 90, max_new_tokens=3 + 2 * i))
        outs.append([(r.rid, r.output) for r in eng.run()])
    assert outs[0] == outs[1]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """A kernel called through ctypes returns a tensor with no grad_fn, so
    under grad mode each wrapper refuses an input that requires grad instead
    of cutting the graph; without grad it launches.  The model's forward on
    the card therefore raises in grad mode and runs under inference_mode."""
    from repro_torch import models

    x = torch.randn((8, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="item 18"):
        bitpack.bitpack(x)
    q = torch.randn((2, 40, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="item 18"):
        flash_attention.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="item 18"):
        bnn_matmul_mxu.bnn_matmul_mxu(x, torch.ones((64, 8), dtype=torch.bfloat16, device=cuda))
    with torch.no_grad():
        assert torch.equal(bitpack.bitpack(x), bitpack.pack_ge_plain(x.detach(), 0))
    cfg = _tiny_lm(quant=QuantConfig(mode="bnn_packed"), attn_impl="pallas_flash")
    params = _to(models.init_params(cfg, 0, device="cpu"), cuda)
    params["embed"]["table"].requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 33))).to(cuda)
    with pytest.raises(RuntimeError, match="item 18"):
        models.forward(params, {"tokens": tokens}, cfg)
    with torch.inference_mode():
        logits, _ = models.forward(params, {"tokens": tokens}, cfg)
    assert torch.isfinite(logits).all()


def _five_tuple_fabric(mode="multi_hop"):
    from repro_torch.configs.n2net_paper import FIVE_TUPLE
    from repro_torch.core import bnn
    from repro_torch.dataplane.fabric import SwitchFabric

    params = bnn.init_params(FIVE_TUPLE, torch.Generator().manual_seed(1))
    prog = compiler.compile_bnn([w.numpy() for w in params], pipeline.RMT)
    return SwitchFabric.partition(prog, mode=mode)


def test_optable_on_stacked_hops_with_whole_pad_elements(cuda):
    """FIVE_TUPLE's hops of 32, 32, 32 and 26 elements stacked: the last
    hop's 6 whole pad elements have no true row.  Each hop's kernel launch
    on its plane equals the plain version, with a nonzero incoming null
    register."""
    fab = _five_tuple_fabric()
    stacked = fab.stacked_hops()
    assert [b - a for a, b in (h.element_range for h in fab.hops)] == [32, 32, 32, 26]
    rng = np.random.default_rng(8)
    regs = rng.integers(0, 1 << 32, (stacked.num_regs, 777), dtype=np.uint64)
    regs[-1] = 0xBEEF
    regs = bitops.u32_to_i32(torch.from_numpy(regs.astype(np.int64))).to(cuda)
    for tables in executor._stacked_tables(stacked, cuda):
        before = optable_exec.optable_run.launches
        out = optable_exec.optable_run(regs, *tables)
        assert optable_exec.optable_run.launches == before + 1
        assert torch.equal(out, optable_exec.optable_run_plain(regs, *tables))
        regs = out
    pads = executor._stacked_tables(stacked, cuda)[-1]
    plan, _ = optable_exec.prepare(pads, stacked.num_regs)
    assert (plan.rows[26:] == 0).all() and (plan.zero_reg[26:] == stacked.num_regs - 1).all()


@pytest.mark.parametrize("mode", ["multi_hop", "recirculate"])
def test_fabric_five_tuple_paths_agree_on_cuda(cuda, mode):
    fab = _five_tuple_fabric(mode)
    assert fab.num_hops == 4
    packets = traffic.generate("ddos_burst", 10_000, 128, seed=4)
    want = executor.execute(fab.lowered, packets, chunk_size=4096)
    before = optable_exec.optable_run.launches
    scanned = fab.run(packets, scan_hops=True, chunk_size=4096)
    assert optable_exec.optable_run.launches - before == fab.num_hops * (3 + 1)
    unrolled = fab.run(packets, scan_hops=False, chunk_size=4096)
    packed = fab.run(packets, backend="packed", chunk_size=4096)
    for res in (scanned, unrolled, packed):
        np.testing.assert_array_equal(res.outputs, want)
    assert scanned.scanned and not unrolled.scanned and packed.scanned
    np.testing.assert_array_equal(want[:300], fab.run(packets[:300], scan_hops=True, device="cpu").outputs)


def test_bnn_trainer_step_on_cuda_matches_cpu(cuda):
    """One trainer step on the card against the same step on the CPU, from
    the same seed (the initial latent is drawn on the CPU, so it is the
    same), with float32 products throughout (no TF32).

    Loss, accuracy and gradient norm agree within the CPU parity tests'
    rtol 1e-5, and the deployed bits exactly.  The moments agree within
    1e-5 of each tensor's largest magnitude: cuBLAS and the CPU sum a
    gradient element's 512 batch terms in other orders, each within
    float32 rounding of the exact sum.  The latent agrees within rtol 1e-5, atol 1e-6
    wherever the gradient is at least 100 times AdamW's eps; the first step
    moves a weight by lr * g / (|g| + eps), so where |g| is within a
    hundred eps (1e-8) that rounding of g moves the step by up to a
    percent, and those weights are held to 1e-2 * lr."""
    from repro_torch.train.bnn_trainer import BnnTrainConfig, BnnTrainer

    cfg = BnnTrainConfig(layer_sizes=(32, 128, 64, 1), steps=1, batch=512,
                         train_packets_per_class=2048, eval_packets_per_class=500)
    cpu = BnnTrainer(cfg, device="cpu")
    gpu = BnnTrainer(cfg, device=cuda)
    for a, b in zip(gpu.latent, cpu.latent):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    torch.backends.cuda.matmul.allow_tf32 = True  # the trainer turns it off for its steps
    try:
        cpu.train()
        gpu.train()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(gpu.history[-1][key], cpu.history[-1][key], rtol=1e-5, atol=1e-6)
    for a, b in zip(gpu.opt_state.m + gpu.opt_state.v, cpu.opt_state.m + cpu.opt_state.v):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    opt = cpu.optimizer
    for a, b, m in zip(gpu.latent, cpu.latent, cpu.opt_state.m):
        firm = m.abs() / (1 - opt.b1) >= 100 * opt.eps  # |g| (times the clip scale)
        assert firm.float().mean() > 0.9
        torch.testing.assert_close(a.cpu()[firm], b[firm], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a.cpu()[~firm], b[~firm], rtol=0, atol=1e-2 * opt.lr)
    np.testing.assert_array_equal(gpu.forward_bits(cpu.eval_x), cpu.forward_bits(cpu.eval_x))


# ---------------------------------------------------------------------------
# The multi-tenant slice: the per-tenant packed layer, routed dispatch and
# the SwitchScheduler on the card against the CPU.
# ---------------------------------------------------------------------------

def _routed_operands(rng, batch, tenants, n_out, n_words):
    """Random per-tenant operands: every tenant's last neuron a never-firing
    pad, high-bit words and weights, random ids."""
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    words, weights, mask = u32(batch, n_words), u32(tenants, n_out, n_words), u32(tenants, n_out, n_words)
    thr = rng.integers(0, 32 * n_words + 2, (tenants, n_out)).astype(np.uint32)
    weights[:, -1], mask[:, -1], thr[:, -1] = 0, 0, 0xFFFFFFFF
    if batch:
        words[0] = 0xFFFFFFFF
    ids = rng.integers(0, tenants, batch).astype(np.int32)
    return [torch.from_numpy(a.view(np.int32)) for a in (words, ids, weights, mask, thr)]


@pytest.mark.parametrize("tenants", [1, 3, 128])
@pytest.mark.parametrize("n_out", [5, 13, 66])
@pytest.mark.parametrize("n_words", [1, 2, 3, 8])
@pytest.mark.parametrize("batch", [0, 1, 1001])
def test_packed_layer_routed_matches_plain(cuda, tenants, n_out, n_words, batch):
    rng = np.random.default_rng(tenants * 1000 + n_out * 10 + n_words + batch)
    args = _routed_operands(rng, batch, tenants, n_out, n_words)
    want = packed_layer.packed_layer_routed_plain(*args)
    fn = packed_layer.packed_layer_routed
    dev = [a.to(cuda) for a in args]
    assert packed_layer.routed_route(dev[0], *dev[2:]) == "general"
    before = (fn.launches, fn.launches_by_route["general"])
    got = fn(*dev)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_by_route["general"]) == tuple(n + int(batch > 0) for n in before)
    assert torch.equal(got.cpu(), want)
    assert not got[:, -1].any()
    # Misaligned views of the words and the ids.
    for nbytes in (4, 8) if batch else ():
        assert torch.equal(fn(_shifted(dev[0], nbytes), _shifted(dev[1], nbytes), *dev[2:]).cpu(), want)


@pytest.mark.parametrize("tenants", [1, 3, 128])
@pytest.mark.parametrize("n_out", [4, 64, 1024])
@pytest.mark.parametrize("n_words", [1, 2, 4])
@pytest.mark.parametrize("batch", [0, 1, 1001])
def test_packed_layer_routed_quad_route_matches_plain(cuda, tenants, n_out, n_words, batch):
    """The quad route (4 neurons a thread) against the plain version, with
    each tenant's last neuron a never-firing pad and high-bit words; the
    general route, forced, on the same operands."""
    rng = np.random.default_rng(tenants * 1000 + n_out * 10 + n_words + batch + 7)
    args = _routed_operands(rng, batch, tenants, n_out, n_words)
    want = packed_layer.packed_layer_routed_plain(*args)
    fn = packed_layer.packed_layer_routed
    dev = [a.to(cuda) for a in args]
    assert packed_layer.routed_route(dev[0], *dev[2:]) == "quad"
    before = dict(fn.launches_by_route)
    got = fn(*dev)
    torch.cuda.synchronize()
    assert {p: fn.launches_by_route[p] - before[p] for p in before} == {"quad": int(batch > 0), "general": 0}
    assert torch.equal(got.cpu(), want)
    assert not got[:, -1].any()
    if batch:
        general = packed_layer._launch_routed(*dev, torch.empty_like(got), "general")
        assert torch.equal(general.cpu(), want)


def test_packed_layer_routed_refuses_out_of_range_ids_and_grad(cuda):
    args = [a.to(cuda) for a in _routed_operands(np.random.default_rng(0), 64, 3, 8, 2)]
    fn = packed_layer.packed_layer_routed
    for bad in (3, -1, 1 << 30):
        ids = args[1].clone()
        ids[17] = bad
        before = (fn.launches, dict(fn.launches_by_route))
        with pytest.raises(ValueError, match=r"outside \[0, 3\)"):
            fn(args[0], ids, *args[2:])
        assert (fn.launches, fn.launches_by_route) == before
    # int32 operands cannot require grad, so under grad mode the kernel
    # launches and its output needs none; a float operand is refused.
    with torch.enable_grad():
        out = fn(*args)
    assert not out.requires_grad and torch.equal(out.cpu(), packed_layer.packed_layer_routed_plain(
        *[a.cpu() for a in args]))
    with pytest.raises(ValueError, match="int32"):
        fn(args[0].float().requires_grad_(True), *args[1:])


SHAPES3 = [(16, 8, 4), (32, 16), (8, 12, 6)]
SPECS3 = [("ddos_burst", 16, 3.0), ("flow_tuple", 32, 1.0), ("iot_telemetry", 8, 2.0)]


def _scheduler3(**kw):
    from repro_torch.dataplane.multitenant import SwitchScheduler

    rng = np.random.default_rng(0)
    sched = SwitchScheduler(pipeline.ChipSpec(num_elements=256, name="bigchip"), **kw)
    for i, (shape, spec) in enumerate(zip(SHAPES3, SPECS3)):
        params = [rng.integers(0, 2, (shape[j + 1], shape[j])).astype(np.int32) for j in range(len(shape) - 1)]
        sched.admit(compiler.compile_bnn(params), name=f"t{i}", weight=spec[2])
    return sched


@pytest.mark.parametrize("backend", ["jnp", "packed"])
@pytest.mark.parametrize("mode,layout", [("merged", "interleave"), ("merged", "concat"), ("time_sliced", None)])
def test_scheduler_on_cuda_matches_cpu(cuda, mode, layout, backend):
    """Routed op-table and packed dispatch (and time-sliced turns) on the
    card give the CPU's per-tenant outputs and statistics."""
    specs = [traffic.TenantTrafficSpec(*s) for s in SPECS3]
    sched = _scheduler3(quantum=256, max_queue=400)
    pair = traffic.mixed_tenant_generate(specs, 3000, seed=4)
    kw = dict(mode=mode, merged=layout, backend=backend, chunk_size=1000)
    gpu = sched.run(pair, device=cuda, **kw)
    cpu = sched.run(pair, device="cpu", **kw)
    for t in range(3):
        a, b = gpu.stats_for(t), cpu.stats_for(t)
        assert (a.packets, a.served, a.dropped, a.deferred, a.slices) == (
            b.packets, b.served, b.dropped, b.deferred, b.slices)
        np.testing.assert_array_equal(gpu.outputs_for(t), cpu.outputs_for(t))


def _benchmark_pool_scheduler(count):
    """``count`` tenants of benchmarks/multitenant_bench.py's pool (its six
    shapes in turn, weights from a seed) on a chip sized to admit them
    merged, and their traffic specs."""
    from repro_torch.dataplane.lowering import lower_program, peak_stage_rows
    from repro_torch.dataplane.multitenant import SwitchScheduler

    shapes = [(32, 64, 32), (16, 32, 8), (32, 16), (8, 12, 6), (16, 8, 4), (32, 32, 4)]
    scen = ("ddos_burst", "iot_telemetry", "flow_tuple", "adversarial_bitflip", "uniform_random")
    rng = np.random.default_rng(3)
    progs, specs = [], []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        progs.append(compiler.compile_bnn(
            [rng.integers(0, 2, (shape[j + 1], shape[j])).astype(np.int32) for j in range(len(shape) - 1)]))
        specs.append(traffic.TenantTrafficSpec(scen[i % len(scen)], shape[0]))
    chip = pipeline.ChipSpec(
        num_elements=sum(p.num_elements for p in progs) + 1, phv_bits=sum(p.peak_phv_bits for p in progs),
        max_parallel_ops=max(pipeline.MAX_FIELDS, peak_stage_rows([lower_program(p) for p in progs])),
        name="shared")
    sched = SwitchScheduler(chip, mode="merged")
    for i, p in enumerate(progs):
        sched.admit(p, name=f"t{i}")
    return sched, specs


@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_merged_op_table_beyond_shared_memory_serves(cuda, layout):
    """32 tenants of benchmarks/multitenant_bench.py merged: 1,833
    registers, more than one packet's share of a block's shared memory at
    the shared route's smallest block.  The op-table dispatch serves them on
    the split route, every launch, and each tenant gets what the CPU
    scheduler gives it (the packed dispatch too, its concat layer on the
    tiled route)."""
    sched, specs = _benchmark_pool_scheduler(32)
    lp = sched.merged(layout).lowered
    assert lp.num_regs == 1833
    plan, _ = optable_exec.prepare(tuple(executor._i32(getattr(lp, n)) for n in TABLES), lp.num_regs)
    assert optable_exec.route(plan, lp.num_regs) == "split"
    pair = traffic.mixed_tenant_generate(specs, 512, seed=0)
    fn = optable_exec.optable_run
    before = (fn.launches, dict(fn.launches_by_route))
    gpu = sched.run(pair, merged=layout, backend="jnp", chunk_size=200, device=cuda)
    launched = fn.launches - before[0]
    assert launched == gpu.chunks + 1  # every chunk and the warm call
    assert {p: fn.launches_by_route[p] - before[1][p] for p in before[1]} == {
        "shared": 0, "split": launched, "global": 0}
    cpu = sched.run(pair, merged=layout, backend="jnp", chunk_size=200, device="cpu")
    layer = packed_layer.packed_layer
    layer_before = dict(layer.launches_by_route)
    packed = sched.run(pair, merged=layout, backend="packed", chunk_size=200, device=cuda)
    if layout == "concat":  # its block-diagonal 916 x 32-word layer is past shared memory
        assert layer.launches_by_route["tiled"] - layer_before["tiled"] == packed.chunks + 1
        assert layer.launches_by_route["cached"] == layer_before["cached"]
    for t in range(32):
        a, b = gpu.stats_for(t), cpu.stats_for(t)
        assert (a.packets, a.served, a.dropped) == (b.packets, b.served, b.dropped)
        np.testing.assert_array_equal(gpu.outputs_for(t), cpu.outputs_for(t))
        np.testing.assert_array_equal(packed.outputs_for(t), cpu.outputs_for(t))


def test_interleaved_packed_dispatch_makes_no_host_sync(cuda):
    """One interleaved packed dispatch, as the scheduler makes it (the ids
    checked on the host before the upload), launches without reading
    anything back from the device up to its copy back; the public
    ``packed_layer_routed`` reads the ids' range back, and the sync check
    catches that."""
    sched = _scheduler3()
    specs = [traffic.TenantTrafficSpec(*s) for s in SPECS3]
    tids, bits = traffic.mixed_tenant_generate(specs, 3000, seed=4)
    lowereds = tuple(t.lowered for t in sched.tenants)
    fn = executor.routed_packed_stacked_fn(lowereds, device=cuda)
    d_tids, d_bits = executor._to_device(tids, cuda), executor._to_device(bits, cuda)
    fn(d_bits, d_tids)  # builds the kernels
    words = bitpack.pack_bits_words(d_bits[:, :32].contiguous())
    w, thr, m, _ = (executor._i32(a).to(cuda) if i < 3 else a
                    for i, a in enumerate(executor.stack_tenant_layers(lowereds)[0]))
    torch.cuda.synchronize()
    routed = packed_layer.packed_layer_routed
    before = dict(routed.launches_by_route)
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = fn(d_bits, d_tids)
        with pytest.raises(RuntimeError):
            routed(words, d_tids, w, m, thr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    depth = len(executor.stack_tenant_layers(lowereds))
    assert {p: routed.launches_by_route[p] - before[p] for p in before} == {"quad": depth, "general": 0}
    want = executor.routed_packed_stacked_fn(lowereds, device="cpu")(torch.from_numpy(bits), torch.from_numpy(tids))
    assert torch.equal(out.cpu(), want)


# ---------------------------------------------------------------------------
# The op-table kernel's global route, forced, against the plain version
# ---------------------------------------------------------------------------

def _fuzz_lowered(sizes, weight_seed, mode, threshold_seed):
    """A random program as tests/strategies.py's ``build_case`` makes one
    (weights and SIGN thresholds from the case's seeds; widths crossing the
    32-bit word, so popcounts FOLD), compiled by the port's compiler: that
    module imports the JAX package, which a card's machine may lack."""
    rng = np.random.default_rng(weight_seed)
    params = [rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32) for i in range(len(sizes) - 1)]
    thresholds = None
    if mode != "default":
        trng = np.random.default_rng(threshold_seed)
        thresholds = [int(trng.integers(0, w.shape[1] + 2)) if mode == "scalar"
                      else trng.integers(0, w.shape[1] + 2, w.shape[0]).astype(np.int32) for w in params]
    return compiler.compile_bnn(params, thresholds=thresholds).lower()


FUZZ = {
    "fuzz_a": ((40, 33, 7), 11, "per_neuron", 12),
    "fuzz_b": ((48, 48), 21, "scalar", 22),
    "fuzz_c": ((33, 5, 40, 2), 31, "default", 0),
}


def _relocated(tables, offset):
    """The op-table with every slot (dst, src0, src1) moved up by ``offset``."""
    return tuple(t + offset if name in ("dst", "src0", "src1") else t for name, t in zip(TABLES, tables))


def _global_program(name, cuda):
    """(tables, num_regs): a program, or one moved to the top of a register
    file past what the shared route holds (``*_wide``)."""
    base = name.removesuffix("_wide")
    if base == "hand":
        tables, num_regs = _hand_tables(cuda), 6
    else:
        lp = (_fuzz_lowered(*FUZZ[base]) if base in FUZZ
              else _lowered((128, 64, 32, 2) if base == "five_tuple" else (32, 64, 32), seed=9))
        tables, num_regs = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES), lp.num_regs
    if name.endswith("_wide"):
        wide = 3000
        tables, num_regs = _relocated(tables, wide - num_regs), wide
    return tables, num_regs


@pytest.mark.parametrize("program", ["hand", *FUZZ, "headline", "five_tuple", "hand_wide", "fuzz_a_wide"])
@pytest.mark.parametrize("batch", [0, 1, 1001, 32768 + 7])
def test_optable_global_route_matches_plain(cuda, program, batch):
    tables, num_regs = _global_program(program, cuda)
    regs = _any_regs(num_regs, batch, cuda, seed=batch + 1)
    plan, records = optable_exec.prepare(tables, num_regs)
    if program in FUZZ:  # FOLD continuations and deferred rows are on the path
        assert (tables[TABLES.index("first_write")] == 0).any() and plan.deferred.any()
    assert optable_exec.route(plan, num_regs) == ("split" if program.endswith("_wide") else "shared")
    fn = optable_exec.optable_run
    before = dict(fn.launches_by_route)
    out = optable_exec._launch(regs, plan, records, "global")
    want = optable_exec.optable_run_plain(regs, *tables)
    torch.cuda.synchronize()
    assert {p: fn.launches_by_route[p] - before[p] for p in before} == {
        "shared": 0, "split": 0, "global": int(batch > 0)}
    assert out.shape == regs.shape and out.is_contiguous()
    assert torch.equal(out, want)
    if program.endswith("_wide"):
        with pytest.raises(ValueError, match="shared memory"):
            optable_exec._launch(regs, plan, records, "shared")


# The split route, forced, on every case of the global route's test: FOLD
# chains, rows that write what an earlier row read, pads into a nonzero null
# register.  The wide programs (3,000 registers) take it by themselves.
@pytest.mark.parametrize("program", ["hand", *FUZZ, "headline", "five_tuple", "hand_wide", "fuzz_a_wide"])
@pytest.mark.parametrize("batch", [0, 1, 7, 1001, 32768 + 7])
def test_optable_split_route_matches_plain(cuda, program, batch):
    tables, num_regs = _global_program(program, cuda)
    regs = _any_regs(num_regs, batch, cuda, seed=batch + 2)
    plan, _ = optable_exec.prepare(tables, num_regs)
    split, split_records = optable_exec.prepare_split(tables, num_regs)
    want = optable_exec.optable_run_plain(regs, *tables)
    fn = optable_exec.optable_run
    before = dict(fn.launches_by_route)
    out = optable_exec._launch(regs, split, split_records, "split")
    torch.cuda.synchronize()
    assert {p: fn.launches_by_route[p] - before[p] for p in before} == {
        "shared": 0, "split": int(batch > 0), "global": 0}
    assert out.shape == regs.shape and out.is_contiguous()
    assert torch.equal(out, want)
    if program.endswith("_wide"):
        assert optable_exec.route(plan, num_regs) == "split"
        before = dict(fn.launches_by_route)
        assert torch.equal(fn(regs, *tables), want)  # the public wrapper takes the split route itself
        assert {p: fn.launches_by_route[p] - before[p] for p in before} == {
            "shared": 0, "split": int(batch > 0), "global": 0}


def test_optable_global_route_indexes_past_2_31(cuda):
    """The hand-made program at the top of a 65,532-register file (the
    records' 16-bit slots allow 65,536 with its 4 scratch rows) over 32,775
    packets: slot x batch passes 2^31 from slot 65,523.  The program's six
    registers come out as the plain version gives them on those six alone,
    and every other register as it went in."""
    num_regs, batch = 65532, 32768 + 7
    top = num_regs - 6
    assert (top - 4) * batch < 2 ** 31 <= top * batch  # every slot of the program is past it
    tables = _relocated(_hand_tables(cuda), top)
    gen = torch.Generator(device=cuda).manual_seed(0)
    regs = torch.randint(0, 1 << 30, (num_regs, batch), dtype=torch.int32, device=cuda, generator=gen)
    regs[top:] = _any_regs(6, batch, cuda, seed=5)
    plan, records = optable_exec.prepare(tables, num_regs)
    assert optable_exec.route(plan, num_regs) == "global" and num_regs + plan.max_deferred == 1 << 16
    with pytest.raises(ValueError, match="shared memory"):  # a forced split launch cannot hold the file
        optable_exec.prepare_split(tables, num_regs)
    out = optable_exec.optable_run(regs, *tables)
    want = optable_exec.optable_run_plain(regs[top:].contiguous(), *_hand_tables(cuda))
    torch.cuda.synchronize()
    assert torch.equal(out[top:], want)
    assert torch.equal(out[:top], regs[:top])


@pytest.mark.parametrize("count", [32, 128])
@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_wide_merges_take_split_at_chunk_1024(cuda, count, layout):
    """The 32- and 128-tenant merges of benchmarks/multitenant_bench.py's
    pool over a chunk of 1024 routed packets: the wrapper takes the split
    route, bit-exact with the plain version (the global route, forced, too)."""
    sched, specs = _benchmark_pool_scheduler(count)
    mp = sched.merged(layout)
    lp = mp.lowered
    tids, bits = traffic.mixed_tenant_generate(specs, 1024, seed=count)
    idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(cuda)  # noqa: E731
    regs = executor.parse_packets_routed(torch.from_numpy(bits).to(cuda), torch.from_numpy(tids).to(cuda),
                                         idx(mp.in_slot), idx(mp.in_shift), idx(mp.in_valid),
                                         num_regs=lp.num_regs)
    regs[-1] = 0x5EED  # a nonzero null register
    tables = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES)
    plan, records = optable_exec.prepare(tables, lp.num_regs)
    assert optable_exec.route(plan, lp.num_regs) == "split"
    fn = optable_exec.optable_run
    out = _launched(fn, "split", lambda: fn(regs, *tables))
    want = optable_exec.optable_run_plain(regs, *tables)
    assert torch.equal(out, want)
    assert torch.equal(_launched(fn, "global", lambda: optable_exec._launch(regs, plan, records, "global")), want)


def test_optable_second_split_launch_makes_no_host_sync(cuda):
    """The split route's plan is made and uploaded at the first launch;
    the second reads nothing back and copies nothing."""
    tables, num_regs = _global_program("fuzz_a_wide", cuda)
    regs = _any_regs(num_regs, 1000, cuda, seed=4)
    fn = optable_exec.optable_run
    fn(regs, *tables)
    torch.cuda.synchronize()
    before = dict(fn.launches_by_route)
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = fn(regs, *tables)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {p: fn.launches_by_route[p] - before[p] for p in before} == {"shared": 0, "split": 1, "global": 0}
    assert torch.equal(out, optable_exec.optable_run_plain(regs, *tables))


# ---------------------------------------------------------------------------
# The batched packed expert GEMM, and the MoE / MLA models on the card
# ---------------------------------------------------------------------------

def _expert_operands(rng, e, c, o, kw, k_bits):
    """Random (E, C, Kw) and (E, O, Kw) packed operands, zero past k_bits."""
    pairs = [_packed_operands(rng, c, o, kw, k_bits) for _ in range(e)]
    return torch.stack([x for x, _ in pairs]), torch.stack([w for _, w in pairs])


# C of 1 to 16 with Kw a multiple of 4 streams; C of 17 and up, or a ragged
# Kw (K not a multiple of 128 bits), takes the mma kernel.  Odd E and
# ragged O, C and K; qwen3-moe-30b-a3b's gate (E=128, O=768, Kw=64) and down
# (O=2048, Kw=24) shapes at decode, prefill and scoring capacities.
@pytest.mark.parametrize("e,c,o,k", [
    (1, 1, 64, 128), (3, 1, 77, 100), (5, 10, 130, 3000), (7, 16, 33, 256), (7, 17, 33, 256),
    (3, 160, 70, 513), (128, 1, 768, 2048), (128, 10, 2048, 768), (128, 160, 768, 2048),
    (128, 160, 2048, 768), (5, 160, 130, 3000),
])
def test_bnn_matmul_packed_experts_matches_plain(cuda, e, c, o, k):
    rng = np.random.default_rng(e * 1000 + c + k)
    kw = -(-k // 32)
    x, w = _expert_operands(rng, e, c, o, kw, k)
    fn = bnn_matmul.bnn_matmul_packed_experts
    path = "stream" if c <= bnn_matmul.STREAM_MAX_M and kw % 4 == 0 else "mma"
    before = fn.launches
    out = _launched(fn, path, lambda: fn(x.to(cuda), w.to(cuda), k_bits=k))
    assert fn.launches == before + 1
    assert torch.equal(out.cpu(), ref.bnn_matmul_packed_experts_ref(x, w, k))
    # The other routes compute the same on any shape: mma where stream
    # serves, and the first design, tiled, forced.
    for forced in ("mma", "tiled") if path == "stream" else ("tiled",):
        out = _launched(fn, forced, lambda: bnn_matmul._launch_experts(
            x.to(cuda), w.to(cuda), torch.empty_like(out), k, forced))
        assert torch.equal(out.cpu(), ref.bnn_matmul_packed_experts_ref(x, w, k))


def test_bnn_matmul_packed_experts_edges(cuda):
    """No expert, no slot, no word: nothing is launched."""
    fn = bnn_matmul.bnn_matmul_packed_experts
    before = fn.launches
    x = torch.zeros((2, 3, 4), dtype=torch.int32, device=cuda)
    assert fn(x[:0], x[:0], k_bits=128).shape == (0, 3, 3)
    assert fn(x[:, :0], x, k_bits=128).shape == (2, 0, 3)
    empty = torch.zeros((2, 3, 0), dtype=torch.int32, device=cuda)
    assert torch.equal(fn(empty, empty, k_bits=0), torch.zeros((2, 3, 3), dtype=torch.int32, device=cuda))
    assert fn.launches == before
    assert torch.equal(fn(x, x, k_bits=128), torch.full((2, 3, 3), 128, dtype=torch.int32, device=cuda))


def test_stablelm_flash_at_head_dim_80_takes_tma(cuda):
    """stablelm-3b's heads are 80 wide (d_model 2560 over 32 heads): flash's
    tma route, against the plain version."""
    cfg = get_config("stablelm-3b")
    assert cfg.resolved_head_dim == 80
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((4, 300, 80), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    fa = flash_attention.flash_attention
    got = _launched(fa, "tma", lambda: fa(q, k, v))
    want = flash_attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


def _tiny_moe(**kw):
    """A two-layer qwen3-moe of width 128 (4 words a row: the stream
    route's shapes) with 8 experts of 128, top 2."""
    import dataclasses

    cfg = get_config(
        "qwen3-moe-30b-a3b", num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=97, attn_q_chunk=16, init_std=0.5, dtype="float32",
        quant=QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj", "moe")), **kw,
    )
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                                            expert_ffn_dim=128))


def test_moe_engine_step_on_cuda_launches_and_matches_cpu(cuda):
    """A tiny packed qwen3-moe serves the CPU's tokens on the card; one
    decode step of its 2 slots makes, per layer, 4 packed projection
    launches, 3 expert launches (capacity 1: the stream route) and 7
    bit-packs."""
    from repro_torch import models
    from repro_torch.serving.engine import Engine, Request

    cfg = _tiny_moe()
    params = models.init_params(cfg, 1, device="cpu")
    outs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_len=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=(np.arange(4 + 5 * i) * 7 + i) % 90, max_new_tokens=3 + 2 * i))
        outs.append([(r.rid, r.output) for r in eng.run()])
    assert outs[0] == outs[1]

    eng = Engine(cfg, _to(params, cuda), max_batch=2, max_len=64, device=cuda)
    eng.submit(Request(rid=0, prompt=np.arange(5) % 90, max_new_tokens=4))
    eng._admit()
    experts, packed, pack = (bnn_matmul.bnn_matmul_packed_experts, bnn_matmul.bnn_matmul_packed,
                             bitpack.bitpack)
    before = (experts.launches, dict(experts.launches_by_route), packed.launches, pack.launches)
    eng._step()
    torch.cuda.synchronize()
    assert experts.launches - before[0] == 3 * cfg.num_layers
    assert experts.launches_by_route["stream"] - before[1]["stream"] == 3 * cfg.num_layers
    assert packed.launches - before[2] == 4 * cfg.num_layers
    assert pack.launches - before[3] == 7 * cfg.num_layers


# -- the SSM, hybrid, VLM and audio families on the card ------------------------------

def _tiny_family(arch, dtype="float32"):
    """A tiny packed ``arch`` of width 128 (4 words a row: the stream route's
    shapes), head dim 32; mamba2 two layers, zamba2 five at period 2 (two
    shared-block applications and a tail), internvl2 with 8 patches."""
    import dataclasses

    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128,
              vocab_size=97, attn_q_chunk=16, init_std=0.5, dtype=dtype,
              quant=QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj", "moe")))
    cfg = get_config(arch)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk=16)
    if cfg.family == "hybrid":
        kw.update(num_layers=5, hybrid_period=2)
    if cfg.family == "vlm":
        kw["num_patches"] = 8
    return get_config(arch, **kw)


def _family_batch(cfg, device, s=12, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "frames":
        batch = {"frames": torch.randn((2, s, cfg.d_model), generator=gen).to(cfg.param_dtype())}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=gen)}
        if cfg.input_mode == "tokens+patches":
            batch["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def _packed_per_call(cfg):
    """Packed projection launches (each after one ``bitpack``) one call
    makes: 7 per attention block with a SwiGLU FFN, 6 with a GELU one; one
    block a layer, none in an SSM, one per group of ``hybrid_period`` in
    the hybrid."""
    blocks = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.hybrid_period, 1)}.get(cfg.family, cfg.num_layers)
    return blocks * (4 + (3 if cfg.act == "swiglu" else 2))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "internvl2-2b", "hubert-xlarge"])
def test_family_forward_on_cuda_matches_cpu(cuda, arch):
    """float32 logits on the card within 1e-4 of the CPU's largest magnitude
    (the packed GEMMs are exact; float32 products sum in another order), and
    one forward's launches exactly the counted ones, on the mma route."""
    from repro_torch import models

    cfg = _tiny_family(arch)
    params = models.init_params(cfg, 1, device="cpu")
    want, _ = models.forward(params, _family_batch(cfg, "cpu"), cfg)
    packed, pack = bnn_matmul.bnn_matmul_packed, bitpack.bitpack
    before = (packed.launches, packed.launches_by_route["mma"], pack.launches)
    with torch.inference_mode():
        got, _ = models.forward(_to(params, cuda), _family_batch(cfg, cuda), cfg)
    torch.cuda.synchronize()
    n = _packed_per_call(cfg)
    assert (packed.launches, packed.launches_by_route["mma"], pack.launches) == tuple(b + n for b in before)
    assert (n == 0) == (arch == "mamba2-1.3b")
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_family_engine_on_cuda_serves_cpu_tokens(cuda, arch):
    """The ``Engine`` serves the CPU's greedy tokens on the card (an SSM
    cache copied whole into its slot, a hybrid's KV slots beside it); one
    decode step of 2 slots launches exactly the counted packed projections,
    every one on the stream route (none for mamba2)."""
    from repro_torch import models
    from repro_torch.serving.engine import Engine, Request

    cfg = _tiny_family(arch)
    params = models.init_params(cfg, 1, device="cpu")
    outs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_len=64, device=dev)
        for i, n in enumerate((4, 2, 9)):
            eng.submit(Request(rid=i, prompt=(np.arange(n) * 7 + i) % 90, max_new_tokens=3 + 2 * i))
        outs.append([(r.rid, r.output) for r in eng.run()])
    assert outs[0] == outs[1]

    eng = Engine(cfg, _to(params, cuda), max_batch=2, max_len=64, device=cuda)
    eng.submit(Request(rid=0, prompt=np.arange(5) % 90, max_new_tokens=4))
    eng._admit()
    packed, pack = bnn_matmul.bnn_matmul_packed, bitpack.bitpack
    before = (packed.launches, packed.launches_by_route["stream"], pack.launches)
    eng._step()
    torch.cuda.synchronize()
    n = _packed_per_call(cfg)
    assert (packed.launches, packed.launches_by_route["stream"], pack.launches) == tuple(b + n for b in before)


def test_vlm_prefill_and_decode_on_cuda_match_cpu(cuda):
    """internvl2's prefill over 8 patches + 6 tokens and three decode steps
    without the decode carry: logits within 1e-4 of the CPU's scale, equal
    greedy tokens, 7 packed launches a layer a call."""
    from repro_torch import models

    cfg = _tiny_family("internvl2-2b")
    assert not cfg.decode_cache_carry
    params = models.init_params(cfg, 1, device="cpu")
    runs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        batch = _family_batch(cfg, dev, s=6)
        packed = bnn_matmul.bnn_matmul_packed
        before = packed.launches
        with torch.inference_mode():
            logits, pc = models.prefill(p, batch, cfg)
            cache = models.init_cache(cfg, 2, 24, device=dev)
            for dst, src in zip(models.model.cache_tensors(cache), models.model.cache_tensors(pc)):
                dst[:, :, : src.shape[2]] = src
            cache = models.model.set_index(cache, pc.index)
            steps = [logits]
            for _ in range(3):
                logits, cache = models.decode_step(p, logits.argmax(-1), cache, cfg)
                steps.append(logits)
        launched = packed.launches - before
        runs.append(([t.cpu() for t in steps], launched))
    (want, cpu_launched), (got, launched) = runs
    assert cpu_launched == 0 and launched == 4 * _packed_per_call(cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
        assert torch.equal(g.argmax(-1), w.argmax(-1))


def test_hubert_flash_is_full_attention_on_tma(cuda):
    """bf16 hubert with flash: one ``flash_attention`` launch a layer, every
    one full (non-causal) on the tma route, 6 packed launches a layer on the
    mma route; float32, flash's f32 route on the card within 2e-3 of plain
    attention on the CPU."""
    import dataclasses

    from repro_torch import models

    cfg = dataclasses.replace(_tiny_family("hubert-xlarge", "bfloat16"), attn_impl="pallas_flash")
    fa, packed = flash_attention.flash_attention, bnn_matmul.bnn_matmul_packed
    before = (dict(fa.launches_by_route), dict(fa.launches_by_mask), packed.launches_by_route["mma"])
    with torch.inference_mode():
        logits, _ = models.forward(models.init_params(cfg, 1, device=cuda), _family_batch(cfg, cuda, s=40), cfg)
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert {p: fa.launches_by_route[p] - before[0][p] for p in before[0]} == {"tma": layers, "wmma": 0, "f32": 0}
    assert {m: fa.launches_by_mask[m] - before[1][m] for m in before[1]} == {"causal": 0, "full": layers}
    assert packed.launches_by_route["mma"] - before[2] == 6 * layers
    assert bool(torch.isfinite(logits).all())

    f32 = dataclasses.replace(cfg, dtype="float32", quant=QuantConfig())
    params = models.init_params(f32, 2, device="cpu")
    want, _ = models.forward(params, _family_batch(f32, "cpu", s=40), dataclasses.replace(f32, attn_impl="xla"))
    got, _ = models.forward(_to(params, cuda), _family_batch(f32, cuda, s=40), f32)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-3)


def _counts():
    return {name: fn.launches for name, fn in (
        ("bnn_matmul_packed", bnn_matmul.bnn_matmul_packed), ("bnn_matmul_mxu", bnn_matmul_mxu.bnn_matmul_mxu),
        ("flash_attention", flash_attention.flash_attention), ("bitpack", bitpack.bitpack),
        ("bnn_matmul_packed_experts", bnn_matmul.bnn_matmul_packed_experts))}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_train_step_on_cuda_matches_cpu(cuda, arch):
    """Two ``make_train_step`` steps (microbatches 2, ``bnn_weight_only``,
    float32, remat on) on the card against the CPU: losses and grad norms
    within 1e-4, parameters within 2 x lr (AdamW moves an element by about
    lr whatever its gradient's size, so a gradient that rounds to the
    other sign moves it the other way) and almost all within 1e-6; no
    kernel launches (the training forward is the plain path)."""
    from repro_torch import models, tree
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step

    import dataclasses

    full = get_config(arch)
    kw = {}
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(full.moe, num_experts=8, top_k=2, expert_ffn_dim=32, capacity_factor=2.0)
    if full.mla is not None:
        kw["mla"] = dataclasses.replace(full.mla, kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
                                        qk_rope_dim=8, v_head_dim=16)
    cfg = get_config(arch, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                     vocab_size=97, attn_q_chunk=16, dtype="float32",
                     quant=QuantConfig(mode="bnn_weight_only", targets=("ffn", "attn_proj", "moe")), **kw)
    gen = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen),
                "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)} for _ in range(2)]
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt, microbatches=2)
    params = models.init_params(cfg, 0, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        p = tree.map(torch.clone, p) if dev == "cpu" else p
        state = opt.init(p)
        before = _counts()
        metrics = []
        for batch in batches:
            p, state, m = step(p, state, _to(batch, dev))
            metrics.append({k: float(v) for k, v in m.items()})
        if dev != "cpu":
            assert _counts() == before
        runs[str(dev)] = (tree.leaves(p), metrics)
    (want, want_m), (got, got_m) = runs["cpu"], runs[str(cuda)]
    for g, w in zip(got_m, want_m):
        for key in ("loss", "aux", "grad_norm"):
            assert abs(g[key] - w[key]) <= 1e-4 * max(1.0, abs(w[key])), key
    apart = total = 0
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2.1e-3)
        apart += int(((g.cpu() - w).abs() > 1e-6).sum())
        total += w.numel()
    assert apart <= 1e-3 * total, (apart, total)


@pytest.mark.parametrize("dtype,use_master", [(torch.bfloat16, True), (torch.float32, True),
                                              (torch.bfloat16, False)])
def test_update_in_place_on_cuda_is_update(cuda, dtype, use_master):
    """``AdamW.update_`` on the card writes the bits ``update`` returns."""
    from repro_torch import tree
    from repro_torch.optim.adamw import AdamW

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"a": torch.randn((300, 70), generator=gen, device=cuda).to(dtype),
              "b": [torch.randn(513, generator=gen, device=cuda).to(dtype)]}
    opt = AdamW(lr=1e-2, use_master=use_master)
    ref_p, ref_s = params, opt.init(params)
    p, s = tree.map(torch.clone, params), opt.init(params)
    for _ in range(3):
        grads = tree.map(lambda t: torch.randn(t.shape, generator=gen, device=cuda).to(dtype), params)
        ref_p, ref_s, ref_m = opt.update(grads, ref_s, ref_p)
        p, s, m = opt.update_(grads, s, p)
        for got, want in zip(tree.leaves((p, s, m)), tree.leaves((ref_p, ref_s, ref_m)), strict=True):
            assert got.dtype == want.dtype and torch.equal(got, want)


# (shape, quant): phi3 at published widths and 4 layers; the packed cells
# launch ``bitpack`` and ``bnn_matmul_packed`` (decode on the stream route,
# prefill on mma), training runs the plain path.
DRYRUN_CASES = [
    (("dryrun_decode", 4096, 8, "decode"), "bnn_packed"),
    (("dryrun_prefill", 2048, 4, "prefill"), "bnn_packed"),
    (("dryrun_train", 1024, 4, "train"), "none"),
]


@pytest.mark.parametrize("shape,mode", DRYRUN_CASES)
def test_dryrun_cell_on_cuda(cuda, tmp_path, shape, mode):
    """``run_cell`` on the card at a reduced phi3: an ``ok`` record whose
    measured peak lies between the exact resident bytes and resident +
    the activation estimate (batch 1's measured activations times the
    sequences a pass holds, which covers these reduced cells; at full
    width some decode cells' activations grow faster than their batch),
    the counted step's kernel launches those the count saw, roofline
    fraction and mfu in (0, 1], the floor below the measured step."""
    from repro_torch.launch import dryrun, shapes

    shape = shapes.Shape(*shape)
    quant = QuantConfig(mode=mode, targets=("ffn", "attn_proj"))
    rec = dryrun.run_cell("phi3-mini-3.8b", shape.name, str(tmp_path), {"num_layers": 4, "quant": quant},
                          device=cuda, shape=shape, steps=2)
    assert rec["status"] == "ok" and rec["batch"] == shape.global_batch and rec["output"]["finite"]
    m = rec["memory"]
    resident = m["resident_bytes"]["total"]
    assert resident <= m["peak_bytes"] <= resident + m["estimate_bytes"], m
    assert rec["launches"] == rec["counts"]["kernel_launches"]
    if mode == "bnn_packed":
        assert rec["launches"]["bitpack"] > 0 and rec["launches"]["bnn_matmul_packed"] > 0
    else:
        assert rec["launches"] == {}
    roof = rec["roofline"]
    assert 0 < roof["roofline_fraction"] <= 1 and 0 < roof["mfu"] <= 1
    assert roof["measured_step_s"] == rec["step_s"]["median"] > 0
    assert 0 < roof["floor_fraction"] <= 1 and rec["measure_s"] > 0


# -- the attention that serving runs: chunked_attention and decode_attention ----------

from repro_torch.kernels import chunked_attention as chunked  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402

BF16_ULP = 2.0 ** -7


def _within_rounding(got, want, mean_abs_v, rel):
    """Every element within ``rel`` of (|want| + the row's softmax-weighted
    mean of |v|): for bf16 (``rel`` one bf16 ulp) each side rounds its
    float32 result once and, in prefill, its weights p to bf16; for float32
    (``rel`` 1e-5) the sums are taken in another order."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    bound = rel * (want.float().abs() + mean_abs_v)
    assert bool((diff <= bound).all()), float((diff / bound).max())


def _qkv(b, s, h, kvh, dqk, dv, dtype, seed, cuda):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, dqk), generator=gen)
    k = torch.randn((b, s, kvh, dqk), generator=gen)
    v = torch.randn((b, s, kvh, dv), generator=gen)
    return (t.to(cuda, dtype) for t in (q, k, v))


def _check_chunked(q, k, v, causal, scores_dtype=torch.float32, path=None):
    scale = 1.0 / q.shape[-1] ** 0.5
    kw = dict(causal=causal, q_chunk=32, scale=scale, scores_dtype=scores_dtype)
    fn = chunked.chunked_attention
    got = _launched(fn, path or chunked.route(q, k, v), lambda: fn(q, k, v, **kw))
    want = chunked.chunked_attention_plain(q, k, v, **kw)
    mean_abs_v = chunked.chunked_attention_plain(q.float(), k.float(), v.float().abs(), **kw)
    _within_rounding(got, want, mean_abs_v, BF16_ULP if q.dtype == torch.bfloat16 else 1e-5)


# (S, H, KVH, Dqk, Dv): S around the 64-row tiles, G of 1 to 16, the model
# head dims (64, 80, 96, 128), MLA's 192 / 128 and 96 / 64, D = 20 (element
# copies).
CHUNKED_SHAPES = [(1, 4, 4, 64, 64), (63, 4, 2, 96, 96), (64, 8, 1, 128, 128), (65, 2, 2, 80, 80),
                  (130, 16, 1, 64, 64), (300, 4, 4, 192, 128), (77, 2, 2, 96, 64), (100, 4, 2, 20, 20)]


@pytest.mark.parametrize("shape", CHUNKED_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_attention_kernel_matches_plain(cuda, shape, causal, dtype):
    s, h, kvh, dqk, dv = shape
    _check_chunked(*_qkv(2, s, h, kvh, dqk, dv, dtype, s + dqk, cuda), causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(65, 4, 2, 96, 96), (300, 4, 4, 192, 128)])
def test_chunked_attention_bf16_scores(cuda, dtype, shape):
    s, h, kvh, dqk, dv = shape
    _check_chunked(*_qkv(2, s, h, kvh, dqk, dv, dtype, 7, cuda), True, torch.bfloat16)


def test_chunked_attention_long_prompt_and_misaligned_operand(cuda):
    q, k, v = _qkv(1, 2048, 8, 2, 96, 96, torch.bfloat16, 3, cuda)
    _check_chunked(q, k, v, True)
    _check_chunked(_shifted(q, 2), k, v, True)   # element copies: the kernel's other loader


# (Dqk, Dv, G) of every served prefill: phi3, qwen3-moe, deepseek-v2 (MLA),
# minicpm3 (MLA), stablelm, chatglm3, zamba2, internvl2.
SERVED_CHUNKED = [(96, 96, 1), (128, 128, 8), (192, 128, 1), (96, 64, 1), (80, 80, 1), (128, 128, 16),
                  (64, 64, 1), (128, 128, 2)]


@pytest.mark.parametrize("dims", SERVED_CHUNKED)
@pytest.mark.parametrize("s", [1, 13, 64, 65, 129, 300])
def test_chunked_attention_tma_route_at_served_shapes(cuda, dims, s):
    """The tma kernel against the plain version at every served (Dqk, Dv,
    G), S around the 128-key tiles and 128-row blocks, batch 2, causal and
    full."""
    dqk, dv, g = dims
    q, k, v = _qkv(2, s, 2 * g, 2, dqk, dv, torch.bfloat16, s + dqk + g, cuda)
    assert chunked.route(q, k, v) == "tma"
    _check_chunked(q, k, v, True, path="tma")
    _check_chunked(q, k, v, False, path="tma")


@pytest.mark.parametrize("dims", [(96, 96, 1), (192, 128, 1), (128, 128, 8)])
@pytest.mark.parametrize("s", [65, 300])
def test_chunked_attention_tma_route_bf16_scores(cuda, dims, s):
    dqk, dv, g = dims
    q, k, v = _qkv(2, s, 2 * g, 2, dqk, dv, torch.bfloat16, 11, cuda)
    _check_chunked(q, k, v, True, torch.bfloat16, path="tma")


@pytest.mark.parametrize("scale", [0.7, -0.3, 0.0])
def test_chunked_attention_tma_route_takes_any_scale(cuda, scale):
    """A scale of 0 or below scales the sums before the max (the folded
    exponent needs scale > 0)."""
    q, k, v = _qkv(2, 130, 4, 2, 64, 64, torch.bfloat16, 5, cuda)
    kw = dict(causal=True, q_chunk=32, scale=scale)
    fn = chunked.chunked_attention
    got = _launched(fn, "tma", lambda: fn(q, k, v, **kw))
    want = chunked.chunked_attention_plain(q, k, v, **kw)
    mean_abs_v = chunked.chunked_attention_plain(q.float(), k.float(), v.float().abs(), **kw)
    _within_rounding(got, want, mean_abs_v, BF16_ULP)


def test_chunked_attention_tma_route_reads_strided_views(cuda):
    """MLA's prefill passes V as a slice of the expanded (K nope, V) rows:
    the tma kernel maps the view as it is."""
    b, s, h, nope, rope, dv = 2, 77, 4, 128, 64, 128
    gen = torch.Generator().manual_seed(9)
    kv = torch.randn((b, s, h, nope + dv), generator=gen).to(cuda, torch.bfloat16)
    q = torch.randn((b, s, h, nope + rope), generator=gen).to(cuda, torch.bfloat16)
    k_rope = torch.randn((b, s, 1, rope), generator=gen).to(cuda, torch.bfloat16)
    k = torch.cat([kv[..., :nope], k_rope.expand(b, s, h, rope)], dim=-1)
    v = kv[..., nope:]
    assert not v.is_contiguous() and chunked.route(q, k, v) == "tma"
    _check_chunked(q, k, v, True, path="tma")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_chunked_attention_misaligned_view_takes_mma(cuda, which):
    ops = list(_qkv(2, 100, 4, 2, 96, 96, torch.bfloat16, which, cuda))
    ops[which] = _shifted(ops[which], 2)
    assert chunked.route(*ops) == "mma"
    _check_chunked(*ops, True, path="mma")


@pytest.mark.parametrize("dims", [(96, 96, 1), (128, 128, 8), (192, 128, 1)])
def test_chunked_attention_forced_mma_route_matches_plain(cuda, dims):
    """The first design's kernel on operands the tma route takes (its 16-byte copies),
    forced as the timing in turns forces it."""
    dqk, dv, g = dims
    q, k, v = _qkv(2, 300, 2 * g, 2, dqk, dv, torch.bfloat16, 4, cuda)
    kw = dict(causal=True, q_chunk=32, scale=1.0 / dqk ** 0.5)
    fn = chunked.chunked_attention
    out = torch.empty((2, 300, 2 * g, dv), dtype=torch.bfloat16, device=cuda)
    got = _launched(fn, "mma", lambda: chunked._launch(q, k, v, out, "mma", causal=True, scale=kw["scale"]))
    want = chunked.chunked_attention_plain(q, k, v, **kw)
    mean_abs_v = chunked.chunked_attention_plain(q.float(), k.float(), v.float().abs(), **kw)
    _within_rounding(got, want, mean_abs_v, BF16_ULP)


def _caches(b, s_max, h, kvh, d, dtype, seed, cuda, layers=1):
    """q (B, 1, H, D), caches of layer ``layers - 1`` of (L, B, S_max, KVH,
    D) stacks (a view, as the model passes them), k_new, v_new."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=gen).to(cuda, dtype)
    kc, vc = (torch.randn((layers, b, s_max, kvh, d), generator=gen).to(cuda, dtype)[-1] for _ in range(2))
    kn, vn = (torch.randn((b, 1, kvh, d), generator=gen).to(cuda, dtype) for _ in range(2))
    return q, kc, vc, kn, vn


def _check_decode(q, kc, vc, index, kn=None, vn=None):
    scale = 1.0 / q.shape[-1] ** 0.5
    fn = decode.decode_attention
    mode = "in_cache" if kn is None else "incremental"
    before = dict(fn.launches_by_mode)
    path = "bf16" if q.dtype == torch.bfloat16 else "f32"
    got = _launched(fn, path, lambda: fn(q, kc, vc, index, scale=scale, k_new=kn, v_new=vn))
    assert fn.launches_by_mode[mode] == before[mode] + 1
    want = decode.decode_attention_plain(q, kc, vc, index, scale=scale, k_new=kn, v_new=vn)
    mean_abs_v = decode.decode_attention_plain(
        q.float(), kc.float(), vc.float().abs(), index, scale=scale,
        k_new=None if kn is None else kn.float(), v_new=None if vn is None else vn.float().abs())
    _within_rounding(got, want, mean_abs_v, BF16_ULP if q.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("index", [0, 1, 63, 64, 65, 1000, 2047])
@pytest.mark.parametrize("mode", ["incremental", "in_cache"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_matches_plain(cuda, index, mode, dtype):
    q, kc, vc, kn, vn = _caches(3, 2048, 8, 2, 96, dtype, index, cuda, layers=2)
    if mode == "incremental":
        _check_decode(q, kc, vc, index, kn, vn)
    else:
        _check_decode(q, kc, vc, index)


# (H, KVH, D): phi3 (G 1, D 96), qwen3 (G 8, D 128), chatglm3 (G 16, D 128),
# stablelm (D 80), internvl2 (G 2, D 128), zamba2 (D 64), G 32 at D 64, G 4
# and 3, and D = 20 (element copies).
@pytest.mark.parametrize("heads", [(32, 32, 96), (32, 4, 128), (32, 2, 128), (32, 32, 80), (16, 8, 128),
                                   (8, 8, 64), (32, 1, 64), (8, 2, 96), (6, 2, 64), (4, 2, 20)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_model_head_shapes(cuda, heads, dtype):
    h, kvh, d = heads
    q, kc, vc, kn, vn = _caches(4, 300, h, kvh, d, dtype, d, cuda)
    _check_decode(q, kc, vc, 299, kn, vn)
    _check_decode(q, kc, vc, 299)
    _check_decode(q, kc, vc, 5000)   # past the end: the whole cache, as the plain masks keep it


@pytest.mark.parametrize("g", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("index", [0, 1, 63, 64, 65, 299])
@pytest.mark.parametrize("mode", ["incremental", "in_cache"])
def test_decode_attention_groups_and_tile_edges(cuda, g, index, mode):
    """G of 1 to 32 (one and two 16-head row tiles of the scores), index at
    the 16-key tiles' and the four warps' edges and S_max - 1, over a
    strided layer view of the caches."""
    q, kc, vc, kn, vn = _caches(2, 300, 2 * g, 2, 64, torch.bfloat16, index + g, cuda, layers=2)
    assert not kc.is_contiguous() or kc.storage_offset()
    if mode == "incremental":
        _check_decode(q, kc, vc, index, kn, vn)
    else:
        _check_decode(q, kc, vc, index)


@pytest.mark.parametrize("d", [13, 20])
@pytest.mark.parametrize("g", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_element_copies(cuda, d, g, dtype):
    """Rows of D % 8 != 0 (bf16) or % 4 != 0 (float32) are copied element
    by element, not in bulk."""
    q, kc, vc, kn, vn = _caches(2, 200, 2 * g, 2, d, dtype, d + g, cuda, layers=2)
    _check_decode(q, kc, vc, 150, kn, vn)
    _check_decode(q, kc, vc, 199)


@pytest.mark.parametrize("keys", [1, 255, 256, 2048, 4097])
def test_decode_attention_one_split_and_many(cuda, keys):
    """A short cache takes one split (the block writes the output); a long
    one several and the combine launch."""
    q, kc, vc, kn, vn = _caches(4, keys, 32, 2, 128, torch.bfloat16, keys, cuda)
    per_split, splits = decode.splits_for(keys, 4 * 2, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (splits == 1) == (-(-keys // decode.TILE) < 2 * decode.MIN_SPLIT_TILES)
    _check_decode(q, kc, vc, keys - 1)
    _check_decode(q, kc, vc, keys - 1, kn, vn)


def test_decode_attention_long_cache_and_misaligned_cache(cuda):
    q, kc, vc, kn, vn = _caches(4, 32768, 32, 32, 96, torch.bfloat16, 1, cuda)
    _check_decode(q, kc, vc, 32767, kn, vn)
    _check_decode(q, _shifted(kc, 2), vc, 32767, kn, vn)


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """Mixed types, shapes that do not fit and inputs that require grad
    raise before any launch."""
    q, k, v = _qkv(1, 16, 4, 2, 32, 32, torch.bfloat16, 0, cuda)
    qd, kc, vc, kn, vn = _caches(1, 16, 4, 2, 32, torch.bfloat16, 0, cuda)
    kw = dict(causal=True, q_chunk=8, scale=0.2)
    assert chunked.route(q, k, v) == "tma"
    calls = [
        lambda: chunked.chunked_attention(q, k.float(), v, **kw),
        lambda: chunked.chunked_attention(q, k[:, :, :1].expand(1, 16, 3, 32), v, **kw),
        lambda: chunked.chunked_attention(q.to(torch.float16), k, v, **kw),
        lambda: decode.decode_attention(qd, kc.float(), vc, 3, scale=0.2),
        lambda: decode.decode_attention(qd, kc, vc, 3, scale=0.2, k_new=kn),
        lambda: decode.decode_attention(qd, kc[:, :, :1], vc, 3, scale=0.2),
        lambda: decode.decode_attention(qd, kc, vc, -1, scale=0.2),
        lambda: decode.decode_attention(torch.cat([qd] * 16, dim=2), kc[:, :, :1], vc[:, :, :1], 3, scale=0.2),
    ]
    before = (chunked.chunked_attention.launches, decode.decode_attention.launches)
    for call in calls:
        with pytest.raises(ValueError):
            call()
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="item 18"):
        chunked.chunked_attention(qg, k, v, **kw)
    with pytest.raises(RuntimeError, match="item 18"):
        decode.decode_attention(qd.clone().requires_grad_(True), kc, vc, 3, scale=0.2, k_new=kn, v_new=vn)
    assert (chunked.chunked_attention.launches, decode.decode_attention.launches) == before


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "chatglm3-6b"])
def test_gqa_prefill_and_decode_on_cuda_match_cpu(cuda, arch):
    """A tiny float32 model's prefill and three decode steps on the card
    against the CPU's, logits within 1e-4 of their scale: one
    ``chunked_attention`` launch a layer a prefill, one ``decode_attention``
    a layer a step, in the model's mode (phi3 carries the new token,
    chatglm3 writes it into the cache first)."""
    from repro_torch import models

    cfg = get_config(arch, num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=128,
                     vocab_size=97, attn_q_chunk=8, init_std=0.5, dtype="float32")
    params = models.init_params(cfg, 4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (2, 11)))
    runs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        ca, de = chunked.chunked_attention, decode.decode_attention
        before = (ca.launches, de.launches, dict(de.launches_by_mode))
        logits, cache = models.prefill(p, {"tokens": tokens.to(dev)}, cfg)
        full = models.init_cache(cfg, 2, 32, device=dev)
        for dst, src in zip(models.model.cache_tensors(full), models.model.cache_tensors(cache)):
            dst[:, :, : src.shape[2]] = src
        cache = models.model.set_index(full, 11)
        outs = [logits]
        token = logits.argmax(-1)
        for _ in range(3):
            logits, cache = models.decode_step(p, token, cache, cfg)
            outs.append(logits)
            token = logits.argmax(-1)
        if dev != "cpu":
            torch.cuda.synchronize()
            mode = "incremental" if cfg.decode_cache_carry else "in_cache"
            assert (ca.launches - before[0], de.launches - before[1]) == (cfg.num_layers, 3 * cfg.num_layers)
            assert de.launches_by_mode[mode] - before[2][mode] == 3 * cfg.num_layers
        runs[str(dev)] = [o.cpu() for o in outs]
    for got, want in zip(runs[str(cuda)], runs["cpu"]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "chatglm3-6b"])
def test_gqa_bf16_prefill_and_decode_launch_counts(cuda, arch):
    """A tiny bf16 model's prefill and three decode steps on the card: one
    ``chunked_attention`` launch a layer on the tma route, one
    ``decode_attention`` a layer a step on the bf16 route in the model's
    mode, and finite logits."""
    from repro_torch import models

    cfg = get_config(arch, num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=128,
                     vocab_size=97, attn_q_chunk=8)
    assert cfg.param_dtype() == torch.bfloat16
    params = models.init_params(cfg, 4, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (2, 11))).to(cuda)
    ca, de = chunked.chunked_attention, decode.decode_attention
    before = (dict(ca.launches_by_route), dict(de.launches_by_route), dict(de.launches_by_mode))
    with torch.inference_mode():
        logits, cache = models.prefill(params, {"tokens": tokens}, cfg)
        full = models.init_cache(cfg, 2, 32, device=cuda)
        for dst, src in zip(models.model.cache_tensors(full), models.model.cache_tensors(cache)):
            dst[:, :, : src.shape[2]] = src
        cache = models.model.set_index(full, 11)
        outs = [logits]
        token = logits.argmax(-1)
        for _ in range(3):
            logits, cache = models.decode_step(params, token, cache, cfg)
            outs.append(logits)
            token = logits.argmax(-1)
    torch.cuda.synchronize()
    mode = "incremental" if cfg.decode_cache_carry else "in_cache"
    n = cfg.num_layers
    assert {p: ca.launches_by_route[p] - before[0][p] for p in before[0]} == {"tma": n, "mma": 0, "f32": 0}
    assert {p: de.launches_by_route[p] - before[1][p] for p in before[1]} == {"bf16": 3 * n, "f32": 0}
    assert {m: de.launches_by_mode[m] - before[2][m] for m in before[2]} == {
        "incremental": 3 * n * (mode == "incremental"), "in_cache": 3 * n * (mode == "in_cache")}
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)


@pytest.mark.parametrize("fn,n", [("bitpack", 8192), ("pack_bits_words", 8190)])
def test_bitpack_past_2_31_elements(cuda, fn, n):
    """A prefill of 8 x 32,768 rows of phi3's 8,192-wide FFN activations
    (bf16, the vec route) has 2^31 elements: the kernels' element offsets
    are 64-bit.  A ragged width of {0, 1} bits takes the scalar route."""
    m = (1 << 31) // n + 64
    if fn == "bitpack":
        x, thr = torch.randn((m, n), dtype=torch.bfloat16, device=cuda), 0
    else:
        x, thr = torch.randint(0, 2, (m, n), dtype=torch.int32, device=cuda), 1
    path = "vec" if n % 8 == 0 else "scalar"
    assert bitpack.route(x) == path
    wrapper = getattr(bitpack, fn)
    out = _launched(wrapper, path, lambda: wrapper(x))
    for rows in (slice(0, 64), slice(m // 2 - 32, m // 2 + 32), slice(m - 64, m)):
        assert torch.equal(out[rows], bitpack.pack_ge_plain(x[rows], thr))
