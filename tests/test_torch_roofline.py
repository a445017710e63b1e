"""Port roofline: ``repro_torch.roofline`` (the H100 peaks, each kernel's
compulsory bytes and operations, the dataplane dispatch bound) and its
``roofline.*`` gauges, on the CPU.

The kernel costs must give, from shapes and tables alone, the bounds that
``PERF.md`` records beside each kernel's time on the card; the dispatch
counts are held against a count made by hand; the gauges must carry the
reference's names and ``path`` labels, so ``tools/obs_report.py`` renders
them, and must not appear while observability is off.
"""
from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.configs.n2net_paper import HEADLINE
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core.pipeline import RMT
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import fleet as tfleet
from repro_torch.dataplane import plan as tplan
from repro_torch.kernels.optable_exec import make_plan
from repro_torch.roofline import dataplane as rdp
from repro_torch.roofline import hw
from repro_torch.roofline import kernels as rk

from repro import obs as jobs
from repro.core import compiler as jcompiler
from repro.dataplane import executor as jexec
from repro.dataplane import fleet as jfleet
from repro.dataplane import plan as jplan

CHUNK = 1 << 15
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _headline():
    """The headline model as ``chip_smoke.py`` builds it (generator seed 0)."""
    params = tbnn.init_params(HEADLINE, torch.Generator().manual_seed(0))
    return tcompiler.compile_bnn([w.numpy() for w in params], RMT).lower()


def _records(lp) -> int:
    return make_plan(lp.opcode, lp.dst, lp.src0, lp.src1, lp.imm0, lp.imm1, lp.mask, lp.first_write,
                     lp.num_regs).records.nbytes


def test_h100_peaks():
    assert hw.HBM_BYTES_PER_S == 3.35e12
    assert hw.INT32_OPS_PER_S == 64 * 132 * 1.98e9
    assert hw.POPC_PER_S == 16 * 132 * 1.98e9
    assert hw.BF16_TENSOR_FLOPS == 989e12
    assert hw.INT8_TENSOR_OPS == 1979e12


def test_kernel_costs_reproduce_the_recorded_bounds():
    """HEADLINE at chunk 32768 (the packet path), the 8-tenant pool's
    stacked layers, and phi3-mini-3.8b's decode layer, scoring flash and
    prefill GEMM: the bounds of ``PERF.md`` section 6, digit for digit."""
    lp = _headline()
    assert rk.optable_run(lp.num_regs, CHUNK, lp.num_ops, _records(lp)).bound_ms() == (
        0.01861818181818182, "operations")
    assert rk.total(rk.packed_layer(CHUNK, pl.n_words, pl.n_out) for pl in lp.packed.layers).bound_ms() == (
        0.0038738913432835825, "bytes")
    assert rk.total(rk.bitpack(CHUNK, pl.n_in) for pl in lp.packed.layers).bound_ms() == (
        0.0038734710447761193, "bytes")
    # benchmarks/multitenant_bench.py's first eight tenants, stacked.
    shapes = ((32, 64, 32), (16, 32, 8), (32, 16), (8, 12, 6), (16, 8, 4), (32, 32, 4))
    lowereds = []
    for i in range(8):
        params = tbnn.init_params(tbnn.BnnSpec(shapes[i % 6]), torch.Generator().manual_seed(i))
        lowereds.append(tcompiler.compile_bnn([w.numpy() for w in params]).lower())
    stack = texec.stack_tenant_layers(lowereds)
    assert rk.total(rk.packed_layer_routed(CHUNK, nw, *w.shape[:2]) for w, _, _, nw in stack).bound_ms() == (
        0.003955085373134328, "bytes")
    # phi3-mini-3.8b: d_model 3072, 32 heads x 96 (32 kv heads), d_ff 8192;
    # one decode layer's seven projections at M = 4.
    projections = ((3072, 3072, 1), (3072, 3072, 2), (3072, 3072, 1), (3072, 8192, 2), (8192, 3072, 1))
    assert rk.total(per * rk.bnn_matmul_packed(4, n, k // 32) for k, n, per in projections).bound_ms() == (
        0.004381191641791045, "bytes")
    assert rk.bnn_matmul_mxu(2048, 3072, 8192).bound_ms() == (0.10422569777957533, "operations")
    assert rk.flash_attention(32, 2048, 96).bound_ms() == (0.026056424444893832, "operations")
    # hubert-xlarge's scoring layer: 16 heads x 80, full (bidirectional)
    # attention counts both products over every pair, twice the causal half
    assert rk.flash_attention(16, 2048, 80, causal=False).bound_ms() == (0.021713687037411528, "operations")
    assert rk.flash_attention(16, 2048, 80, causal=False).ops == 2 * rk.flash_attention(16, 2048, 80).ops
    with pytest.raises(ValueError, match="rates"):
        rk.packed_layer(1, 1, 1) + rk.bnn_matmul_packed(1, 1, 1)


@pytest.mark.parametrize("m,bound", [
    (128, (0.014649332616472966, "operations")),    # a prefill layer
    (2048, (0.23438932186356745, "operations")),    # a scoring layer
])
def test_packed_gemm_counts_int8_tensor_operations(m, bound):
    """The packed GEMM's operations are 2 M N Kw 32 int8 multiply-adds at
    the tensor cores' rate, whatever route a launch takes: phi3-mini-3.8b's
    seven projections (113.2 M weight bits a layer) at a prefill's and a
    scoring pass's M.  Its bytes, and so the decode bound, do not change."""
    cost = rk.bnn_matmul_packed(m, 3072, 96)
    assert (cost.ops, cost.rate) == (2 * m * 3072 * 96 * 32, hw.INT8_TENSOR_OPS)
    assert cost.bytes == (m * 96 + 3072 * 96 + m * 3072) * 4
    projections = ((3072, 3072, 4), (3072, 8192, 2), (8192, 3072, 1))
    assert sum(per * n * k for k, n, per in projections) == 113_246_208
    assert rk.total(per * rk.bnn_matmul_packed(m, n, k // 32) for k, n, per in projections).bound_ms() == bound
    experts = rk.bnn_matmul_packed_experts(128, 160, 768, 64)
    assert (experts.ops, experts.rate) == (2 * 128 * 160 * 768 * 64 * 32, hw.INT8_TENSOR_OPS)


def test_attention_costs_by_hand():
    """``chunked_attention``: q, k, v and out once, 2 (Dqk + Dv) operations
    a (query, key) pair of each head, S (S + 1) / 2 causal pairs, at the bf16
    tensor cores' rate (float32: the CUDA cores'); phi3-mini-3.8b's
    prefill_32k layer is 1.32e13 operations at batch 2, 13.3 ms.
    ``decode_attention``: q and out, and each of the keys' K and V rows of
    every (batch, KV head) once; float32 operations on the CUDA cores, so
    bytes bound it: phi3's decode_32k layer reads 1.61 GB, 0.48 ms."""
    assert [rk.causal_pairs(s, s) for s in (1, 2, 5)] == [1, 3, 15]
    assert rk.causal_pairs(5, 3) == 1 + 2 + 3 + 3 + 3 and rk.causal_pairs(3, 5) == 6
    c = rk.chunked_attention(2, 32768, 32768, 32, 32, 96, 96, True)
    assert c.ops == 2 * 2 * 2 * 32 * (32768 * 32769 // 2) * 96 and c.rate == hw.BF16_TENSOR_FLOPS
    assert c.bytes == 2 * 32768 * (32 + 32) * (96 + 96) * 2
    assert abs(c.ops - 1.32e13) < 0.01e13 and c.bound_ms()[1] == "operations"
    assert abs(c.bound_ms()[0] - 13.34) < 0.01
    # MLA (deepseek-v2): Dqk 192, Dv 128, 128 heads reading their own K, V
    mla = rk.chunked_attention(1, 2048, 2048, 128, 128, 192, 128, False)
    assert mla.ops == 2 * 128 * 2048 * 2048 * (192 + 128)
    assert mla.bytes == (2048 * 128 * 320 + 2048 * 128 * 320) * 2
    f32 = rk.chunked_attention(1, 64, 64, 4, 2, 16, 16, True, itemsize=4)
    assert f32.rate == hw.FP32_FLOPS and f32.bytes == (64 * 4 * 32 + 64 * 2 * 32) * 4
    d = rk.decode_attention(4, 32768, 32, 32, 96, 96)
    assert d.bytes == (4 * 32 * 192 + 4 * 32768 * 32 * 192) * 2 and d.rate == hw.FP32_FLOPS
    assert d.ops == 2 * 4 * 32 * 32768 * 192
    assert d.bound_ms()[1] == "bytes" and abs(d.bound_ms()[0] - 0.481) < 0.001
    # GQA reads each K and V row once for its G query heads
    g = rk.decode_attention(4, 2048, 32, 2, 128, 128)
    assert g.bytes == (4 * 32 * 256 + 4 * 2048 * 2 * 256) * 2


def _small():
    rng = np.random.default_rng(3)
    sizes = (16, 8, 4)
    params = [rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32) for i in range(2)]
    return params, tcompiler.compile_bnn(params).lower()


def test_dispatch_counts_by_hand():
    """A (16, 8, 4) program, one dispatch of 10 packets."""
    _, lp = _small()
    io = 10 * (16 + 4) * 4                          # packet bits in, output bits out
    # Packed: per layer the pack (a compare a bit) and the layer, whose 5
    # operations a word and compare a neuron hold one popcount a word.
    tables = (8 * 1 * 4 * 2 + 8 * 4) + (4 * 1 * 4 * 2 + 4 * 4)  # weights, masks, thresholds
    ints = (10 * 16 + 10 * 8 * 6 - 10 * 8) + (10 * 8 + 10 * 4 * 6 - 10 * 4)
    assert rdp.dispatch_counts(lp, "packed", 10) == (io + tables, ints, 10 * 8 + 10 * 4)
    # The scan plan: both layers padded to 8 bits in, 1 word, 8 neurons.
    tables = 2 * (8 * 1 * 4 * 2 + 8 * 4)
    ints = 2 * (10 * 16 + 10 * 8 * 6 - 10 * 8)
    assert rdp.dispatch_counts(lp, "packed", 10, scan_hops=True) == (io + tables, ints, 2 * 10 * 8)
    # Op-table: the plan's records and the parse / deparse tables; three
    # operations a true row, a shift and an add a bit in, a shift and a
    # mask a bit out.
    nbytes = io + _records(lp) + 16 * 16 + 12 * 4
    assert rdp.dispatch_counts(lp, "jnp", 10) == (nbytes, 3 * lp.num_ops * 10 + 10 * 2 * (16 + 4), 0)

    rf = rdp.probe_fleet(lp, backend="packed", streams=4, chunk=16)
    nbytes, ints, popc = rdp.dispatch_counts(lp, "packed", 64)
    assert (rf.path, rf.packets, rf.hlo_bytes, rf.hlo_flops) == ("fleet4:packed", 64, nbytes, ints + popc)
    times = {"bytes": nbytes / hw.HBM_BYTES_PER_S, "int32": ints / hw.INT32_OPS_PER_S,
             "popcount": popc / hw.POPC_PER_S}
    assert rf.step_time_s == max(times.values()) and rf.bottleneck == max(times, key=times.get)
    assert rf.roofline_pps == 64 / rf.step_time_s and rf.bytes_per_packet == nbytes / 64
    assert rf.fraction(rf.roofline_pps / 4) == pytest.approx(0.25) and rf.fraction(0.0) == 0.0
    assert rdp.probe_stream(lp, backend="pallas", chunk=16).path == "jnp"
    assert rdp.probe_stream(lp, backend="packed", chunk=16, scan_hops=True).path == "packed+scan"


def _roofline_gauges(registry) -> dict:
    return {(row["name"], row["labels"]["path"]): row["value"] for row in registry.snapshot()
            if row["name"].startswith("roofline.")}


def _drive(execute_stream, execute_fleet, lp, ExecutionPlan, **kw):
    x = np.random.default_rng(5).integers(0, 2, (64, 16)).astype(np.int32)
    for backend, scan in (("packed", False), ("jnp", False), ("packed", True)):
        execute_stream(lp, iter([x]), backend=backend, chunk_size=32, scan_hops=scan, **kw)
    execute_fleet(lp, x, plan=ExecutionPlan(backend="packed", fleet=4, chunk_size=16), **kw)


def test_gauges_carry_the_reference_names_and_only_when_obs_is_on():
    params, lp = _small()
    tobs.reset()
    _drive(texec.execute_stream, tfleet.execute_fleet, lp, tplan.ExecutionPlan, device="cpu")
    assert not _roofline_gauges(tobs.registry())
    tobs.enable(reset=True)
    jobs.enable(reset=True)
    try:
        _drive(texec.execute_stream, tfleet.execute_fleet, lp, tplan.ExecutionPlan, device="cpu")
        _drive(jexec.execute_stream, jfleet.execute_fleet, jcompiler.compile_bnn(params).lower(),
               jplan.ExecutionPlan)
        got, want = _roofline_gauges(tobs.registry()), _roofline_gauges(jobs.registry())
    finally:
        # Off and emptied: the captured spans would otherwise outlive this
        # test in both packages' global tracers.
        tobs.disable()
        tobs.reset()
        jobs.disable()
        jobs.reset()
    assert set(got) == set(want)
    assert {path for _, path in got} == {"packed", "jnp", "packed+scan", "fleet4:packed"}
    for (name, path), value in got.items():
        assert value > 0, (name, path)
        if name == "roofline.fraction":
            assert value <= 1
    rf = rdp.probe_fleet(lp, backend="packed", streams=4, chunk=16)
    assert got["roofline.pps_bound", "fleet4:packed"] == rf.roofline_pps
    assert got["roofline.hlo_bytes", "fleet4:packed"] == rf.hlo_bytes


def test_export_all_renders_in_obs_report(tmp_path):
    _, lp = _small()
    tobs.enable(reset=True)
    try:
        _drive(texec.execute_stream, tfleet.execute_fleet, lp, tplan.ExecutionPlan, device="cpu")
        paths = tobs.export_all(str(tmp_path), prefix="port")
    finally:
        tobs.disable()
        tobs.reset()
    spec = importlib.util.spec_from_file_location("obs_report", os.path.join(ROOT, "tools", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    metrics = report.load_metrics(paths["metrics_jsonl"])
    table = report.roofline_table(metrics)
    assert [row["path"] for row in table] == ["fleet4:packed", "jnp", "packed", "packed+scan"]
    for row in table:
        assert {"pps_bound", "fraction", "bytes_per_packet", "hlo_bytes", "hlo_flops"} <= set(row)
    text = report.render(metrics, report.load_trace(paths["trace"]))
    assert "hardware utilization (roofline.*)" in text and "fleet4:packed" in text
    with open(paths["trace"]) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert {"stream:fleet_run", "compile:fleet_chunk", "execute:fleet_chunk"} <= names
    assert open(paths["metrics_prom"]).read().count("roofline_pps_bound{") == 4


@pytest.mark.parametrize("arch,layers,per_launch,step,weights_alone", [
    ("qwen3-moe-30b-a3b", 48, (0.007639345671641792, 0.007828862089552238),
     1.1091625647761194, 1.0817548226865672),
    ("deepseek-v2-236b", 60, (0.04727517611940299, 0.047938483582089554),
     8.549330149253732, 8.451209552238806),
])
def test_expert_gemm_bounds_per_decode_step(arch, layers, per_launch, step, weights_alone):
    """The batched packed expert GEMM at a decode step of the ``Engine``'s 4
    slots (capacity 1): a layer's gate and up launches (E, 1, f) x (E, f,
    d/32) and its down launch (E, 1, d) x (E, d, f/32), from the published
    shapes alone.  Each launch is bound by its expert weights (qwen3:
    25.2 MB, deepseek: 157 MB); the weights alone, 3 * E * f * d / 8 bytes
    a layer, give 1.08 and 8.45 ms a step."""
    from repro_torch.configs.base import get_config
    from repro_torch.layers.moe import capacity_of

    cfg = get_config(arch)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ffn_dim
    assert cfg.num_layers == layers
    c = capacity_of(4, cfg)
    assert c == 1
    gate = rk.bnn_matmul_packed_experts(e, c, f, d // 32)
    down = rk.bnn_matmul_packed_experts(e, c, d, f // 32)
    assert (gate.bound_ms(), down.bound_ms()) == ((per_launch[0], "bytes"), (per_launch[1], "bytes"))
    assert (rk.total([gate, gate, down]) * layers).bound_ms() == (step, "bytes")
    assert (rk.Cost(3 * e * f * d // 8, 0) * layers).bound_ms() == (weights_alone, "bytes")
    assert e * f * (d // 32) * 4 == e * d * (f // 32) * 4 == {48: 25_165_824, 60: 157_286_400}[layers]
