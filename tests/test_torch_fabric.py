"""Port fabric: ``repro_torch.dataplane.fabric.SwitchFabric`` and the modules
it brings (``lowering.stack_hops``, ``executor.run_hops_scanned``,
``dataplane.plan``, ``dataplane.telemetry``, ``core.throughput``,
``obs.windows``, ``obs.slo``) against the reference's, on the CPU.

Programs: HEADLINE and ``tests/strategies.py`` cases, partitioned onto tiny
chips (8 and 9 elements) so that every fabric has several hops and a short
last hop padded with whole no-op elements.  Bits, tables and hop ranges are
compared with ``assert_array_equal``; telemetry and reports field by field,
except the measured rates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from strategies import ProgramCase, build_case, given, packets_for, program_cases, settings

from repro_torch import obs as tobs
from repro_torch.configs import n2net_paper as tpaper
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipe
from repro_torch.core import throughput as tthr
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import fabric as tfab
from repro_torch.dataplane import lowering as tlow
from repro_torch.dataplane import plan as tplan
from repro_torch.dataplane import telemetry as ttel
from repro_torch.obs import slo as tslo
from repro_torch.obs import windows as twin

from repro.core import bnn as jbnn
from repro.core import compiler as jcompiler
from repro.core import pipeline as jpipe
from repro.core import throughput as jthr
from repro.dataplane import fabric as jfab
from repro.dataplane import plan as jplan
from repro.dataplane import telemetry as jtel
from repro.obs import slo as jslo
from repro.obs import windows as jwin

STACKED = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")
CPU = torch.device("cpu")


def _programs(params, thresholds=None):
    """The port's and the reference's programs of the same weights."""
    return (tcompiler.compile_bnn(params, thresholds=thresholds),
            jcompiler.compile_bnn(params, thresholds=thresholds))


def _headline():
    rng = np.random.default_rng(0)
    sizes = tpaper.HEADLINE.layer_sizes
    params = [rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32) for i in range(2)]
    return params, *_programs(params)


def _fabrics(tprog, jprog, mode, elements):
    return (tfab.SwitchFabric.partition(tprog, mode=mode, chip=tpipe.ChipSpec(num_elements=elements)),
            jfab.SwitchFabric.partition(jprog, mode=mode, chip=jpipe.ChipSpec(num_elements=elements)))


def _fields(obj, skip=()):
    """A (nested) dataclass as a dict, for comparing the two packages'
    equal-shaped dataclasses."""
    d = dataclasses.asdict(obj)
    for k in skip:
        d.pop(k, None)
    return d


# -- copied numpy-only modules -------------------------------------------------

@pytest.mark.parametrize("spec", [tpaper.HEADLINE, tpaper.FIVE_TUPLE], ids=str)
def test_throughput_matches_reference(spec):
    params, tprog, jprog = _headline() if spec is tpaper.HEADLINE else (None, None, None)
    jspec = jbnn.BnnSpec(spec.layer_sizes)
    for chip, jchip in ((tpipe.RMT, jpipe.RMT), (tpipe.RMT_NATIVE_POPCNT, jpipe.RMT_NATIVE_POPCNT)):
        assert tthr.analytic_elements(spec, chip) == jthr.analytic_elements(jspec, jchip)
        assert _fields(tthr.report_for_spec(spec, chip)) == _fields(jthr.report_for_spec(jspec, jchip))
        for n_act in (32, 64, 2048):
            assert tthr.neuron_rate(n_act, chip) == jthr.neuron_rate(n_act, jchip)
    if tprog is not None:
        t, j = tthr.report_for_program(tprog), jthr.report_for_program(jprog)
        assert _fields(t) == _fields(j) and t.csv() == j.csv()


def test_windows_and_slo_match_reference():
    """The same observations at the same explicit times give the same
    windows, quantiles, burn rates and breach events."""
    rng = np.random.default_rng(1)
    times = np.sort(rng.uniform(0.0, 10.0, 400))
    values = rng.exponential(2e-3, 400)
    rates = (twin.WindowedRate(2.0, buckets=8), jwin.WindowedRate(2.0, buckets=8))
    hists = (twin.WindowedHistogram(2.0, buckets=8), jwin.WindowedHistogram(2.0, buckets=8))
    spec = dict(tenant="t", p99_queue_delay_s=3e-3, min_pps=30.0, window_s=2.0)
    trackers = (tslo.SloTracker(tslo.SloSpec(**spec), buckets=8),
                jslo.SloTracker(jslo.SloSpec(**spec), buckets=8))
    for i, (t, v) in enumerate(zip(times, values)):
        for r in rates:
            r.add(t)
        for h in hists:
            h.observe(t, v)
        for tr in trackers:
            tr.observe_queue_delay(t, v)
            tr.observe_packets(t, 1)
        if i % 50 == 49:
            assert rates[0].rate(t) == rates[1].rate(t)
            assert rates[0].count(t) == rates[1].count(t)
            assert hists[0].count(t) == hists[1].count(t)
            for q in (0.5, 0.99):
                assert hists[0].quantile(t, q) == hists[1].quantile(t, q)
            a, b = (tr.update(t) for tr in trackers)
            assert [_fields(e) for e in a] == [_fields(e) for e in b]
            assert _fields(trackers[0].status(t)) == _fields(trackers[1].status(t))
    assert [_fields(e) for e in trackers[0].events] == [_fields(e) for e in trackers[1].events]
    assert trackers[0].events, "the schedule above should breach at least once"


@pytest.mark.parametrize("mode", tfab.MODES)
def test_telemetry_matches_reference(mode):
    _, tprog, jprog = _headline()
    assert [_fields(s) for s in ttel.stage_telemetry(tprog)] == [
        _fields(s) for s in jtel.stage_telemetry(jprog)]
    ranges = [(0, 10), (10, 20), (20, len(tprog.elements))]
    t = ttel.fabric_telemetry(tprog, mode, ranges, hop_pps=[1.0, 2.0, 3.0], measured_pps=4.0)
    j = jtel.fabric_telemetry(jprog, mode, ranges, hop_pps=[1.0, 2.0, 3.0], measured_pps=4.0)
    assert _fields(t) == _fields(j) and t.render() == j.render()


# -- stack_hops and run_hops_scanned ------------------------------------------

@pytest.mark.parametrize("elements", [8, 9])
def test_stack_hops_matches_reference(elements):
    _, tprog, jprog = _headline()
    tf, jf = _fabrics(tprog, jprog, "multi_hop", elements)
    assert [h.element_range for h in tf.hops] == [h.element_range for h in jf.hops]
    ts, js = tf.stacked_hops(), jf.stacked_hops()
    assert (ts.fingerprint, ts.num_hops, ts.elements_per_hop, ts.num_regs, ts.used) == (
        js.fingerprint, js.num_hops, js.elements_per_hop, js.num_regs, js.used)
    for name in STACKED:
        a, b = getattr(ts, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the last hop is short: its tail is whole pad elements
    short = ts.elements_per_hop - (tf.hops[-1].element_range[1] - tf.hops[-1].element_range[0])
    assert short > 0
    assert (ts.mask[-1, -short:] == 0).all() and (ts.first_write[-1, -short:] == 1).all()
    assert tlow.stack_hops([]) is None
    odd = tcompiler.compile_bnn([np.ones((3, 5), np.int32)]).lower()
    assert tlow.stack_hops([tf.hops[0].lowered, odd]) is None


def test_run_hops_scanned_equals_run_hop_per_hop():
    params, tprog, jprog = _headline()
    tf, _ = _fabrics(tprog, jprog, "multi_hop", 9)
    lp = tf.lowered
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 2, (37, 32)).astype(np.int32))
    t = texec._device_tables(lp, CPU)
    regs = texec.parse_packets(x, *t.io[:2], num_regs=lp.num_regs)
    unrolled = regs
    for hop in tf.hops:
        unrolled = texec.run_hop(hop.lowered, unrolled)
    stacked = tf.stacked_hops()
    scanned = texec.run_hops_scanned(stacked, regs)
    assert torch.equal(scanned, unrolled)
    assert torch.equal(scanned, texec.run_hop(lp, regs))
    # one set of table tensors per chain and device, reused by every call
    first = texec._stacked_tables(stacked, CPU)
    assert texec._stacked_tables(stacked, CPU) is first and len(first) == tf.num_hops
    with pytest.raises(ValueError, match="packed"):
        texec.run_hops_scanned(stacked, regs, backend="packed")
    with pytest.raises(ValueError, match="registers"):
        texec.run_hops_scanned(stacked, regs[:-1])


# -- SwitchFabric.run against the reference ------------------------------------

# (backend, scan_hops) paths of the port's fabric.
PATHS = [("jnp", None), ("jnp", True), ("jnp", False), ("pallas", None), ("packed", None)]


@pytest.mark.parametrize("elements", [8, 9])
@pytest.mark.parametrize("mode", tfab.MODES)
def test_fabric_run_matches_reference_on_headline(mode, elements):
    params, tprog, jprog = _headline()
    tf, jf = _fabrics(tprog, jprog, mode, elements)
    x = np.random.default_rng(3).integers(0, 2, (211, 32)).astype(np.int32)
    jres = jf.run(x, chunk_size=100)
    want = jres.outputs
    np.testing.assert_array_equal(want, np.asarray(jbnn.forward(params, x)))
    for backend, scan_hops in PATHS:
        res = tf.run(x, backend=backend, scan_hops=scan_hops, chunk_size=100, device="cpu")
        np.testing.assert_array_equal(res.outputs, want, err_msg=f"{backend} scan_hops={scan_hops}")
        assert res.outputs.dtype == np.int32 and res.packets == 211
        assert res.scanned == (scan_hops is not False)
        assert len(res.hop_seconds) == tf.num_hops and all(s > 0 for s in res.hop_seconds)
        assert res.seconds > 0 and res.warmup_seconds > 0
    assert _fields(tf.analytic_report()) == _fields(jf.analytic_report())
    skip = ("measured_pps",)
    ttl, jtl = tf.telemetry(), jf.telemetry()
    assert _fields(ttl.analytic) == _fields(jtl.analytic)
    assert [_fields(s) for s in ttl.stages] == [_fields(s) for s in jtl.stages]
    assert [_fields(h, skip) for h in ttl.hops] == [_fields(h, skip) for h in jtl.hops]
    assert (ttl.mode, ttl.chip_name, ttl.peak_occupancy_bits, ttl.phv_utilization) == (
        jtl.mode, jtl.chip_name, jtl.peak_occupancy_bits, jtl.phv_utilization)
    assert ttl.measured_pps > 0 and all(h.measured_pps > 0 for h in ttl.hops)


@given(program_cases(max_layers=2, max_width=24))
@settings(max_examples=4)
def test_fabric_run_matches_reference_on_random_programs(case: ProgramCase):
    built = build_case(case)
    tprog, _ = _programs(built.params, built.thresholds)
    per_hop = max(1, -(-built.lowered.num_elements // 3))
    jf = jfab.SwitchFabric.partition(built.program, chip=jpipe.ChipSpec(num_elements=per_hop))
    tf = tfab.SwitchFabric.partition(tprog, chip=tpipe.ChipSpec(num_elements=per_hop))
    assert [h.element_range for h in tf.hops] == [h.element_range for h in jf.hops]
    x = packets_for(case, seed=case.weight_seed ^ 0xFAB, n=30)
    want = jf.run(x, scan_hops=False).outputs
    for backend, scan_hops in PATHS:
        got = tf.run(x, backend=backend, scan_hops=scan_hops, device="cpu").outputs
        np.testing.assert_array_equal(got, want, err_msg=f"{backend} scan_hops={scan_hops}")


def test_fabric_spans_metrics_and_errors():
    _, tprog, jprog = _headline()
    tf, _ = _fabrics(tprog, jprog, "multi_hop", 8)
    x = np.random.default_rng(4).integers(0, 2, (50, 32)).astype(np.int32)
    tobs.enable(reset=True)
    try:
        tf.run(x, scan_hops=False, chunk_size=20, device="cpu")
        tf.run(x, chunk_size=20, device="cpu")
        reg = tobs.registry()
        assert reg.counter("fabric.packets_total").value == 100
        assert reg.histogram("fabric.chunk_seconds").count == 6
        for hop in range(tf.num_hops):
            assert reg.histogram("fabric.hop_seconds", hop=str(hop)).count == 6
        names = {s.name for s in tobs.tracer().records}
        assert {"stream:fabric_run", "compile:fabric_chain", "execute:fabric_chunk",
                "compile:hop", "execute:hop"} <= names
    finally:
        tobs.disable()
        tobs.reset()
    with pytest.raises(ValueError, match="packed"):
        tf.run(x, backend="packed", scan_hops=False, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tf.run(x[:, :5], device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tfab.SwitchFabric.partition(tprog, mode="teleport")
    assert tfab.SwitchFabric.partition(tprog).num_hops == 1  # HEADLINE fits the RMT chip


# -- dataplane.plan --------------------------------------------------------------

def test_plan_run_gives_the_direct_calls_answers():
    params, tprog, jprog = _headline()
    lp = tprog.lower()
    x = np.random.default_rng(5).integers(0, 2, (40, 32)).astype(np.int32)
    want = texec.execute(lp, x, device="cpu")
    P = tplan.ExecutionPlan
    np.testing.assert_array_equal(tplan.run(lp, x, plan=P(backend=tplan.Backend.PACKED), device="cpu"), want)
    np.testing.assert_array_equal(tplan.run(tprog, x, plan=P(backend="pallas"), device="cpu"), want)
    sres = tplan.run(tprog, iter([x[:25], x[25:]]),
                     plan=P(backend="jnp", chunk_size=16, collect=True), device="cpu")
    np.testing.assert_array_equal(sres.outputs, want)
    np.testing.assert_array_equal(
        tplan.run(tprog, x, plan=P(backend=tplan.Backend.INTERPRETER), device="cpu"), want)
    with pytest.raises(ValueError, match="un-lowered"):
        tplan.run(lp, x, plan=P(backend=tplan.Backend.INTERPRETER), device="cpu")
    tf, _ = _fabrics(tprog, jprog, "recirculate", 9)
    for scan in (None, False):
        fres = tplan.run(tf, x, plan=P(backend="jnp", scan_hops=scan, interpret=True), device="cpu")
        np.testing.assert_array_equal(fres.outputs, want)
        assert fres.scanned == (scan is None)
    with pytest.raises(ValueError, match="fabric form"):
        tplan.run(tf, x, plan=P(backend="interpreter"), device="cpu")
    # A fleet plan replicates a program's packets to every stream, as the
    # reference's does; a fabric ignores it, as the reference's does.
    jlp = jprog.lower()
    for fleet_of in (lp, tprog):
        fres = tplan.run(fleet_of, x, plan=P(fleet=2, chunk_size=16, collect=True), device="cpu")
        jres = jplan.run(jlp, x, plan=jplan.ExecutionPlan(fleet=2, chunk_size=16, collect=True))
        assert (fres.streams, fres.packets, fres.chunks) == (jres.streams, jres.packets, jres.chunks) == (2, 80, 3)
        for got, ref in zip(fres.outputs, jres.outputs):
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tplan.run(tf, x, plan=P(fleet=2), device="cpu").outputs, want)
    np.testing.assert_array_equal(tf.run(x, plan=P(fleet=1, devices=3), device="cpu").outputs, want)
    with pytest.raises(TypeError, match="SwitchScheduler"):
        tplan.run(object(), x, device="cpu")


def test_backend_members_resolve_as_their_strings():
    B = tplan.Backend
    assert B.coerce("fused") is B.FUSED and B.coerce(B.PACKED) is B.PACKED
    assert tplan.ExecutionPlan(backend="packed").backend is B.PACKED
    assert [texec.resolve_backend(b) for b in (B.AUTO, B.FUSED, B.PALLAS, B.PACKED)] == [
        "jnp", "jnp", "jnp", "packed"]
    with pytest.raises(ValueError, match="reference path"):
        texec.resolve_backend(B.INTERPRETER)
    for bad in ("cuda", None):
        with pytest.raises(ValueError, match="unknown backend"):
            B.coerce(bad)
        with pytest.raises(ValueError, match="unknown backend"):
            texec.resolve_backend(bad)
    for bad in (dict(fleet=0), dict(chunk_size=0), dict(devices=0)):
        with pytest.raises(ValueError):
            tplan.ExecutionPlan(**bad)
    # ``devices`` is validated as in the reference (a fleet refuses more than
    # one GPU when it runs); the scheduler's merged-table layout too.
    assert tplan.ExecutionPlan(devices=4).devices == jplan.ExecutionPlan(devices=4).devices == 4
    assert tplan.ExecutionPlan(merged="concat").merged == "concat"
    with pytest.raises(ValueError, match="merged"):
        tplan.ExecutionPlan(merged="stacked")
