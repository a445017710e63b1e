"""Port fleets: ``repro_torch.dataplane.fleet`` (``execute_fleet``,
``fleet_blocks``), ``plan.run`` with ``fleet``, ``dataplane.factory``
(``build_fleet``) and ``serving.engine.FleetEngine`` with its ``health()``
snapshot, against the reference's, on the CPU.

The same numpy streams go through both packages: distinct streams of
unequal length (some exhausted blocks before the others, one empty), so a
fold that mixed, permuted or misaligned streams would show.  Outputs,
per-stream counts and bit counts are compared with ``assert_array_equal``;
health snapshots field by field under the same fake clock, except the
wall-clock ``overlap_ratio``, the live ``queue_depth`` and the roofline
fields (the port costs its dispatch differently, ``test_torch_roofline``).
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import factory as tfac
from repro_torch.dataplane import fabric as tfab
from repro_torch.dataplane import fleet as tfleet
from repro_torch.dataplane import multitenant as tmt
from repro_torch.dataplane import plan as tplan
from repro_torch.obs import slo as tslo
from repro_torch.serving import engine as teng
from strategies import ProgramCase, build_case, fleet_plans, given, packets_for, program_cases, settings

from repro.core import bnn as jbnn
from repro.core import compiler as jcompiler
from repro.core import pipeline as jpipe
from repro.dataplane import factory as jfac
from repro.dataplane import fabric as jfab
from repro.dataplane import fleet as jfleet
from repro.dataplane import multitenant as jmt
from repro.dataplane import plan as jplan
from repro.obs import slo as jslo
from repro.serving import engine as jeng


def _streams(case: ProgramCase, lengths, seed: int) -> list[np.ndarray]:
    """Distinct streams (seeded by index) of the given lengths."""
    return [packets_for(case, seed=seed + 7 * i, n=n) for i, n in enumerate(lengths)]


def _same_fleet(got, want, collect=True):
    assert (got.streams, got.packets, got.chunks) == (want.streams, want.packets, want.chunks)
    np.testing.assert_array_equal(got.per_stream_packets, want.per_stream_packets)
    np.testing.assert_array_equal(got.bit_counts, want.bit_counts)
    if collect:
        assert len(got.outputs) == len(want.outputs)
        for i, (a, b) in enumerate(zip(got.outputs, want.outputs)):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f"stream {i}")


def _small():
    built = build_case(ProgramCase((16, 24, 8), 3, "per_neuron", 5))
    return built, tcompiler.compile_bnn(built.params, thresholds=built.thresholds)


@given(program_cases(max_layers=2, max_width=24), fleet_plans(max_streams=6, max_packets=60, max_chunk=16))
@settings(max_examples=3)
def test_execute_fleet_matches_reference_on_random_programs(case: ProgramCase, fleet_plan):
    """Ragged distinct streams plus an empty one, on both backends and both
    packed plans: outputs, per-stream packets, bit counts and chunks equal
    the reference's."""
    lengths, chunk, seed = fleet_plan
    built = build_case(case)
    tlp = tcompiler.compile_bnn(built.params, thresholds=built.thresholds).lower()
    streams = _streams(case, (*lengths, 0), seed)
    for backend, scan_hops in (("jnp", False), ("packed", False), ("packed", True)):
        want = jfleet.execute_fleet(built.lowered, streams, plan=jplan.ExecutionPlan(
            backend=backend, chunk_size=chunk, scan_hops=scan_hops, collect=True))
        got = tfleet.execute_fleet(tlp, streams, plan=tplan.ExecutionPlan(
            backend=backend, chunk_size=chunk, scan_hops=scan_hops, collect=True), device="cpu")
        _same_fleet(got, want)
        assert got.devices == 1 and got.backend == want.backend


def test_fleet_blocks_match_reference():
    rng = np.random.default_rng(0)
    streams = [rng.integers(0, 2, (n, 16)).astype(np.int32) for n in (10, 3, 0, 7, 4)]
    # Chunk iterators of their own chunking, re-sliced to the fleet's.
    chunked = [[s[:2], s[2:5], s[5:]] for s in streams]
    got = list(tfleet.fleet_blocks(chunked, 4, 16))
    want = list(jfleet.fleet_blocks([[s[:2], s[2:5], s[5:]] for s in streams], 4, 16))
    assert len(got) == len(want) == 3
    for (gb, gv), (wb, wv) in zip(got, want):
        assert gb.dtype == wb.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gv, wv)


def test_fleet_of_3d_and_replicated_2d_arrays():
    built, tprog = _small()
    x = packets_for(built.case, seed=2, n=33)
    cube = np.stack([packets_for(built.case, seed=10 + i, n=21) for i in range(3)])
    for streams, fleet in ((x, 4), (cube, None), ([x], 2)):
        kw = dict(backend="packed", fleet=fleet, chunk_size=8, collect=True)
        want = jfleet.execute_fleet(built.lowered, streams, plan=jplan.ExecutionPlan(**kw))
        for devices in (None, 1):
            got = tfleet.execute_fleet(tprog, streams, plan=tplan.ExecutionPlan(devices=devices, **kw),
                                       device="cpu")
            _same_fleet(got, want)
    with pytest.raises(ValueError, match="one GPU"):
        tfleet.execute_fleet(tprog, [x, x], plan=tplan.ExecutionPlan(devices=2), device="cpu")
    with pytest.raises(ValueError, match="plan.fleet"):
        tfleet.execute_fleet(tprog, x, device="cpu")
    with pytest.raises(ValueError, match="3 streams"):
        tfleet.execute_fleet(tprog, [x, x, x], plan=tplan.ExecutionPlan(fleet=2), device="cpu")
    with pytest.raises(ValueError, match="devices"):
        tplan.ExecutionPlan(devices=0)


def test_plan_run_with_fleet_on_program_fabric_and_scheduler():
    """A fleet plan runs a program's streams through ``execute_fleet``; a
    fabric and a scheduler ignore it, as the reference's do."""
    built, tprog = _small()
    x = packets_for(built.case, seed=4, n=40)
    for backend in ("jnp", "packed"):
        kw = dict(backend=backend, fleet=3, chunk_size=8, collect=True)
        want = jplan.run(built.lowered, x, plan=jplan.ExecutionPlan(**kw))
        got = tplan.run(tprog.lower(), x, plan=tplan.ExecutionPlan(**kw), device="cpu")
        assert isinstance(got, tfleet.FleetRunResult)
        _same_fleet(got, want)
        streams = _streams(built.case, (40, 9, 0), 3)
        _same_fleet(tplan.run(tprog, streams, plan=tplan.ExecutionPlan(**kw), device="cpu"),
                    jplan.run(built.program, streams, plan=jplan.ExecutionPlan(**kw)))

    chip = dict(num_elements=max(1, built.lowered.num_elements // 3), phv_bits=built.program.chip.phv_bits)
    jf = jfab.SwitchFabric.partition(built.program, chip=jpipe.ChipSpec(**chip))
    tf = tfab.SwitchFabric.partition(tprog, chip=tpipe.ChipSpec(**chip))
    want = jplan.run(jf, x, plan=jplan.ExecutionPlan(backend="jnp", fleet=3, devices=2))
    got = tplan.run(tf, x, plan=tplan.ExecutionPlan(backend="jnp", fleet=3, devices=2), device="cpu")
    np.testing.assert_array_equal(got.outputs, want.outputs)

    chips = dict(num_elements=64, max_parallel_ops=4096, name="bigchip")
    js, ts = jmt.SwitchScheduler(jpipe.ChipSpec(**chips)), tmt.SwitchScheduler(tpipe.ChipSpec(**chips))
    js.admit(built.program, name="a")
    ts.admit(tprog, name="a")
    pair = (np.zeros(40, np.int32), x)
    want = jplan.run(js, pair, plan=jplan.ExecutionPlan(fleet=2, chunk_size=16))
    got = tplan.run(ts, pair, plan=tplan.ExecutionPlan(fleet=2, chunk_size=16), device="cpu")
    np.testing.assert_array_equal(got.outputs_for(0), want.outputs_for(0))


# -- dataplane.factory ---------------------------------------------------------

SHAPES = ((16, 24, 8), (8, 12, 4), (16, 8))
SCENARIOS = ("ddos_burst", "iot_telemetry", "flow_tuple")


def _carried_programs():
    """Each tenant's weights drawn by the reference (``PRNGKey(i)``) and
    carried to the port by ``convert.params_from_jax``; each package
    compiles its own program."""
    jprogs, tprogs = [], []
    for i, shape in enumerate(SHAPES):
        params = [np.asarray(w) for w in jbnn.init_params(jbnn.BnnSpec(shape), jax.random.PRNGKey(i))]
        weights, _ = convert.params_from_jax(params)
        jprogs.append(jcompiler.compile_bnn(params))
        tprogs.append(tcompiler.compile_bnn([w.numpy() for w in weights]))
    return jprogs, tprogs


def _fleets(**spec):
    jprogs, tprogs = _carried_programs()
    tenant = lambda pkg, i, prog: pkg.TenantSpec(f"t{i}", scenario=SCENARIOS[i], weight=1.0 + i,  # noqa: E731
                                                 program=prog)
    return (jfac.build_fleet(jfac.FleetSpec(tenants=tuple(tenant(jfac, i, p) for i, p in enumerate(jprogs)),
                                            **spec)),
            tfac.build_fleet(tfac.FleetSpec(tenants=tuple(tenant(tfac, i, p) for i, p in enumerate(tprogs)),
                                            **spec)))


def test_build_fleet_matches_reference():
    jf, tf = _fleets(quantum=128)
    assert dataclasses.asdict(tf.chip) == dataclasses.asdict(jf.chip)
    assert tf.chip.num_elements == sum(p.num_elements for p in tf.programs) + 1
    assert [dataclasses.astuple(s) for s in tf.traffic_specs] == [dataclasses.astuple(s) for s in jf.traffic_specs]
    js, ts = jf.scheduler(mode="merged"), tf.scheduler(mode="merged")
    assert [(t.name, t.weight) for t in ts.tenants] == [(t.name, t.weight) for t in js.tenants]
    assert (ts.quantum, ts.mode) == (js.quantum, js.mode) == (128, "merged")
    want = js.run(jf.stream(600, chunk_size=128, seed=3), chunk_size=128, collect=True)
    got = ts.run(tf.stream(600, chunk_size=128, seed=3), chunk_size=128, collect=True, device="cpu")
    assert got.packets == want.packets == 600
    for t in range(len(SHAPES)):
        np.testing.assert_array_equal(got.outputs_for(t), want.outputs_for(t))
    np.testing.assert_array_equal(np.concatenate(list(tf.tenant_stream(1, 300, chunk_size=64, seed=2))),
                                  np.concatenate(list(jf.tenant_stream(1, 300, chunk_size=64, seed=2))))
    jfb, tfb = jf.fabric(0, hops=3), tf.fabric(0, hops=3)
    assert tfb.num_hops == jfb.num_hops == 3
    assert [h.element_range for h in tfb.hops] == [h.element_range for h in jfb.hops]
    with pytest.raises(ValueError, match="not both"):
        tf.fabric(0, hops=2, chip=tf.chip)


def test_build_fleet_from_dict_and_rejections():
    fleet = tfac.build_fleet({"tenants": [{"name": "x", "scenario": "ddos_burst", "shape": (8, 4), "seed": 3}],
                              "mode": "time_sliced", "chip": None})
    assert fleet.spec.mode == "time_sliced" and fleet.num_tenants == 1
    # A shape tenant's weights come from the port's seeded generator.
    weights = tbnn.init_params(tbnn.BnnSpec((8, 4)), torch.Generator().manual_seed(3))
    want = tcompiler.compile_bnn([w.numpy() for w in weights])
    assert fleet.programs[0].fingerprint() == want.fingerprint()
    seq = tfac.build_fleet([tfac.TenantSpec("y", scenario="iot_telemetry", shape=(8, 4))])
    assert seq.spec.tenants[0].name == "y" and seq.chip.name == "shared"
    chip = tfac.FleetSpec.from_dict({"tenants": [{"name": "z", "scenario": "ddos_burst", "shape": (8, 4)}],
                                     "chip": {"num_elements": 9}}).chip
    assert isinstance(chip, tpipe.ChipSpec) and chip.num_elements == 9
    t = tfac.TenantSpec("a", scenario="ddos_burst", shape=(8, 4))
    for make, match in ((lambda: tfac.FleetSpec(tenants=(t, t)), "duplicate"),
                        (lambda: tfac.FleetSpec(tenants=()), "at least one"),
                        (lambda: tfac.TenantSpec("b", scenario="ddos_burst"), "exactly one"),
                        (lambda: tfac.TenantSpec("c", scenario="ddos_burst", shape=(8, 4), program=want),
                         "exactly one")):
        with pytest.raises(ValueError, match=match):
            make()


# -- serving.engine.FleetEngine ------------------------------------------------

class FakeClock:
    """Deterministic monotone clock: every call advances by ``step``."""

    def __init__(self, step: float = 0.5):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _engines(built, tprog, slo: bool, **kw):
    spec = dict(p99_queue_delay_s=3600.0, min_pps=1e9)
    return (jeng.FleetEngine(built.lowered, plan=jplan.ExecutionPlan(backend="packed", chunk_size=32),
                             slo=jslo.SloSpec("fleet", **spec) if slo else None, clock=FakeClock(),
                             window_s=20.0, **kw),
            teng.FleetEngine(tprog.lower(), plan=tplan.ExecutionPlan(backend="packed", chunk_size=32),
                             slo=tslo.SloSpec("fleet", **spec) if slo else None, clock=FakeClock(),
                             window_s=20.0, device="cpu", **kw))


def _health(h, skip=("overlap_ratio", "queue_depth", "roofline_pps_bound", "roofline_fraction")):
    d = dataclasses.asdict(h)
    for k in skip:
        d.pop(k)
    return d


def test_fleet_engine_serve_matches_reference():
    built, tprog = _small()
    streams = _streams(built.case, (130, 77, 0, 113), 8)
    je, te = _engines(built, tprog, slo=False)
    want = je.serve(streams, collect=True)
    got = te.serve(streams, collect=True)
    assert (got.streams, got.packets, got.chunks) == (want.streams, want.packets, want.chunks)
    np.testing.assert_array_equal(got.per_stream_packets, want.per_stream_packets)
    for a, b in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(a, b)
    fr = tfleet.execute_fleet(tprog, streams, plan=tplan.ExecutionPlan(backend="packed", chunk_size=32,
                                                                       collect=True), device="cpu")
    for a, b in zip(got.outputs, fr.outputs):
        np.testing.assert_array_equal(a, b)
    assert got.wall_seconds > 0 and got.ingest_seconds >= 0 and got.overlap_ratio > 0
    assert not [t for t in threading.enumerate() if t.name == "fleet-ingest"]


@pytest.mark.parametrize("slo", [True, False])
def test_fleet_engine_health_matches_reference(slo):
    """Under the same fake clock every windowed field, SLO status and breach
    event equals the reference's: before any serve, after two serves of
    different fleets, and far past the window."""
    built, tprog = _small()
    je, te = _engines(built, tprog, slo=slo)
    assert _health(te.health(now=0.0)) == _health(je.health(now=0.0))
    for lengths, seed in (((130, 77), 8), ((64, 5, 40), 9)):
        streams = _streams(built.case, lengths, seed)
        je.serve(streams)
        te.serve(streams)
        now = je._last_now
        assert te._last_now == now
        for at in (now, now + 100.0):
            h, want = te.health(now=at), je.health(now=at)
            assert _health(h) == _health(want)
            assert h.render().splitlines()[1:] == want.render().splitlines()[1:]
    h = te.health(now=te._last_now)
    assert h.packets == 130 + 77 + 64 + 5 + 40 and len(h.per_stream_pps) == 3
    assert h.queue_capacity == te.queue_depth and h.overlap_ratio is not None
    assert h.roofline_pps_bound is None  # obs is off: no probe
    if slo:
        assert h.slo.breached and [e.objective for e in h.breach_events] == ["throughput"]


def test_fleet_engine_stops_its_producer_when_a_dispatch_raises():
    """A dispatch that raises mid-serve re-raises, and the ingest thread,
    blocked on a full queue, is stopped and joined."""
    built, tprog = _small()
    eng = teng.FleetEngine(tprog.lower(), plan=tplan.ExecutionPlan(backend="packed", chunk_size=1),
                           queue_depth=1, device="cpu")
    calls = []
    run = eng.fn

    def failing(blocks):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("dispatch failed")
        return run(blocks)

    eng.fn = failing
    with pytest.raises(RuntimeError, match="dispatch failed"):
        eng.serve([packets_for(built.case, seed=i, n=200) for i in range(3)])
    assert not [t for t in threading.enumerate() if t.name == "fleet-ingest"]
    with pytest.raises(ValueError, match="one GPU"):
        teng.FleetEngine(tprog, plan=tplan.ExecutionPlan(devices=4), device="cpu")
