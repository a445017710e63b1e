"""Port executor: ``repro_torch.dataplane.executor`` against
``repro.dataplane.execute`` on the headline model and on random compiled
programs (``tests/strategies.py``), through the op-table backend, the packed
backend and its scan-over-layers plan, one-shot and chunked, batch and
streaming.  Bit-exact everywhere.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.core import compiler as tcompiler
from repro_torch.core import interpreter as tinterp
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import traffic as ttraffic
from repro_torch.kernels import bitpack as tbitpack
from repro_torch.kernels import optable_exec as topt
from repro_torch.kernels import packed_layer as tpl
from strategies import ProgramCase, build_case, given, packets_for, program_cases

from repro.configs import n2net_paper as jcfg
from repro.core import compiler as jcompiler
from repro.dataplane import executor as jexec

# (backend, scan_hops) paths of the port, named by the reference's strings.
PATHS = [("jnp", False), ("pallas", False), ("packed", False), ("packed", True)]
_REF_CACHE: dict = {}


def _headline():
    """The headline model lowered by the port and by the reference."""
    rng = np.random.default_rng(0)
    sizes = jcfg.HEADLINE.layer_sizes
    params = [rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32) for i in range(2)]
    return tcompiler.compile_bnn(params).lower(), jcompiler.compile_bnn(params).lower()


def _reference(built, packets, key):
    """The reference's output on these packets (its jnp backend), memoized."""
    if key not in _REF_CACHE:
        _REF_CACHE[key] = jexec.execute(built.lowered, packets, backend="jnp")
    return _REF_CACHE[key]


FIXED_CASES = [
    ProgramCase((32, 64, 32), 11, "default", 0),
    ProgramCase((33, 7), 12, "per_neuron", 3),
    ProgramCase((5, 40, 2), 13, "scalar", 4),
    ProgramCase((48, 1), 14, "per_neuron", 5),
]


def _port_build(case):
    """The reference's build of ``case`` and the port's own program."""
    built = build_case(case)
    return built, tcompiler.compile_bnn(built.params, thresholds=built.thresholds)


@pytest.mark.parametrize("backend,scan_hops", PATHS)
@pytest.mark.parametrize("case", FIXED_CASES, ids=lambda c: "x".join(map(str, c.layer_sizes)))
def test_execute_matches_reference(case, backend, scan_hops):
    built, prog = _port_build(case)
    lp = prog.lower()
    packets = packets_for(case, seed=case.weight_seed, n=70)
    ref = _reference(built, packets, case)
    for chunk in (None, 16):
        out = texec.execute(
            lp, packets, backend=backend, scan_hops=scan_hops, chunk_size=chunk, device="cpu"
        )
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)


@given(program_cases(max_layers=2, max_width=40))
def test_execute_fuzz_matches_reference(case):
    built, prog = _port_build(case)
    lp = prog.lower()
    packets = packets_for(case, seed=case.weight_seed ^ 0x5EED, n=24)
    ref = jexec.execute(built.lowered, packets, backend="packed")
    for backend, scan_hops in PATHS[1:]:
        out = texec.execute(lp, packets, backend=backend, scan_hops=scan_hops, device="cpu")
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tinterp.run_program(prog, packets, device="cpu").numpy(), ref
    )


@pytest.mark.parametrize("backend,scan_hops", PATHS[1:])
def test_execute_stream_matches_reference_on_headline(backend, scan_hops):
    lp, jlp = _headline()
    ref = jexec.execute_stream(
        jlp, ttraffic.stream("ddos_burst", 1500, 32, chunk_size=700, seed=1),
        backend="packed", chunk_size=512, collect=True,
    )
    tobs.enable(reset=True)
    try:
        sr = texec.execute_stream(
            lp, ttraffic.stream("ddos_burst", 1500, 32, chunk_size=700, seed=1),
            backend=backend, scan_hops=scan_hops, chunk_size=512, collect=True, device="cpu",
        )
        reg = tobs.registry()
        assert reg.counter("dataplane.packets_total").value == 1500
        assert reg.counter("dataplane.chunks_total").value == 3
        cats = tobs.tracer().total_by_category()
        assert {"stream", "compile", "execute"} <= set(cats)
    finally:
        tobs.disable()
        tobs.reset()
    assert (sr.packets, sr.chunks) == (ref.packets, ref.chunks) == (1500, 3)
    np.testing.assert_array_equal(sr.outputs, ref.outputs)
    np.testing.assert_array_equal(sr.bit_counts, ref.bit_counts)
    assert sr.seconds > 0 and sr.warmup_seconds > 0 and sr.packets_per_second > 0


def test_parse_deparse_and_run_hop_match_reference():
    import jax.numpy as jnp

    lp, jlp = _headline()
    packets = np.random.default_rng(3).integers(0, 2, (50, 32)).astype(np.int32)
    t = texec._device_tables(lp, torch.device("cpu"))
    jt = jexec._device_tables(jlp)
    regs = texec.parse_packets(torch.from_numpy(packets), *t.io[:2], num_regs=lp.num_regs)
    jregs = jexec.parse_packets(jnp.asarray(packets), *jt.io[:2], num_regs=lp.num_regs)
    np.testing.assert_array_equal(regs.numpy(), np.asarray(jregs).view(np.int32))
    regs = texec.run_hop(lp, regs)
    jregs = jexec.run_hop(jlp, jregs)
    np.testing.assert_array_equal(regs.numpy(), np.asarray(jregs).view(np.int32))
    np.testing.assert_array_equal(
        texec.deparse_regs(regs, *t.io[2:]).numpy(), np.asarray(jexec.deparse_regs(jregs, *jt.io[2:]))
    )
    regs0 = texec.parse_packets(torch.from_numpy(packets), *t.io[:2], num_regs=lp.num_regs)
    assert torch.equal(texec.run_elements(regs0, t.ops, t.first_write), regs)


def test_backend_strings_and_errors(monkeypatch):
    assert [texec.resolve_backend(b) for b in ("auto", "jnp", "fused", "pallas", "packed")] == [
        "jnp", "jnp", "jnp", "jnp", "packed"
    ]
    with pytest.raises(ValueError):
        texec.resolve_backend("interpreter")
    lp, _ = _headline()
    packets = np.zeros((4, 32), np.int32)
    with pytest.raises(ValueError):
        texec.execute(lp, packets[:, :31], device="cpu")
    with pytest.raises(ValueError):
        texec.run_hop(lp, torch.zeros((lp.num_regs, 4), dtype=torch.int32), backend="packed")
    with pytest.raises(ValueError):
        texec.execute(lp.slice_elements(0, 2), packets, backend="packed", device="cpu")
    assert texec.execute(lp, packets[:0], device="cpu").shape == (0, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        texec.execute(lp, packets)
    with pytest.raises(RuntimeError, match="CUDA"):
        texec.execute_stream(lp, [packets])


def test_cpu_runs_launch_no_kernel():
    lp, _ = _headline()
    counters = (topt.optable_run, tbitpack.pack_bits_words, tpl.packed_layer)
    before = [f.launches for f in counters]
    for backend in ("jnp", "packed"):
        texec.execute(lp, np.ones((8, 32), np.int32), backend=backend, device="cpu")
    assert [f.launches for f in counters] == before
