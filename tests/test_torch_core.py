"""Port parity: BNN oracle, compiler + lowering, interpreter, configs,
traffic, weight conversion, and the package's import boundary.

Every comparison is bit-exact (``assert_array_equal``): the port compiles and
lowers its own program from the same {0,1} weights, and its tables must be
the reference's, field for field.
"""
from __future__ import annotations

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs import n2net_paper as tcfg
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import interpreter as tinterp
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import lowering as tlow
from repro_torch.dataplane import traffic as ttraffic

from repro.configs import n2net_paper as jcfg
from repro.core import bnn as jbnn
from repro.core import compiler as jcompiler
from repro.core import interpreter as jinterp
from repro.core import pipeline as jpipe
from repro.dataplane import lowering as jlow
from repro.dataplane import traffic as jtraffic

LOWERED_TABLES = (
    "opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write",
    "rows_per_element", "in_slot_per_bit", "in_shift_per_bit",
    "out_slot_per_bit", "out_shift_per_bit", "opcode_counts",
)
PACKED_FIELDS = ("weights", "thresholds", "mask", "in_word", "in_shift")


def _params(sizes, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32)
        for i in range(len(sizes) - 1)
    ]


def _thresholds(params, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, w.shape[1] + 2, w.shape[0]).astype(np.int32) for w in params]


# ---------------------------------------------------------------------------
# BNN oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(32, 64, 32), (5, 3), (40, 33, 7, 2)])
@pytest.mark.parametrize("with_thr", [False, True])
def test_bnn_forward_matches_reference(sizes, with_thr):
    params = _params(sizes, seed=sum(sizes))
    thr = _thresholds(params, 9) if with_thr else None
    x = np.random.default_rng(1).integers(0, 2, (50, sizes[0])).astype(np.int32)
    ref = jax.jit(jbnn.forward)([jnp.asarray(w) for w in params], jnp.asarray(x), thr)
    port = tbnn.forward(
        [torch.from_numpy(w) for w in params], torch.from_numpy(x),
        thresholds=None if thr is None else [torch.from_numpy(t) for t in thr],
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("sizes", [(32, 64, 32), (40, 33, 7, 2)])
def test_bnn_pm1_and_packed_forward_match_reference(sizes):
    params = _params(sizes, seed=sum(sizes))
    x = np.random.default_rng(2).integers(0, 2, (50, sizes[0])).astype(np.int32)
    jparams = [jnp.asarray(w) for w in params]
    tparams = [torch.from_numpy(w) for w in params]
    pm1 = jax.jit(jbnn.forward_pm1)(jparams, jnp.asarray(2.0 * x - 1, jnp.float32))
    port_pm1 = tbnn.forward_pm1(tparams, torch.from_numpy(2.0 * x - 1).float())
    np.testing.assert_array_equal(port_pm1.numpy(), np.asarray(pm1))
    packed = jax.jit(jbnn.packed_forward)(jparams, jnp.asarray(x))
    port_packed = tbnn.packed_forward(tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(port_packed.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(port_packed.numpy(), tbnn.forward(tparams, torch.from_numpy(x)).numpy())


def test_init_params_shapes_and_generator():
    spec = tbnn.BnnSpec((32, 64, 32))
    a = tbnn.init_params(spec, torch.Generator().manual_seed(3))
    b = tbnn.init_params(spec, torch.Generator().manual_seed(3))
    assert [tuple(w.shape) for w in a] == [(64, 32), (32, 64)]
    for wa, wb in zip(a, b):
        assert wa.dtype == torch.int32
        assert torch.equal(wa, wb)
        assert set(wa.unique().tolist()) <= {0, 1}
    with pytest.raises(ValueError):
        tbnn.BnnSpec((4,))


# ---------------------------------------------------------------------------
# Compiler + lowering: identical programs and tables
# ---------------------------------------------------------------------------

CASES = [
    ("headline_rmt", jcfg.HEADLINE.layer_sizes, "rmt", None),
    ("headline_popcnt", jcfg.HEADLINE.layer_sizes, "popcnt", None),
    ("small_rmt_thr", (12, 4, 3), "rmt", 4),
    ("small_popcnt_thr", (33, 6, 2), "popcnt", 5),
]
_CHIPS = {"rmt": (jpipe.RMT, tpipe.RMT), "popcnt": (jpipe.RMT_NATIVE_POPCNT, tpipe.RMT_NATIVE_POPCNT)}


def _compile_both(sizes, chip, thr_seed):
    params = _params(sizes, seed=len(sizes) * 7 + sizes[0])
    thr = None if thr_seed is None else _thresholds(params, thr_seed)
    jchip, tchip = _CHIPS[chip]
    jprog = jcompiler.compile_bnn(params, jchip, thresholds=thr)
    tprog = tcompiler.compile_bnn(params, tchip, thresholds=thr)
    return params, thr, jprog, tprog


@pytest.mark.parametrize("name,sizes,chip,thr_seed", CASES, ids=[c[0] for c in CASES])
def test_compile_and_lower_match_reference(name, sizes, chip, thr_seed):
    _, _, jprog, tprog = _compile_both(sizes, chip, thr_seed)
    assert tprog.fingerprint() == jprog.fingerprint()
    assert tprog.num_elements == jprog.num_elements
    assert tprog.summary() == jprog.summary()
    jlp, tlp = jlow.lower_program(jprog), tprog.lower()
    assert isinstance(tlp, tlow.LoweredProgram)
    assert tlp.fingerprint() == jlp.fingerprint()
    assert (tlp.num_slots, tlp.max_rows, tlp.num_ops) == (jlp.num_slots, jlp.max_rows, jlp.num_ops)
    assert tlp.element_stages == jlp.element_stages
    for field in LOWERED_TABLES:
        a, b = getattr(tlp, field), getattr(jlp, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert tlp.opcode_runs() == jlp.opcode_runs()
    assert tlp.used_opcodes() == jlp.used_opcodes()
    assert len(tlp.packed.layers) == len(jlp.packed.layers)
    for tl, jl in zip(tlp.packed.layers, jlp.packed.layers):
        assert (tl.n_in, tl.n_out, tl.n_words) == (jl.n_in, jl.n_out, jl.n_words)
        for field in PACKED_FIELDS:
            np.testing.assert_array_equal(getattr(tl, field), getattr(jl, field), err_msg=field)
    ts, js = tlow.stack_packed_layers(tlp.packed), jlow.stack_packed_layers(jlp.packed)
    for field in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field), err_msg=field)
    sl_t, sl_j = tlp.slice_elements(1, 3), jlp.slice_elements(1, 3)
    assert sl_t.fingerprint() == sl_j.fingerprint() and sl_t.packed is None
    np.testing.assert_array_equal(sl_t.opcode, sl_j.opcode)


def test_headline_uses_every_dense_opcode_across_chips():
    _, _, _, rmt = _compile_both(jcfg.HEADLINE.layer_sizes, "rmt", None)
    _, _, _, pop = _compile_both(jcfg.HEADLINE.layer_sizes, "popcnt", None)
    used = set(rmt.lower().used_opcodes()) | set(pop.lower().used_opcodes())
    assert used == set(range(tlow.NUM_DENSE_OPCODES))
    assert tlow.POPCNT not in rmt.lower().used_opcodes()


# ---------------------------------------------------------------------------
# Interpreter: the port's own witness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,sizes,chip,thr_seed", CASES[2:], ids=[c[0] for c in CASES[2:]])
def test_interpreter_matches_reference(name, sizes, chip, thr_seed):
    params, thr, jprog, tprog = _compile_both(sizes, chip, thr_seed)
    x = np.random.default_rng(4).integers(0, 2, (24, sizes[0])).astype(np.int32)
    ref = np.asarray(jinterp.run_program_jit(jprog, x))
    port = tinterp.run_program(tprog, x, device="cpu")
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)


def test_interpreter_matches_oracle_on_headline():
    params, _, _, tprog = _compile_both(jcfg.HEADLINE.layer_sizes, "rmt", None)
    x = np.random.default_rng(6).integers(0, 2, (64, 32)).astype(np.int32)
    oracle = np.asarray(jbnn.forward([jnp.asarray(w) for w in params], jnp.asarray(x)))
    np.testing.assert_array_equal(tinterp.run_program(tprog, x, device="cpu").numpy(), oracle)


def test_run_program_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tprog = _compile_both((5, 3), "rmt", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinterp.run_program(tprog, np.zeros((2, 5), np.int32))
    with pytest.raises(ValueError):
        tinterp.run_program(tprog, np.zeros((2, 4), np.int32), device="cpu")


# ---------------------------------------------------------------------------
# Configs, traffic, weights carried across, observability
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    for name in ("HEADLINE", "FIVE_TUPLE", "SINGLE_NEURON_2048"):
        assert getattr(tcfg, name).layer_sizes == getattr(jcfg, name).layer_sizes
    assert tcfg.TABLE1_WIDTHS == jcfg.TABLE1_WIDTHS


# The reference's built-in scenarios, read at import (collection) time: tests
# of other files (tests/test_pcap.py) register more in the reference's global
# table at run time, and may share this worker process.
REF_SCENARIOS = sorted(jtraffic.SCENARIOS)


@pytest.mark.parametrize("scenario", REF_SCENARIOS)
def test_traffic_matches_reference(scenario):
    assert sorted(ttraffic.SCENARIOS) == REF_SCENARIOS
    np.testing.assert_array_equal(
        ttraffic.generate(scenario, 1500, 32, seed=3),
        jtraffic.generate(scenario, 1500, 32, seed=3),
    )
    port = np.concatenate(list(ttraffic.stream(scenario, 1500, 20, chunk_size=700, seed=2)))
    np.testing.assert_array_equal(port, jtraffic.generate(scenario, 1500, 20, seed=2))


def test_params_from_jax_converts_and_validates():
    params = jbnn.init_params(jbnn.BnnSpec((32, 64, 32)), jax.random.PRNGKey(0))
    weights, thr = convert.params_from_jax([np.asarray(w) for w in params])
    assert thr is None
    for w, ref in zip(weights, params):
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref))
    weights, thr = convert.params_from_jax([np.asarray(w) for w in params], [None, 7])
    np.testing.assert_array_equal(thr[0].numpy(), np.full(64, 16))
    np.testing.assert_array_equal(thr[1].numpy(), np.full(32, 7))
    # Filled-in defaults compile to the same program as the default.
    jprog = jcompiler.compile_bnn([np.asarray(w) for w in params], thresholds=[None, 7])
    tprog = tcompiler.compile_bnn([w.numpy() for w in weights], thresholds=thr)
    assert tprog.fingerprint() == jprog.fingerprint()
    bad = [np.asarray(w) for w in params]
    with pytest.raises(ValueError):
        convert.params_from_jax([bad[0] * 2, bad[1]])
    with pytest.raises(ValueError):
        convert.params_from_jax([bad[1], bad[1]])
    with pytest.raises(ValueError):
        convert.params_from_jax(bad, [None])
    with pytest.raises(ValueError):
        convert.params_from_jax(bad, [None, 66])


def test_obs_spans_and_metrics():
    tobs.enable(reset=True)
    try:
        with tobs.span("outer", cat="stream"):
            with tobs.span("inner", cat="execute", packets=3):
                tobs.registry().counter("c").inc(2)
                tobs.registry().histogram("h").observe(0.5)
        recs = {r.name: r for r in tobs.tracer().records}
        assert recs["inner"].parent == "outer" and recs["inner"].depth == 1
        assert tobs.registry().counter("c").value == 2
        assert tobs.registry().histogram("h").p50 == 0.5
        assert set(tobs.tracer().total_by_category()) == {"stream", "execute"}
    finally:
        tobs.disable()
        tobs.reset()
    assert tobs.span("x") is tobs.span("y")  # disabled: the shared null span


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.device, "
        "repro_torch.configs.n2net_paper, repro_torch.core.interpreter, "
        "repro_torch.core.compiler, repro_torch.dataplane.executor, "
        "repro_torch.dataplane.traffic, repro_torch.kernels._build, "
        "repro_torch.kernels.ops, repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.chunked_attention, repro_torch.kernels.decode_attention, "
        "repro_torch.configs.archs, repro_torch.layers.attention, repro_torch.layers.ffn, "
        "repro_torch.models.model, repro_torch.serving.engine, repro_torch.obs.lm_profile, "
        "repro_torch.core.throughput, repro_torch.core.p4gen, repro_torch.core.export, "
        "repro_torch.dataplane.plan, repro_torch.dataplane.telemetry, repro_torch.dataplane.fabric, "
        "repro_torch.obs.windows, repro_torch.obs.slo, repro_torch.tree, repro_torch.optim.adamw, "
        "repro_torch.train.checkpoint, repro_torch.train.bnn_trainer, "
        "repro_torch.dataplane.multitenant, repro_torch.dataplane.pcap, "
        "repro_torch.dataplane.fleet, repro_torch.dataplane.factory, repro_torch.obs.export, "
        "repro_torch.roofline.hw, repro_torch.roofline.kernels, repro_torch.roofline.dataplane, "
        "repro_torch.layers.moe, repro_torch.layers.mla, repro_torch.launch.serve, "
        "repro_torch.layers.mamba2, repro_torch.configs.mamba2_1p3b, repro_torch.configs.zamba2_1p2b, "
        "repro_torch.configs.internvl2_2b, repro_torch.configs.hubert_xlarge, "
        "repro_torch.data.pipeline, repro_torch.optim.compression, repro_torch.train.train_step, "
        "repro_torch.train.trainer, repro_torch.train.elastic, repro_torch.launch.train, "
        "repro_torch.launch.shapes, repro_torch.launch.dryrun, repro_torch.launch.hillclimb, "
        "repro_torch.roofline.analysis, repro_torch.roofline.ops, repro_torch.roofline.report\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
