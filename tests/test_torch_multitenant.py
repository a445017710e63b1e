"""Port multi-tenant scheduling: ``repro_torch.dataplane.multitenant``
(``SwitchScheduler``, ``merge_lowered``, ``interleave_lowered``), the routed
executor functions, the per-tenant packed layer, the mixed-tenant traffic and
the merge helpers of ``lowering``, against the reference's, on the CPU.

The same numpy inputs go through both packages and are compared with
``assert_array_equal``: tables and routing tables array by array, routed
dispatches against the reference's ``"jnp"`` backend, and the scheduler's
per-tenant outputs and statistics in every mode, layout and backend.
Tenants: the reference test's three (``tests/test_multitenant.py``) and the
eight of ``benchmarks/multitenant_bench.py``, whose block-diagonal merged
packed layers have word layouts that are not contiguous.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strategies import TenantMixCase, build_case, given, mix_traffic, settings, tenant_mixes

from repro_torch import obs as tobs
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import interpreter as tinterp
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import lowering as tlow
from repro_torch.dataplane import multitenant as tmt
from repro_torch.dataplane import plan as tplan
from repro_torch.dataplane import traffic as ttr
from repro_torch.kernels import packed_layer as tpl
from repro_torch.obs import slo as tslo

from repro import obs as jobs
from repro.core import compiler as jcompiler
from repro.core import pipeline as jpipe
from repro.dataplane import executor as jexec
from repro.dataplane import lowering as jlow
from repro.dataplane import multitenant as jmt
from repro.dataplane import traffic as jtr
from repro.obs import slo as jslo

SHAPES = [(16, 8, 4), (32, 16), (8, 12, 6)]
SPECS = [("ddos_burst", 16, 3.0), ("flow_tuple", 32, 1.0), ("iot_telemetry", 8, 2.0)]
# benchmarks/multitenant_bench.py's pool (its first eight tenants).
POOL_SHAPES = [(32, 64, 32), (16, 32, 8), (32, 16), (8, 12, 6), (16, 8, 4), (32, 32, 4)]
POOL_SCENARIOS = ("ddos_burst", "iot_telemetry", "flow_tuple", "adversarial_bitflip", "uniform_random")
POOL_WEIGHTS = (3.0, 2.0, 1.0, 1.0, 2.0, 1.0)
ROUTING = ("in_slot", "in_shift", "in_valid", "out_slot", "out_shift", "in_bits", "out_bits",
           "packed_in_bit", "packed_out_bit", "element_program", "row_tenant", "row_src_elem",
           "row_src_row")
CPU = torch.device("cpu")


def _params(shapes, seed):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 2, (s[i + 1], s[i])).astype(np.int32) for i in range(len(s) - 1)]
            for s in shapes]


def _specs(pkg, specs):
    return [pkg.TenantTrafficSpec(*s) for s in specs]


@pytest.fixture(scope="module")
def tenants3():
    """The reference test's three tenants: weights, and the port's and the
    reference's programs of them."""
    params = _params(SHAPES, 0)
    return (params, [tcompiler.compile_bnn(p) for p in params],
            [jcompiler.compile_bnn(p) for p in params])


@pytest.fixture(scope="module")
def pool8():
    """The benchmark's eight tenants, lowered in both packages."""
    shapes = [POOL_SHAPES[i % len(POOL_SHAPES)] for i in range(8)]
    params = _params(shapes, 1)
    specs = [(POOL_SCENARIOS[i % len(POOL_SCENARIOS)], shapes[i][0], POOL_WEIGHTS[i % len(POOL_WEIGHTS)])
             for i in range(8)]
    return ([tcompiler.compile_bnn(p).lower() for p in params],
            [jcompiler.compile_bnn(p).lower() for p in params], specs)


def _chips(**kw):
    return tpipe.ChipSpec(name="bigchip", **kw), jpipe.ChipSpec(name="bigchip", **kw)


def _same_packed(a, b):
    if b is None:
        assert a is None
        return
    assert (a.input_bits, a.output_bits, len(a.layers)) == (b.input_bits, b.output_bits, len(b.layers))
    for la, lb in zip(a.layers, b.layers):
        for f in dataclasses.fields(lb):
            x, y = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def _same_lowered(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "packed":
            _same_packed(x, y)
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert a.fingerprint() == b.fingerprint()


def _same_merged(a, b):
    _same_lowered(a.lowered, b.lowered)
    assert (a.slot_windows, a.element_ranges, a.layout) == (b.slot_windows, b.element_ranges, b.layout)
    for name in ROUTING:
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


# -- mixed-tenant traffic -----------------------------------------------------

@pytest.mark.parametrize("seed,n,chunk", [(7, 2000, 300), (0, 1000, 1000), (3, 777, 64)])
def test_mixed_tenant_traffic_matches_reference(seed, n, chunk):
    tspecs, jspecs = _specs(ttr, SPECS), _specs(jtr, SPECS)
    ti, tb = ttr.mixed_tenant_generate(tspecs, n, seed=seed)
    ji, jb = jtr.mixed_tenant_generate(jspecs, n, seed=seed)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)
    chunks = list(ttr.mixed_tenant_stream(tspecs, n, chunk_size=chunk, seed=seed))
    for (a, b), (c, d) in zip(chunks, jtr.mixed_tenant_stream(jspecs, n, chunk_size=chunk, seed=seed)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert len(chunks) == -(-n // chunk)
    for t in range(len(SPECS)):
        assert ttr.tenant_stream_seed(seed, t) == jtr.tenant_stream_seed(seed, t)


def test_mixed_tenant_traffic_validation_matches():
    for pkg in (ttr, jtr):
        with pytest.raises(ValueError):
            list(pkg.mixed_tenant_stream([], 10, chunk_size=4))
        with pytest.raises(KeyError):
            pkg.TenantTrafficSpec("nope", 8)
        for bad in (dict(weight=0.0), dict(input_bits=0)):
            with pytest.raises(ValueError):
                pkg.TenantTrafficSpec("uniform_random", **{"input_bits": 8, **bad})
    ti, tb = ttr.mixed_tenant_generate(_specs(ttr, SPECS), 0)
    assert ti.shape == (0,) and tb.shape == (0, 32)


# -- lowering's merge helpers -------------------------------------------------

@pytest.mark.parametrize("width", [1, 8, 31, 32, 33, 70])
def test_packed_layer_identity_matches_reference(width):
    _same_packed(tlow.PackedProgram(layers=(tlow.PackedLayer.identity(width),), input_bits=width,
                                    output_bits=width),
                 jlow.PackedProgram(layers=(jlow.PackedLayer.identity(width),), input_bits=width,
                                    output_bits=width))
    for pkg in (tlow, jlow):
        with pytest.raises(ValueError):
            pkg.PackedLayer.identity(0)


def test_interleave_tables_and_peak_rows_match_reference(tenants3, pool8):
    t8, j8, _ = pool8
    cases = [([p.lower() for p in tenants3[1]], [p.lower() for p in tenants3[2]]), (t8, j8)]
    for tl, jl in cases:
        assert tlow.peak_stage_rows(tl) == jlow.peak_stage_rows(jl)
        total = sum(lp.num_slots for lp in tl)
        offs = np.concatenate(([0], np.cumsum([lp.num_slots for lp in tl])))
        ti = tlow.interleave_tables([lp.with_slot_window(int(o), total) for lp, o in zip(tl, offs)])
        ji = jlow.interleave_tables([lp.with_slot_window(int(o), total) for lp, o in zip(jl, offs)])
        for f in dataclasses.fields(ji):
            x, y = getattr(ti, f.name), getattr(ji, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    assert tlow.peak_stage_rows([]) == jlow.peak_stage_rows([]) == 0


@pytest.mark.parametrize("build", ["merge_lowered", "interleave_lowered"])
def test_merges_match_reference_table_by_table(tenants3, pool8, build):
    tch, jch = _chips(num_elements=256)
    t8, j8, _ = pool8
    perm = [2, 0, 1]
    tl, jl = [p.lower() for p in tenants3[1]], [p.lower() for p in tenants3[2]]
    for tls, jls in ((tl, jl), ([tl[i] for i in perm], [jl[i] for i in perm]), (t8, j8)):
        _same_merged(getattr(tmt, build)(tls, tch), getattr(jmt, build)(jls, jch))
    # The eight-tenant block-diagonal packed plan has non-contiguous word
    # layouts, which the executor scatters into words.
    layers = getattr(tmt, build)(t8, tch).lowered.packed.layers
    assert [(pl.n_out, pl.n_words) for pl in layers] == [(260, 8), (110, 10)]
    assert not any(texec._trivial_layout(pl) for pl in layers)
    for pkg in (tmt, jmt):
        with pytest.raises(ValueError, match="at least one"):
            getattr(pkg, build)([], tch)


# -- routed executor functions ---------------------------------------------------

def _mixed(specs, n, seed):
    tids, bits = jtr.mixed_tenant_generate(_specs(jtr, specs), n, seed=seed)
    return tids, bits, torch.from_numpy(tids), torch.from_numpy(bits)


def test_routed_parse_deparse_and_bit_routes_match_reference(tenants3):
    tch, jch = _chips(num_elements=256)
    mp = tmt.interleave_lowered([p.lower() for p in tenants3[1]], tch)
    tids, bits, d_tids, d_bits = _mixed(SPECS, 200, 4)
    idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa: E731
    regs = texec.parse_packets_routed(d_bits, d_tids, idx(mp.in_slot), idx(mp.in_shift),
                                      idx(mp.in_valid), num_regs=mp.lowered.num_regs)
    want = jexec.parse_packets_routed(bits, tids, mp.in_slot, mp.in_shift, mp.in_valid,
                                      num_regs=mp.lowered.num_regs)
    np.testing.assert_array_equal(regs.numpy().view(np.uint32), np.asarray(want))
    # High-bit words in the register file: the deparse shifts are logical.
    rng = np.random.default_rng(2)
    full = rng.integers(0, 1 << 32, (mp.lowered.num_regs, 200), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        texec.deparse_regs_routed(torch.from_numpy(full.view(np.int32)), d_tids, idx(mp.out_slot),
                                  idx(mp.out_shift)).numpy(),
        np.asarray(jexec.deparse_regs_routed(full, tids, mp.out_slot, mp.out_shift)))
    total = mp.lowered.packed.input_bits
    np.testing.assert_array_equal(
        texec.route_bits_in(d_bits, d_tids, idx(mp.packed_in_bit), idx(mp.in_valid), total_bits=total).numpy(),
        np.asarray(jexec.route_bits_in(bits, tids, mp.packed_in_bit, mp.in_valid, total_bits=total)))
    dense = rng.integers(0, 2, (200, mp.lowered.packed.output_bits)).astype(np.int32)
    np.testing.assert_array_equal(
        texec.route_bits_out(torch.from_numpy(dense), d_tids, idx(mp.packed_out_bit)).numpy(),
        np.asarray(jexec.route_bits_out(dense, tids, mp.packed_out_bit)))
    for inv in ("_invert_parse_routing",):
        for x, y in zip(getattr(texec, inv)(mp.in_slot, mp.in_shift, mp.in_valid),
                        getattr(jexec, inv)(mp.in_slot, mp.in_shift, mp.in_valid)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(texec._invert_bit_routing(mp.packed_in_bit, mp.in_valid, total),
                    jexec._invert_bit_routing(mp.packed_in_bit, mp.in_valid, total)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_routed_dispatch_matches_reference_jnp(tenants3, layout):
    """routed_fn (op-table), routed_packed_fn (block-diagonal plan, a
    scatter into words) and routed_packed_stacked_fn (the per-tenant
    layer) on a mixed batch with width padding."""
    tch, jch = _chips(num_elements=256)
    build = "interleave_lowered" if layout == "interleave" else "merge_lowered"
    tmp = getattr(tmt, build)([p.lower() for p in tenants3[1]], tch)
    jmp = getattr(jmt, build)([p.lower() for p in tenants3[2]], jch)
    tids, bits, d_tids, d_bits = _mixed(SPECS, 300, 9)
    tables = ("in_slot", "in_shift", "in_valid", "out_slot", "out_shift")
    got = texec.routed_fn(tmp.lowered, *(getattr(tmp, n) for n in tables), device="cpu")(d_bits, d_tids)
    want = jexec.routed_fn(jmp.lowered, *(getattr(jmp, n) for n in tables), backend="jnp")(bits, tids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = texec.routed_packed_fn(tmp.lowered, tmp.packed_in_bit, tmp.packed_out_bit, tmp.in_valid,
                                 device="cpu")(d_bits, d_tids)
    want_p = jexec.routed_packed_fn(jmp.lowered, jmp.packed_in_bit, jmp.packed_out_bit, jmp.in_valid)(bits, tids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    for t, width in enumerate(tmp.out_bits):  # width padding differs: sliced off per tenant
        np.testing.assert_array_equal(got.numpy()[tids == t, :width], np.asarray(want)[tids == t, :width])
    stacked = texec.routed_packed_stacked_fn(tuple(p.lower() for p in tenants3[1]), device="cpu")
    want_s = jexec.routed_packed_stacked_fn(tuple(p.lower() for p in tenants3[2]))(bits, tids)
    np.testing.assert_array_equal(stacked(d_bits, d_tids).numpy(), np.asarray(want_s))
    with pytest.raises(ValueError, match="routed_packed_fn"):
        texec.routed_fn(tmp.lowered, *(getattr(tmp, n) for n in tables), backend="packed", device="cpu")


def test_routed_packed_dispatch_of_the_eight_tenant_pool(pool8):
    t8, j8, specs = pool8
    tch, jch = _chips(num_elements=512)
    tmp, jmp = tmt.merge_lowered(t8, tch), jmt.merge_lowered(j8, jch)
    tids, bits, d_tids, d_bits = _mixed(specs, 200, 5)
    got = texec.routed_packed_fn(tmp.lowered, tmp.packed_in_bit, tmp.packed_out_bit, tmp.in_valid,
                                 device="cpu")(d_bits, d_tids)
    want = jexec.routed_packed_fn(jmp.lowered, jmp.packed_in_bit, jmp.packed_out_bit, jmp.in_valid)(bits, tids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stacked = texec.routed_packed_stacked_fn(tuple(t8), device="cpu")(d_bits, d_tids)
    want_s = np.asarray(jexec.routed_packed_stacked_fn(tuple(j8))(bits, tids))
    np.testing.assert_array_equal(stacked.numpy(), want_s)
    # Each tenant's columns are its own program's outputs.
    for t, lp in enumerate(t8):
        rows = tids == t
        np.testing.assert_array_equal(stacked.numpy()[rows, :lp.output_bits],
                                      texec.execute(lp, bits[rows, :lp.input_bits], device="cpu"))


def test_stacked_dispatch_declines_hand_assembled_layouts(tenants3):
    """A packed layer whose bits are not laid out contiguously (as a
    hand-assembled program's can be) makes the stacked dispatch decline in
    both packages; the block-diagonal dispatch still runs it, alike."""
    lows = []
    for pkg, progs in ((tlow, tenants3[1]), (jlow, tenants3[2])):
        lp = progs[1].lower()  # (32, 16): one layer, one word
        pl = lp.packed.layers[0]
        odd = dataclasses.replace(pl, in_shift=(31 - pl.in_shift).astype(pl.in_shift.dtype))
        lows.append([progs[0].lower(), dataclasses.replace(
            lp, source_fingerprint=lp.source_fingerprint + "+reversed",
            packed=pkg.PackedProgram(layers=(odd,), input_bits=32, output_bits=16))])
    (tl, jl), (tch, jch) = lows, _chips(num_elements=256)
    assert texec.routed_packed_stacked_fn(tuple(tl), device="cpu") is None
    assert jexec.routed_packed_stacked_fn(tuple(jl)) is None
    tmp, jmp = tmt.interleave_lowered(tl, tch), jmt.interleave_lowered(jl, jch)
    tids, bits, d_tids, d_bits = _mixed(SPECS[:2], 150, 8)
    got = texec.routed_packed_fn(tmp.lowered, tmp.packed_in_bit, tmp.packed_out_bit, tmp.in_valid,
                                 device="cpu")(d_bits, d_tids)
    want = jexec.routed_packed_fn(jmp.lowered, jmp.packed_in_bit, jmp.packed_out_bit, jmp.in_valid)(bits, tids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the per-tenant packed layer's plain version ---------------------------------------

@pytest.mark.parametrize("tenants,n_out,n_words", [(1, 5, 1), (3, 7, 2), (5, 13, 3), (128, 9, 8)])
def test_packed_layer_routed_plain_matches_reference_formula(tenants, n_out, n_words):
    rng = np.random.default_rng(tenants)
    batch = 37
    words = rng.integers(0, 1 << 32, (batch, n_words), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF  # high bits everywhere
    w = rng.integers(0, 1 << 32, (tenants, n_out, n_words), dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << 32, (tenants, n_out, n_words), dtype=np.uint64).astype(np.uint32)
    thr = rng.integers(0, 32 * n_words + 2, (tenants, n_out)).astype(np.uint32)
    # Pad neurons: zero weights and masks, the unreachable threshold.
    w[:, -1], m[:, -1], thr[:, -1] = 0, 0, 0xFFFFFFFF
    m[0, 0] = 0xFFFFFFFF
    thr[0, 0] = 0  # always fires
    ids = rng.integers(0, tenants, batch).astype(np.int32)
    agree = jax.lax.population_count(~(jnp.asarray(words)[:, None, :] ^ jnp.asarray(w)[ids]) & jnp.asarray(m)[ids])
    want = np.asarray((jnp.sum(agree, axis=-1, dtype=jnp.uint32) >= jnp.asarray(thr)[ids]).astype(jnp.int32))
    args = [torch.from_numpy(a.view(np.int32)) for a in (words, ids, w, m, thr)]
    got = tpl.packed_layer_routed(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpl.packed_layer_routed_plain(*args).numpy(), want)
    assert not got[:, -1].any() and got[ids == 0, 0].all()


def test_packed_layer_routed_refuses_bad_ids_and_shapes():
    words = torch.zeros((4, 2), dtype=torch.int32)
    w = torch.zeros((3, 5, 2), dtype=torch.int32)
    thr = torch.zeros((3, 5), dtype=torch.int32)
    for bad in ([0, 1, 3, 2], [0, -1, 1, 2]):
        with pytest.raises(ValueError, match="outside"):
            tpl.packed_layer_routed(words, torch.tensor(bad, dtype=torch.int32), w, w, thr)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tpl.packed_layer_routed(words, ids, w, w, thr[:, :4])
    with pytest.raises(ValueError, match="int32"):
        tpl.packed_layer_routed(words, ids.long(), w, w, thr)
    assert tpl.packed_layer_routed(words[:0], ids[:0], w, w, thr).shape == (0, 5)


# -- the scheduler ------------------------------------------------------------------------

def _schedulers(tenants3, **kw):
    _, tprogs, jprogs = tenants3
    tch, jch = _chips(num_elements=256)
    ts, js = tmt.SwitchScheduler(tch, **kw), jmt.SwitchScheduler(jch, **kw)
    for i, (spec, tp, jp) in enumerate(zip(SPECS, tprogs, jprogs)):
        ts.admit(tp, name=f"t{i}", weight=spec[2])
        js.admit(jp, name=f"t{i}", weight=spec[2])
    return ts, js


STATS = ("tid", "name", "packets", "served", "dropped", "deferred", "slices")


@pytest.mark.parametrize("backend", ["jnp", "packed"])
@pytest.mark.parametrize("mode,layout,kw", [
    ("merged", "interleave", {}),
    ("merged", "concat", {}),
    ("time_sliced", None, dict(quantum=128, max_queue=200)),
], ids=["merged-interleave", "merged-concat", "time_sliced"])
def test_scheduler_matches_reference_per_tenant(tenants3, mode, layout, kw, backend):
    params = tenants3[0]
    ts, js = _schedulers(tenants3, **kw)
    n = 2000
    tr = ts.run(ttr.mixed_tenant_stream(_specs(ttr, SPECS), n, chunk_size=300, seed=7), mode=mode,
                merged=layout, backend=backend, chunk_size=512, device="cpu")
    jr = js.run(jtr.mixed_tenant_stream(_specs(jtr, SPECS), n, chunk_size=300, seed=7), mode=mode,
                merged=layout, backend=backend, chunk_size=512)
    assert (tr.mode, tr.packets, tr.chunks, tr.merged_layout) == (jr.mode, jr.packets, jr.chunks, jr.merged_layout)
    tids, bits = ttr.mixed_tenant_generate(_specs(ttr, SPECS), n, seed=7)
    for t, lp in enumerate(t.lowered for t in ts.tenants):
        a, b = tr.stats_for(t), jr.stats_for(t)
        assert [getattr(a, k) for k in STATS] == [getattr(b, k) for k in STATS]
        assert a.packets == a.served + a.dropped == int((tids == t).sum())
        got = tr.outputs_for(t)
        np.testing.assert_array_equal(got, jr.outputs_for(t))
        if a.dropped == 0:
            mine = bits[tids == t][:, :lp.input_bits]
            np.testing.assert_array_equal(got, texec.execute(lp, mine, device="cpu"))
            np.testing.assert_array_equal(
                got, tbnn.forward([torch.from_numpy(w) for w in params[t]], torch.from_numpy(mine)).numpy())
    if mode == "time_sliced":
        assert sum(tr.stats_for(t).dropped for t in range(3)) > 0  # tail drop at max_queue 200
        assert all(tr.stats_for(t).deferred > 0 for t in range(3))


def test_scheduler_first_tenant_matches_interpreter(tenants3):
    ts, _ = _schedulers(tenants3)
    tids, bits = ttr.mixed_tenant_generate(_specs(ttr, SPECS), 300, seed=1)
    res = ts.run((tids, bits), mode="merged", device="cpu")
    for t, prog in enumerate(tenants3[1]):
        mine = bits[tids == t][:, :prog.input_bits]
        np.testing.assert_array_equal(res.outputs_for(t), tinterp.run_program(prog, mine, device="cpu").numpy())


def test_admission_errors_match_reference(tenants3):
    _, tprogs, jprogs = tenants3

    def both(make, act):
        """Run ``act`` on the port's and the reference's scheduler; both must
        raise the same error with the same message (or both succeed)."""
        errors = []
        for pkg, cpkg, progs in ((tmt, tpipe, tprogs), (jmt, jpipe, jprogs)):
            try:
                act(make(pkg, cpkg), progs)
                errors.append(None)
            except (tmt.AdmissionError, jmt.AdmissionError, ValueError) as exc:
                errors.append((type(exc).__name__, str(exc)))
        assert errors[0] == errors[1]
        return errors[0]

    a, b = tprogs[0], tprogs[2]
    assert both(lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=a.num_elements - 1)),
                lambda s, p: s.admit(p[0]))[0] == "AdmissionError"
    assert both(lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=256, phv_bits=a.peak_phv_bits - 1)),
                lambda s, p: s.admit(p[0]))[0] == "AdmissionError"
    short = a.num_elements + b.num_elements - 1
    assert "merged footprint" in both(
        lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=short), mode="merged", merged="concat"),
        lambda s, p: (s.admit(p[0]), s.admit(p[2])))[1]

    def auto_then_merged(s, p):
        s.admit(p[0])
        s.admit(p[2])
        assert s.resolve_mode() == "time_sliced"
        s.run(([0, 1], np.zeros((2, 16), np.int32)), mode="merged",
              **({"device": "cpu"} if isinstance(s, tmt.SwitchScheduler) else {}))

    assert "time_sliced" in both(
        lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=short), mode="auto", merged="concat"),
        auto_then_merged)[1]
    peak = tlow.peak_stage_rows([a.lower(), b.lower()])
    assert "parallel ops" in both(
        lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=256, max_parallel_ops=peak - 1), mode="merged"),
        lambda s, p: (s.admit(p[0]), s.admit(p[2])))[1]
    assert both(lambda m, c: m.SwitchScheduler(c.ChipSpec(num_elements=256, max_parallel_ops=peak - 1),
                                               mode="merged", merged="concat"),
                lambda s, p: (s.admit(p[0]), s.admit(p[2]))) is None
    for kw in (dict(mode="bogus"), dict(merged="bogus"), dict(quantum=0), dict(max_queue=0)):
        assert both(lambda m, c: m.SwitchScheduler(**kw), lambda s, p: None)[0] == "ValueError"
    assert both(lambda m, c: m.SwitchScheduler(), lambda s, p: s.admit(p[0], weight=0))[0] == "ValueError"


def test_scheduler_validates_ids_tenants_and_device(tenants3):
    ts, _ = _schedulers(tenants3)
    with pytest.raises(ValueError, match="no tenants"):
        tmt.SwitchScheduler().run((np.zeros(4, np.int32), np.zeros((4, 8))), device="cpu")
    with pytest.raises(ValueError, match="tenant ids"):
        ts.run((np.array([0, 7], np.int32), np.zeros((2, 32), np.int32)), mode="merged", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.run((np.zeros(2, np.int32), np.zeros((2, 32), np.int32)))


def _telemetry_fields(tel, timed=("measured_pps",)):
    """Telemetry as a dict, without the fields read from the wall clock."""
    d = dataclasses.asdict(tel)
    d.pop("measured_pps")
    for row in d["tenants"]:
        for key in timed:
            row.pop(key)
    return d


def test_telemetry_slo_and_counters_match_reference(tenants3):
    """Time-sliced with an injected clock and an SLO, observability on: the
    telemetry (timings left out), the SLO status and breach events, and the
    per-tenant counters equal the reference's."""
    ticks = {"port": 0.0, "ref": 0.0}

    def clock(key):
        def now():
            ticks[key] += 0.001
            return ticks[key]
        return now

    _, tprogs, jprogs = tenants3
    tch, jch = _chips(num_elements=256)
    ts = tmt.SwitchScheduler(tch, quantum=128, max_queue=200, clock=clock("port"))
    js = jmt.SwitchScheduler(jch, quantum=128, max_queue=200, clock=clock("ref"))
    for i, (spec, tp, jp) in enumerate(zip(SPECS, tprogs, jprogs)):
        ts.admit(tp, name=f"t{i}", weight=spec[2])
        js.admit(jp, name=f"t{i}", weight=spec[2])
    ts.set_slo(tslo.SloSpec("t0", p99_queue_delay_s=0.002, min_pps=10.0))
    js.set_slo(jslo.SloSpec("t0", p99_queue_delay_s=0.002, min_pps=10.0))
    tobs.enable(reset=True)
    jobs.enable(reset=True)
    try:
        tr = ts.run(ttr.mixed_tenant_stream(_specs(ttr, SPECS), 1200, chunk_size=400, seed=2),
                    mode="time_sliced", device="cpu")
        jr = js.run(jtr.mixed_tenant_stream(_specs(jtr, SPECS), 1200, chunk_size=400, seed=2),
                    mode="time_sliced")
        for name in ("mt.packets_total", "mt.served_total", "mt.dropped_total", "mt.deferred_total",
                     "mt.slices_total"):
            for t in range(3):
                assert (tobs.registry().counter(name, tenant=f"t{t}").value
                        == jobs.registry().counter(name, tenant=f"t{t}").value), name
        for t in range(3):
            th = tobs.registry().histogram("mt.queue_delay_seconds", tenant=f"t{t}")
            jh = jobs.registry().histogram("mt.queue_delay_seconds", tenant=f"t{t}")
            assert th.count == jh.count
    finally:
        # Off and emptied: the captured spans would otherwise outlive this
        # test in both packages' global tracers.
        tobs.disable()
        tobs.reset()
        jobs.disable()
        jobs.reset()
    assert _telemetry_fields(ts.telemetry(tr)) == _telemetry_fields(js.telemetry(jr))
    assert ts.slo_tracker("t0") is not None and ts.slo_tracker("nobody") is None
    assert ts.telemetry(tr).render().splitlines()[0] == js.telemetry(jr).render().splitlines()[0]
    assert ts.analytic_pps() == js.analytic_pps()
    # Merged telemetry: tenants' windows and element ranges.
    tm = ts.run(ttr.mixed_tenant_generate(_specs(ttr, SPECS), 300, seed=2), mode="merged", chunk_size=512,
                device="cpu")
    jm = js.run(jtr.mixed_tenant_generate(_specs(jtr, SPECS), 300, seed=2), mode="merged", chunk_size=512)
    # Merged mode feeds the SLO each chunk's measured dispatch time.
    timed = ("measured_pps", "slo", "breach_events")
    assert _telemetry_fields(ts.telemetry(tm), timed) == _telemetry_fields(js.telemetry(jm), timed)


def test_time_sliced_turns_reuse_cached_tables(tenants3):
    """A turn runs the tenant's tables from the executor's cache: after a
    first run, a second one misses no table upload."""
    ts, _ = _schedulers(tenants3, quantum=64)
    stream = ttr.mixed_tenant_generate(_specs(ttr, SPECS), 600, seed=3)
    ts.run(stream, mode="time_sliced", device="cpu")
    tobs.enable(reset=True)
    try:
        res = ts.run(stream, mode="time_sliced", device="cpu")
        reg = tobs.registry()
        hits = reg.counter("dataplane.table_cache_hits_total").value
        misses = reg.counter("dataplane.table_cache_misses_total").value
    finally:
        tobs.disable()
        tobs.reset()
    turns = sum(st.slices for st in res.tenants)
    # Two lookups a turn (the parse tables and the hop's), every turn and
    # each tenant's warm call.
    assert misses == 0 and hits == 2 * (turns + len(ts.tenants))


def test_plan_runs_a_scheduler_and_ignores_fleets(tenants3):
    ts, _ = _schedulers(tenants3)
    pair = ttr.mixed_tenant_generate(_specs(ttr, SPECS), 400, seed=6)
    want = ts.run(pair, mode="merged", merged="concat", device="cpu")
    for backend in ("jnp", "packed"):
        got = tplan.run(ts, pair, plan=tplan.ExecutionPlan(backend=backend, merged="concat", chunk_size=128),
                        device="cpu")
        assert got.merged_layout == "concat" and got.chunks == 4
        for t in range(3):
            np.testing.assert_array_equal(got.outputs_for(t), want.outputs_for(t))
    with pytest.raises(ValueError, match="single programs"):
        tplan.run(ts, pair, plan=tplan.ExecutionPlan(backend="interpreter"), device="cpu")
    # As the reference's, a scheduler runs as it does without a fleet.
    got = tplan.run(ts, pair, plan=tplan.ExecutionPlan(fleet=2, devices=2, merged="concat"), device="cpu")
    for t in range(3):
        np.testing.assert_array_equal(got.outputs_for(t), want.outputs_for(t))
    with pytest.raises(ValueError, match="merged"):
        tplan.ExecutionPlan(merged="stacked")


@given(tenant_mixes(max_tenants=3))
@settings(max_examples=2)
def test_scheduler_matches_reference_on_random_mixes(mix: TenantMixCase):
    """Random tenant sets (``tests/strategies.py``), pcap-backed tenants
    included: merged interleave on both backends and time-sliced, per-tenant
    outputs and statistics equal to the reference scheduler's."""
    built = [build_case(c) for c in mix.cases]
    tch, jch = _chips(num_elements=256, max_parallel_ops=4096)
    ts, js = tmt.SwitchScheduler(tch, quantum=mix.chunk), jmt.SwitchScheduler(jch, quantum=mix.chunk)
    for b in built:
        ts.admit(tcompiler.compile_bnn(b.params, thresholds=b.thresholds))
        js.admit(b.program)
    pair = mix_traffic(mix)
    for mode, backend in (("merged", "packed"), ("merged", "jnp"), ("time_sliced", "jnp")):
        tr = ts.run(pair, mode=mode, backend=backend, chunk_size=mix.chunk, device="cpu")
        jr = js.run(pair, mode=mode, backend=backend, chunk_size=mix.chunk)
        for t in range(mix.num_tenants):
            a, b = tr.stats_for(t), jr.stats_for(t)
            assert [getattr(a, k) for k in STATS] == [getattr(b, k) for k in STATS]
            np.testing.assert_array_equal(tr.outputs_for(t), jr.outputs_for(t), err_msg=f"{mode} {backend}")
