"""The port's one-card dry run against the reference's tooling, on the CPU:
``repro_torch.launch.shapes`` against ``repro.launch.shapes``, the
shape-only parameters and ``count_params`` against ``repro.launch.dryrun``,
``roofline.ops``' FLOPs against ``repro.roofline.hlo.analyze`` of the
compiled reference, ``roofline.analysis`` against the reference's, then
``run_cell`` at tiny sizes and ``roofline.report`` on its records.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to a 512-device host
platform; :func:`_reference_dryrun` restores the variable, so that no
later JAX backend in this process sees it.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_moe import port_config
from repro_torch import models, tree
from repro_torch.configs import base as tbase
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.kernels import bitpack
from repro_torch.launch import dryrun, shapes as tshapes
from repro_torch.models.model import cache_tensors
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import hw, kernels as costs, ops as op_counts, report

from repro.configs import base as jbase
from repro.configs.base import QuantConfig as JQuant
from repro.launch import shapes as jshapes
from repro.models import model as jm
from repro.roofline import analysis as janalysis, hlo
from repro.roofline import hw as jhw

# One arch of each family, and its input mode.
FAMILIES = {
    "phi3-mini-3.8b": "dense",
    "qwen3-moe-30b-a3b": "moe",
    "minicpm3-4b": "dense (MLA)",
    "mamba2-1.3b": "ssm",
    "zamba2-1.2b": "hybrid",
    "internvl2-2b": "vlm (tokens+patches)",
    "hubert-xlarge": "audio (frames)",
}


@functools.lru_cache(maxsize=None)
def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def _configs(arch: str, mode: str = "none", **kw):
    """(reference cfg, port cfg) of a tiny ``arch`` in ``mode``."""
    jcfg = tiny_config(arch, quant=JQuant(mode=mode), **kw)
    return jcfg, port_config(jcfg)


def _sds(x) -> tuple:
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


def _cache_fields(cache, prefix: str = "") -> dict:
    """{path: (shape, dtype)} of a decode cache of either package, nested
    caches walked, ``index`` left out."""
    out = {}
    for f in dataclasses.fields(cache):
        value = getattr(cache, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_cache_fields(value, f"{prefix}{f.name}/"))
        elif f.name != "index":
            out[prefix + f.name] = _sds(value)
    return out


def test_shapes_and_skip_rules_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in ASSIGNED_ARCHS:
        jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
        for name in tshapes.SHAPES:
            assert tshapes.runnable(tcfg, tshapes.SHAPES[name]) == jshapes.runnable(jcfg, jshapes.SHAPES[name])
            assert tshapes.microbatches_for(tcfg, tshapes.SHAPES[name], 16) == jshapes.microbatches_for(
                jcfg, jshapes.SHAPES[name], 16)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_input_stand_ins_match_reference(arch):
    """Every shape's train, prefill and decode stand-ins: the reference's
    shapes and types (the cache's fields too), on the meta device."""
    jcfg, tcfg = _configs(arch)
    small = {name: dataclasses.replace(s, seq_len=32, global_batch=2) for name, s in tshapes.SHAPES.items()}
    for name, shape in small.items():
        jshape = jshapes.Shape(**dataclasses.asdict(shape))
        got = tshapes.train_inputs(tcfg, shape)
        assert {k: _sds(v) for k, v in got.items()} == {
            k: _sds(v) for k, v in jshapes.train_inputs(jcfg, jshape).items()}
        assert all(v.device.type == "meta" for v in got.values())
        assert {k: _sds(v) for k, v in tshapes.prefill_inputs(tcfg, shape).items()} == {
            k: _sds(v) for k, v in jshapes.prefill_inputs(jcfg, jshape).items()}
        if jcfg.encoder_only:
            continue
        token, cache = tshapes.decode_inputs(tcfg, shape)
        jtoken, jcache = jshapes.decode_inputs(jcfg, jshape)
        assert _sds(token) == _sds(jtoken)
        assert _cache_fields(cache) == _cache_fields(jcache)
        assert all(t.device.type == "meta" for t in cache_tensors(cache))


def _reference_params(jcfg):
    return jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode", ["none", "bnn_packed"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_count_params_matches_reference(arch, mode, monkeypatch):
    """``count_params`` over the shape-only tree equals the reference's over
    ``jax.eval_shape(init_params)``; the tree is all meta tensors and
    nothing is packed."""
    def refuse(*args, **kwargs):
        raise AssertionError("the shape-only route packed a tensor")

    monkeypatch.setattr(bitpack, "pack_ge_plain", refuse)
    jcfg, tcfg = _configs(arch, mode)
    params = models.init_params(tcfg, device="meta")
    assert all(t.device.type == "meta" for t in tree.leaves(params))
    want = _reference_dryrun().count_params(jcfg, _reference_params(jcfg))
    assert dryrun.count_params(tcfg, params) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("mode", ["none", "bnn_packed"])
def test_count_params_at_published_width(mode):
    jcfg = dataclasses.replace(jbase.get_config("phi3-mini-3.8b"), quant=JQuant(mode=mode))
    tcfg = tbase.get_config("phi3-mini-3.8b", quant=tbase.QuantConfig(mode=mode))
    params = models.init_params(tcfg, device="meta")
    got = dryrun.count_params(tcfg, params)
    assert got == pytest.approx(_reference_dryrun().count_params(jcfg, _reference_params(jcfg)), rel=1e-12)
    assert got[0] == 3_722_578_944.0
    assert dryrun.tree_bytes(params) == (7_445_157_888 if mode == "none" else 654_448_640)


def _hlo_flops(fn, *args) -> float:
    return hlo.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


@functools.lru_cache(maxsize=None)
def _phi3(layers: int):
    """(reference cfg, port cfg, reference params, port params, tokens) of
    tiny float32 phi3 with ``layers`` layers."""
    jcfg, tcfg = _configs("phi3-mini-3.8b", num_layers=layers, dtype="float32", init_std=0.5)
    jp = jax.jit(functools.partial(jm.init_params, jcfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, tcfg, jp, models.init_params(tcfg, 0, device="cpu"), tokens


@pytest.mark.parametrize("layers, flops", [(2, 11_280_384), (4, 21_766_144)])
def test_forward_flops_equal_hlo_analyze(layers, flops):
    """The op-level count of the port's forward equals the scan-aware HLO
    count of the reference's compiled forward (tokens (2, 32))."""
    jcfg, tcfg, jp, tp, tokens = _phi3(layers)
    want = _hlo_flops(lambda p, t: jm.forward(p, {"tokens": t}, jcfg), jp, tokens)
    with torch.no_grad(), op_counts.count() as counts:
        models.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert want == flops
    assert counts.flops == want
    assert dict(counts.flops_by_dtype) == {"float32": want}
    assert counts.bytes > 0 and counts.kernel_launches == {}


@pytest.mark.parametrize("layers", [2, 4])
def test_decode_step_flops_equal_hlo_analyze(layers):
    """One decode step against a 32-position cache: the same FLOPs on both
    sides (the score and output products over the whole cache, the
    projections and the head)."""
    jcfg, tcfg, jp, tp, tokens = _phi3(layers)
    want = _hlo_flops(lambda p, t, c: jm.decode_step(p, t, c, jcfg), jp, tokens[:, 0], jm.init_cache(jcfg, 2, 32))
    cache = models.init_cache(tcfg, 2, 32, device="cpu")
    with op_counts.count() as counts:
        models.decode_step(tp, torch.from_numpy(tokens[:, 0]), cache, tcfg)
    assert counts.flops == want


def test_counts_charge_kernel_costs_and_skip_views():
    """A kernel's cost goes where a wrapper charges it; views and
    allocations move no bytes; an op charges its operands and output."""
    x = torch.ones((4, 64))
    cost = costs.bnn_matmul_packed(4, 8, 2)
    with op_counts.count() as counts:
        x.T.reshape(64, 4)
        torch.empty((1024,))
        op_counts.charge("bnn_matmul_packed", costs.bnn_matmul_packed, 4, 8, 2)
    assert counts.bytes == 0 and counts.aten_ops == 0
    assert counts.kernel_launches == {"bnn_matmul_packed": 1}
    assert counts.kernel_bytes == cost.bytes and counts.kernel_seconds == cost.ops / hw.INT8_TENSOR_OPS
    with op_counts.count() as counts:
        x + x[:1]
    assert counts.bytes == (4 * 64 + 64 + 4 * 64) * 4 and counts.aten_ops == 1
    assert counts.top_ops() == [["aten.add:float32", counts.bytes, 1]]
    op_counts.charge("bnn_matmul_packed", costs.bnn_matmul_packed, 4, 8, 2)   # no count open
    assert counts.kernel_launches == {}


def test_roofline_matches_reference():
    assert tanalysis.model_flops_estimate(3.7e9, 4096, "train") == janalysis.model_flops_estimate(3.7e9, 4096, "train")
    assert tanalysis.model_flops_estimate(3.7e9, 128, "decode") == janalysis.model_flops_estimate(3.7e9, 128, "decode")
    for compute_s, memory_s in ((2.0, 1.0), (0.5, 3.0)):
        common = dict(arch="a", shape="s", mesh="m", chips=1, hlo_flops=8e12, hlo_bytes=1e12,
                      collective_bytes_per_chip=0.0, model_flops=6e12, compute_s=compute_s,
                      memory_s=memory_s, collective_s=0.0, collective_detail={})
        got, want = tanalysis.Roofline(**common), janalysis.Roofline(**common)
        assert got.bottleneck == want.bottleneck
        assert got.step_time_s == want.step_time_s
        assert got.useful_flops_fraction == want.useful_flops_fraction
        assert got.roofline_fraction * hw.BF16_TENSOR_FLOPS == pytest.approx(
            want.roofline_fraction * jhw.PEAK_FLOPS_BF16, rel=1e-12)
        assert set(want.row()) | {"measured_step_s", "mfu", "floor_bytes", "floor_s", "floor_fraction"} == set(
            got.row())
    counts = op_counts.OpCounts()
    counts.flops_by_dtype.update(bfloat16=989e12, float32=66.9e12)
    counts.bytes, counts.kernel_bytes, counts.kernel_seconds = 3.35e12, 3.35e12, 0.5
    roof = tanalysis.build(arch="a", shape="s", counts=counts, model_flops=989e12, measured_step_s=4.0)
    assert roof.compute_s == pytest.approx(2.5) and roof.memory_s == pytest.approx(2.0)
    assert roof.collective_s == 0.0 and roof.collective_detail == {} and roof.bottleneck == "compute"
    assert roof.roofline_fraction == pytest.approx(0.4) and roof.mfu == pytest.approx(0.25)
    assert roof.floor_s == pytest.approx(1.0) and roof.floor_fraction == pytest.approx(0.25)
    roof = tanalysis.build(arch="a", shape="s", counts=counts, model_flops=989e12, measured_step_s=4.0,
                           floor_bytes=2 * 3.35e12)
    assert roof.floor_s == pytest.approx(2.0) and roof.row()["floor_bytes"] == 2 * 3.35e12


TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=97, max_seq_len=128, attn_q_chunk=16, microbatches=2, fsdp=False)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Tiny cells of phi3 (train, prefill, decode at seq 32, global batch
    4), the reference's two skip rules, a cell too big for a 1 MB card and
    one run in ``bnn_packed``, written to one directory."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    recs = {}
    for kind in ("train", "prefill", "decode"):
        shape = tshapes.Shape(f"tiny_{kind}", 32, 4, kind)
        recs[kind] = dryrun.run_cell("phi3-mini-3.8b", shape.name, out, TINY, device="cpu", shape=shape, steps=2)
    recs["packed"] = dryrun.run_cell(
        "phi3-mini-3.8b", "tiny_decode", out, dict(TINY, quant=tbase.QuantConfig(mode="bnn_packed")),
        "+bnn_packed", device="cpu", shape=tshapes.Shape("tiny_decode", 32, 4, "decode"), steps=1)
    recs["encoder"] = dryrun.run_cell("hubert-xlarge", "decode_32k", out, TINY, device="cpu")
    recs["long"] = dryrun.run_cell("phi3-mini-3.8b", "long_500k", out, TINY, device="cpu")
    recs["big"] = dryrun.run_cell("phi3-mini-3.8b", "train_4k", out, TINY, device="cpu", card_bytes=1 << 20)
    return out, recs


def test_run_cell_on_the_cpu(records):
    _, recs = records
    for kind in ("train", "prefill", "decode"):
        rec = recs[kind]
        assert rec["status"] == "ok" and rec["batch"] == rec["global_batch"] == 4, rec
        assert rec["microbatches"] == (2 if kind == "train" else 1)
        assert rec["output"]["finite"] and len(rec["step_s"]["all"]) == 2
        assert rec["memory"]["peak_bytes"] is None and rec["memory"]["fits_card"]
        assert rec["memory"]["estimate_bytes"] is None and rec["measure_s"] is None   # nothing measured here
        roof = rec["roofline"]
        assert roof["hlo_flops_per_dev"] > 0 and roof["collective_s"] == 0.0 and roof["mesh"] == "h100"
        assert 0 < roof["roofline_fraction"] and 0 < roof["mfu"]
        assert roof["floor_bytes"] == rec["memory"]["resident_bytes"]["total"] + dryrun.input_bytes(
            tbase.get_config("phi3-mini-3.8b", **TINY), tshapes.Shape(f"tiny_{kind}", 32, 4, kind), 4)
        assert 0 < roof["floor_s"] <= roof["step_time_s"]
        top = rec["counts"]["top_ops_by_bytes"]
        assert 0 < len(top) <= op_counts.TOP_OPS and sum(b for _, b, _ in top) <= rec["counts"]["aten_bytes"]
        assert rec["launches"] == {} and rec["counts"]["kernel_launches"] == {}
    assert recs["decode"]["output"]["shape"] == [4, TINY["vocab_size"]]
    assert recs["train"]["counts"]["flops_by_dtype"]["bfloat16"] > 0
    assert recs["packed"]["n_params"] == recs["decode"]["n_params"]
    assert recs["packed"]["memory"]["resident_bytes"]["params"] < recs["decode"]["memory"]["resident_bytes"]["params"]
    assert recs["encoder"] == {"cell": "hubert-xlarge_decode_32k_h100", "arch": "hubert-xlarge",
                               "shape": "decode_32k", "quant": "none", "status": "skipped",
                               "reason": "encoder-only arch has no decode step"}
    assert recs["long"]["status"] == "skipped" and "sub-quadratic" in recs["long"]["reason"]
    big = recs["big"]
    assert big["status"] == "does_not_fit" and big["batch"] is None and big["global_batch"] == 256
    resident = big["memory"]["resident_bytes"]
    assert resident["total"] > big["memory"]["budget_bytes"] == int(0.9 * (1 << 20))
    assert resident["total"] == resident["params"] + resident["optimizer"] + resident["grads"]
    assert big["memory"]["why"] == "resident bytes" and big["memory"]["estimate_bytes"] is None
    assert big["model_flops"] == tanalysis.model_flops_estimate(big["n_active_params"], 256 * 4096, "train")


def test_resident_bytes_and_batch_choice():
    """Resident bytes are exact (allocated on the CPU they are the same);
    the batch is the largest power of two whose resident bytes and measured
    activations (per sequence of a pass: a microbatch's in training) fit."""
    cfg = tbase.get_config("phi3-mini-3.8b", **TINY)
    shape = tshapes.Shape("tiny_decode", 32, 64, "decode")
    cache = models.init_cache(cfg, 8, 32, device="cpu")
    got = dryrun.resident_bytes(cfg, shape, 8)
    assert got["cache"] == sum(t.numel() * t.element_size() for t in cache_tensors(cache))
    assert got["params"] == dryrun.tree_bytes(models.init_params(cfg, 0, device="cpu"))
    per_row = 1 << 20
    need = got["total"] + 8 * per_row
    plan = dryrun.choose_batch(cfg, shape, int(need / dryrun.CARD_FRACTION) + 1, per_row)
    assert plan["batch"] == 8 and plan["estimate"] == 8 * per_row and plan["resident"] == got
    assert dryrun.choose_batch(cfg, shape, int(need / dryrun.CARD_FRACTION) - 1, per_row)["batch"] == 4
    assert dryrun.choose_batch(cfg, shape, 1 << 40, None) == {
        "batch": 64, "resident": dryrun.resident_bytes(cfg, shape, 64), "estimate": None,
        "budget": int(dryrun.CARD_FRACTION * (1 << 40))}
    refused = dryrun.choose_batch(cfg, shape, got["params"], per_row)
    assert refused["batch"] is None and refused["estimate"] == per_row
    train = tshapes.Shape("tiny_train", 32, 64, "train")
    assert [dryrun.rows_per_pass(cfg, train, b) for b in (1, 2, 8)] == [1, 1, 4]
    assert dryrun.input_bytes(cfg, train, 8) == 2 * 8 * 32 * 4   # tokens and labels, int32
    assert dryrun.input_bytes(cfg, shape, 8) == 8 * 4


@pytest.mark.parametrize("per_row, status, why", [
    (None, "does_not_fit", "out of memory at batch 1"),
    (1 << 40, "does_not_fit", "resident bytes + batch 1's activations"),
    (1 << 10, "ok", None),
])
def test_run_cell_batch_from_the_measurement(tmp_path, monkeypatch, per_row, status, why):
    """The batch-1 measurement decides: out of memory at batch 1 or too
    many activations refuse the cell; else its bytes per sequence choose
    the batch (the measurement stubbed; the card's memory is measured
    only on a card)."""
    seen = []

    def measure(cfg, shape, params, device):
        seen.append(shape.name)
        return per_row, None

    monkeypatch.setattr(dryrun, "MEASURED", ("cpu",))
    monkeypatch.setattr(dryrun, "measure_per_row", measure)
    shape = tshapes.Shape("tiny_prefill", 32, 4, "prefill")
    rec = dryrun.run_cell("phi3-mini-3.8b", shape.name, str(tmp_path), TINY, device="cpu", shape=shape, steps=1)
    assert seen == ["tiny_prefill"] and rec["status"] == status, rec
    if status == "ok":
        cfg = tbase.get_config("phi3-mini-3.8b", **TINY)
        assert rec["batch"] == 4 and rec["memory"]["estimate_bytes"] == 4 * per_row
        assert rec["memory"]["resident_bytes"] == dryrun.resident_bytes(cfg, shape, 4)
    else:
        assert rec["batch"] is None and rec["memory"]["why"] == why
        assert rec["memory"]["resident_bytes"]["cache"] == dryrun.resident_bytes(
            tbase.get_config("phi3-mini-3.8b", **TINY), shape, 1)["cache"]


def test_report_renders_both_tables(records):
    out, recs = records
    loaded = report.load(out)
    assert len(loaded) == len(recs)
    table = report.dryrun_table(loaded)
    assert "| phi3-mini-3.8b | tiny_train | ok | 4 / 4 | 2 |" in table
    assert "skipped: encoder-only arch has no decode step" in table
    assert "| phi3-mini-3.8b | train_4k | does not fit | 0 / 256 |" in table
    one = report.one_table(loaded)
    assert one.count("\n") == len(recs) + 1 and "| phi3-mini-3.8b | tiny_decode | 4 / 4 |" in one
    roof = report.roofline_table(loaded)
    assert sum(line.startswith("| phi3-mini-3.8b") for line in roof.splitlines()) == 4
    assert roof.count("**memory**") + roof.count("**compute**") == 4


def test_hillclimb_reports_cells_that_do_not_fit(monkeypatch, capsys):
    """Cells A and B (deepseek-v2 and chatglm3 train_4k) do not fit an
    80 GB card: reported, not run, ``ar_bf16`` named as meaningless."""
    from repro_torch.launch import hillclimb

    monkeypatch.setattr(dryrun, "card_bytes_of", lambda device: 85_017_493_504)
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: pytest.fail("a cell that does not fit ran"))
    assert hillclimb.main(["--only", "A1,B3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    assert out[1].startswith("[A1] deepseek-v2-236b train_4k +arbf16: does not fit one card")
    assert out[2].startswith("[B3] chatglm3-6b train_4k +arbf16+sbf16+mb4: does not fit one card")
    assert all("ar_bf16 has no meaning on one device" in line for line in out[1:])
