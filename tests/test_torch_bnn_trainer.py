"""Port train -> export -> deploy loop: ``core.bnn.binarize_ste``,
``core.export``, ``core.p4gen``, ``optim.adamw``, ``train.checkpoint`` and
``train.bnn_trainer`` against the reference's, on the CPU.

The reference draws its initial latent from ``jax.random``, which the port
does not reproduce, so the trainer tests carry the reference's latent across
(``convert.bnn_latent_from_jax``) with a fresh ``optimizer.init``; batches
are numpy-drawn by ``(seed, step)`` in both packages.  Bits compare with
``assert_array_equal``.

Float tolerance: ``rtol=1e-5, atol=1e-6``.  The trainer's values are of
order 1 (latents in [-1, 1], a loss near 0.7, unit-scale moments), and the
two packages sum the same float32 terms in different orders (XLA's fused,
jitted reductions against PyTorch's kernels), so they part at a few float32
ulps (1.2e-7 relative) a step; after three steps the measured gap is below
1e-7.  The bound leaves two decades for that without hiding a wrong update,
which moves values by the learning rate (0.02).
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import tree as ttree
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import export as texport
from repro_torch.core import p4gen as tp4
from repro_torch.core import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.train import bnn_trainer as tt
from repro_torch.train import checkpoint as tckpt

from repro.core import bnn as jbnn
from repro.core import compiler as jcompiler
from repro.core import export as jexport
from repro.core import p4gen as jp4
from repro.core import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import bnn_trainer as jt
from repro.train import checkpoint as jckpt

RTOL, ATOL = 1e-5, 1e-6
TINY = dict(layer_sizes=(16, 24, 8, 1), batch=64, train_packets_per_class=256,
            eval_packets_per_class=64, log_every=1)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what)


def _pair(steps, **kw):
    """A reference trainer and a port trainer on the CPU holding the same
    latent (the reference's, carried across) and a fresh AdamW state."""
    j = jt.BnnTrainer(jt.BnnTrainConfig(**TINY, steps=steps, **kw))
    t = tt.BnnTrainer(tt.BnnTrainConfig(**TINY, steps=steps, **kw), device="cpu")
    t.latent = convert.bnn_latent_from_jax([np.asarray(w) for w in j.latent], device="cpu")
    t.opt_state = t.optimizer.init(t.latent)
    return j, t


# -- the STE primitive ------------------------------------------------------------

def test_binarize_ste_matches_reference_forward_and_gradient():
    rng = np.random.default_rng(0)
    w = rng.uniform(-2, 2, 200).astype(np.float32)
    w[:8] = [0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1.0000001, -1.0000001]
    g = rng.standard_normal(200).astype(np.float32)
    jw = jnp.asarray(w)
    want = np.asarray(jbnn.binarize_ste(jw))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(jbnn.binarize_ste(v) * g))(jw))
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tbnn.binarize_ste(tw)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tw.grad.numpy(), want_grad)
    for a, b in zip(tbnn.params_from_latent([torch.from_numpy(w.reshape(10, 20))]),
                    jbnn.params_from_latent([jw.reshape(10, 20)])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_forward_bits_is_the_deployed_network():
    j, t = _pair(steps=0)
    x = t.eval_x
    got = t.forward_bits(x)
    np.testing.assert_array_equal(got, j.forward_bits(x))
    weights = [torch.from_numpy(w) for w in texport.bit_weights_from_latent(t.latent)]
    np.testing.assert_array_equal(got, tbnn.forward(weights, torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(t.oracle_bits(x), got)
    # latent ties at 0.0 round to bit 1 on both sides
    np.testing.assert_array_equal(texport.bit_weights_from_latent([torch.zeros((2, 4))])[0],
                                  np.ones((2, 4), np.int32))


# -- the trainer ------------------------------------------------------------------

def test_tasks_match_reference():
    for a, b in zip(tt.make_traffic_task(("iot_telemetry", "ddos_burst"), 40, 16, seed=3,
                                         eval_per_class=9),
                    jt.make_traffic_task(("iot_telemetry", "ddos_burst"), 40, 16, seed=3,
                                         eval_per_class=9)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    bits, labels = rng.integers(0, 2, (50, 16)), rng.integers(0, 2, 50)
    for a, b in zip(tt.make_capture_task(bits, labels, seed=2), jt.make_capture_task(bits, labels, seed=2)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tt.make_capture_task(bits, labels + 2)
    with pytest.raises(ValueError):
        tt.BnnTrainConfig(scenarios=("iot_telemetry",))
    with pytest.raises(ValueError):
        tt.BnnTrainConfig(layer_sizes=(8, 2))


def test_training_steps_match_reference():
    """Loss, accuracy, gradient norm, AdamW state and latent after one and
    after three steps, within the module's float32 tolerance; the deployed
    bits stay equal."""
    j, t = _pair(steps=1)
    for steps in (1, 3):
        j.cfg.steps = t.cfg.steps = steps
        j.train()
        t.train()
        for hj, ht in zip(j.history, t.history):
            assert hj["step"] == ht["step"]
            for key in ("loss", "accuracy", "grad_norm", "lr"):
                _close(ht[key], hj[key], what=f"step {hj['step']} {key}")
        assert int(t.opt_state.step) == int(j.opt_state.step) == steps
        for name in ("m", "v"):
            for a, b in zip(getattr(t.opt_state, name), getattr(j.opt_state, name)):
                _close(a, b, what=f"{name} after {steps} steps")
        for a, b in zip(t.latent, j.latent):
            _close(a, b, what=f"latent after {steps} steps")
        np.testing.assert_array_equal(t.forward_bits(t.eval_x), j.forward_bits(j.eval_x))
        assert t.evaluate_held_out() == j.evaluate_held_out()


def test_checkpoint_resume_replays_an_uninterrupted_run(tmp_path):
    straight = tt.BnnTrainer(tt.BnnTrainConfig(**TINY, steps=6), device="cpu")
    straight.train()
    cfg = tt.BnnTrainConfig(**TINY, steps=3, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    first = tt.BnnTrainer(cfg, device="cpu")
    assert not first.train()["resumed"]
    resumed = tt.BnnTrainer(dataclasses.replace(cfg, steps=6), device="cpu")
    summary = resumed.train()
    assert summary["resumed"] and summary["final_step"] == 6
    for a, b in zip(straight.latent, resumed.latent):
        assert torch.equal(a, b)
    for a, b in zip(ttree.leaves(straight.opt_state), ttree.leaves(resumed.opt_state)):
        assert torch.equal(a, b)
    assert tckpt.available_steps(cfg.checkpoint_dir) == [2, 3, 4, 6]


def test_roundtrip_over_a_multi_hop_fabric_has_no_mismatch():
    j, t = _pair(steps=2)
    t.train()
    ex = t.export()
    assert ex.program.fingerprint() == jexport.export_latent([w.numpy() for w in t.latent]).program.fingerprint()
    chip = tpipe.ChipSpec(num_elements=max(1, ex.program.num_elements // 3))
    for mode in ("multi_hop", "recirculate"):
        for backend in ("jnp", "packed"):
            rep = texport.verify_roundtrip(ex, t.eval_x, mode=mode, fabric_chip=chip, backend=backend,
                                           chunk_size=50, reference_bits=t.forward_bits(t.eval_x),
                                           device="cpu")
            assert rep.ok and rep.hops >= 3 and rep.mode == mode
            assert (rep.executor_mismatches, rep.fabric_mismatches, rep.reference_mismatches) == (0, 0, 0)
    flipped = 1 - t.forward_bits(t.eval_x)
    with pytest.raises(texport.ExportError, match="FAILED"):
        texport.verify_roundtrip(ex, t.eval_x, reference_bits=flipped, device="cpu")
    rep = texport.verify_roundtrip(ex, t.eval_x, reference_bits=flipped, check=False, device="cpu")
    assert rep.reference_mismatches == t.eval_x.shape[0]


# -- export ------------------------------------------------------------------------

def test_saved_models_load_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    ws = [rng.integers(0, 2, (12, 16)).astype(np.int32), rng.integers(0, 2, (3, 12)).astype(np.int32)]
    jex = jexport.export_bits(ws)
    jex.save(str(tmp_path / "ref"))
    tex = texport.load(str(tmp_path / "ref"))
    assert tex.program.fingerprint() == jex.program.fingerprint()
    assert tex.lowered.fingerprint() == jex.lowered.fingerprint()
    tex.save(str(tmp_path / "port"))
    with open(tmp_path / "ref" / "manifest.json") as a, open(tmp_path / "port" / "manifest.json") as b:
        assert a.read() == b.read()
    assert jexport.load(str(tmp_path / "port")).program.fingerprint() == jex.program.fingerprint()
    with pytest.raises(texport.ExportError, match="fingerprint"):
        texport.load(str(tmp_path / "ref"), tpipe.RMT_NATIVE_POPCNT)
    x = rng.integers(0, 2, (40, 16)).astype(np.int32)
    np.testing.assert_array_equal(tex.oracle_forward(x, device="cpu"), jex.oracle_forward(x))


@pytest.mark.parametrize("bad", [
    [],
    [np.array([0, 1])],
    [np.array([[0, 2]])],
    [np.ones((4, 8), np.int32), np.ones((2, 5), np.int32)],
], ids=["empty", "1-D", "not-bits", "fan-in"])
def test_export_bits_rejects_bad_weights(bad):
    with pytest.raises(texport.ExportError):
        texport.export_bits(bad)


def test_p4gen_matches_reference():
    rng = np.random.default_rng(5)
    params = [rng.integers(0, 2, (16, 32)).astype(np.int32), rng.integers(0, 2, (4, 16)).astype(np.int32)]
    tprog, jprog = tcompiler.compile_bnn(params), jcompiler.compile_bnn(params)
    assert tp4.generate_p4(tprog) == jp4.generate_p4(jprog)
    assert tp4.generate_p4(tprog, name="x") == jp4.generate_p4(jprog, name="x")


# -- AdamW and checkpoints -----------------------------------------------------------

def _param_tree(rng, dtype=np.float32):
    return {"b": rng.standard_normal((5,)).astype(dtype),
            "a": [rng.standard_normal((3, 4)).astype(dtype), rng.standard_normal((2,)).astype(dtype)]}


@pytest.mark.parametrize("kw", [
    dict(lr=0.02, weight_decay=0.0, use_master=False),
    dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5),
    dict(lr="cosine", weight_decay=0.05, moment_dtype="bfloat16", use_master=False),
], ids=["trainer", "clipped-decay-master", "cosine-bf16-moments"])
def test_adamw_matches_reference(kw):
    rng = np.random.default_rng(6)
    params = _param_tree(rng)
    bf16 = kw.get("moment_dtype") == "bfloat16"
    tkw, jkw = dict(kw), dict(kw)
    if kw["lr"] == "cosine":
        tkw["lr"] = tadamw.cosine_schedule(0.05, 2, 10)
        jkw["lr"] = jadamw.cosine_schedule(0.05, 2, 10)
    if bf16:
        tkw["moment_dtype"], jkw["moment_dtype"] = torch.bfloat16, jnp.bfloat16
    topt, jopt = tadamw.AdamW(**tkw), jadamw.AdamW(**jkw)
    tp = ttree.map(torch.from_numpy, params)
    jp = jax.tree.map(jnp.asarray, params)
    ts, js = topt.init(tp), jopt.init(jp)
    for step in range(3):
        grads = ttree.map(lambda p: (3.0 * rng.standard_normal(p.shape)).astype(np.float32), params)
        tp, ts, tm = topt.update(ttree.map(torch.from_numpy, grads), ts, tp)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        for key in ("grad_norm", "lr"):
            _close(tm[key], jm[key], what=key)
        for a, b in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
            _close(a, b, what=f"params at step {step}")
        for a, b in zip(ttree.leaves((ts.m, ts.v, ts.master)), jax.tree.leaves((js.m, js.v, js.master))):
            assert a.shape == b.shape
            # a bf16 moment rounds a float32 value that may sit one ulp apart
            _close(a, np.asarray(b, np.float32), rtol=2 ** -7 if bf16 else RTOL, what=f"state at {step}")
        assert int(ts.step) == int(js.step) == step + 1
    assert ts.m["b"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(tadamw.global_norm(ttree.map(torch.from_numpy, params)),
           jadamw.global_norm(jax.tree.map(jnp.asarray, params)))


def test_checkpoints_restore_across_packages(tmp_path):
    rng = np.random.default_rng(7)
    params = _param_tree(rng)
    bf16 = rng.standard_normal((3, 2)).astype(np.float32)
    topt, jopt = tadamw.AdamW(use_master=False), jadamw.AdamW(use_master=False)
    tbundle = {"latent": ttree.map(torch.from_numpy, params), "opt": topt.init(ttree.map(torch.from_numpy, params)),
               "h": torch.from_numpy(bf16).to(torch.bfloat16)}
    jbundle = {"latent": jax.tree.map(jnp.asarray, params), "opt": jopt.init(jax.tree.map(jnp.asarray, params)),
               "h": jnp.asarray(bf16, jnp.bfloat16)}
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(tdir, 7, tbundle, {"step": 7})
    jckpt.save(jdir, 7, jbundle, {"step": 7})
    with open(os.path.join(tdir, "step_00000007", "manifest.json")) as a, \
            open(os.path.join(jdir, "step_00000007", "manifest.json")) as b:
        assert a.read() == b.read()  # same structure, shapes, dtypes and bytes
    got, step, extras = tckpt.restore_latest(jdir, tbundle)
    assert (step, extras) == (7, {"step": 7}) and got["h"].dtype == torch.bfloat16
    for a, b in zip(ttree.leaves(got), ttree.leaves(tbundle)):
        assert torch.equal(a, b)
    jgot, _, _ = jckpt.restore_latest(tdir, jbundle)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jbundle)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    # a corrupt newest step falls back to the older one
    tckpt.save(tdir, 9, tbundle)
    with open(os.path.join(tdir, "step_00000009", "arr_00000.npy"), "ab") as f:
        f.write(b"x")
    assert tckpt.restore_latest(tdir, tbundle)[1] == 7
    assert tckpt.restore_latest(str(tmp_path / "none"), tbundle) is None
    assert ttree.describe(tbundle) == str(jax.tree_util.tree_structure(jbundle))
