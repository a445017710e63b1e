"""The port's ``Trainer`` (``repro_torch.train.trainer``), ``rescale`` and
training launcher on the CPU: the reference's five trainer tests
(``tests/test_trainer.py``) on the port, ``launch.train.reduced`` against
``examples/train_lm.py::reduced`` for the ten archs, and ``main`` at
``--reduced`` for each of them.

The config is the reference tests' (``tiny_config("phi3-mini-3.8b",
num_layers=2, vocab_size=64)``, bf16).  On the CPU the port is
deterministic, so a failed and recovered run reaches the same bits as an
unfailed one (the reference allows 1e-5).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_moe import port_config
from test_torch_serve_launch import _fields
from repro_torch import tree
from repro_torch.configs import base as tbase
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.launch import train as launch
from repro_torch.train.elastic import rescale
from repro_torch.train.trainer import Trainer, TrainerConfig, eval_loss

from examples.train_lm import reduced as jreduced
from repro.configs import get_config as jget

SSM_ARCHS = ("mamba2-1.3b", "zamba2-1.2b")


def _mk(tmp_path, **kw):
    cfg = port_config(tiny_config("phi3-mini-3.8b", num_layers=2, vocab_size=64))
    defaults = dict(
        total_steps=10, checkpoint_every=4, checkpoint_dir=str(tmp_path),
        global_batch=4, seq_len=32, log_every=2,
    )
    defaults.update(kw)
    return Trainer(cfg, TrainerConfig(**defaults), device="cpu")


# -- the reference's trainer tests, on the port ------------------------------------

def test_loss_decreases(tmp_path):
    t = _mk(tmp_path, total_steps=30)
    out = t.run()
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert len(losses) >= 3
    assert losses[-1] < losses[0], f"no learning: {losses}"


def test_recovers_from_injected_failure(tmp_path):
    t = _mk(tmp_path, total_steps=10, fail_at_steps=(6,))
    out = t.run()
    assert out["final_step"] == 10
    assert out["recoveries"] == 1
    fails = [h for h in out["history"] if h.get("event") == "failure"]
    assert len(fails) == 1 and fails[0]["restored"] and fails[0]["step"] == 4  # the checkpoint's step


def test_recovery_is_deterministic(tmp_path):
    """A failed and recovered run reaches the parameters and optimizer
    state of an unfailed run, bit for bit, on the trainer's device with the
    stored dtypes."""
    t1 = _mk(tmp_path / "a", total_steps=8, checkpoint_every=4)
    t1.run()
    t2 = _mk(tmp_path / "b", total_steps=8, checkpoint_every=4, fail_at_steps=(6,))
    t2.run()
    assert t2.recoveries == 1 and t2.data.state.step == t1.data.state.step == 8
    for a, b in zip(tree.leaves((t1.params, t1.opt_state)), tree.leaves((t2.params, t2.opt_state)), strict=True):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["sign", "int8", "topk"])
def test_gradient_compression_variants(tmp_path, kind):
    t = _mk(tmp_path / kind, total_steps=6, compression=kind)
    out = t.run()
    assert out["final_step"] == 6
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert losses and all(np.isfinite(losses))
    assert all(e.dtype == torch.float32 for e in tree.leaves(t.error_fb))


def test_elastic_rescale(tmp_path):
    """``rescale`` on one card: the latest checkpoint restored onto a
    device with its stored dtypes (the reference's 1 x 1-mesh case)."""
    t = _mk(tmp_path, total_steps=4, checkpoint_every=2)
    t.run()
    got = rescale(t.cfg, str(tmp_path), {"params": t.params, "opt": t.opt_state}, "cpu")
    assert got is not None
    bundle, step, extras = got
    assert step == 4 and extras == {"data": {"seed": 0, "step": 4}, "step": 4}
    for a, b in zip(tree.leaves((t.params, t.opt_state)), tree.leaves((bundle["params"], bundle["opt"])),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert rescale(t.cfg, str(tmp_path / "empty"), {"params": t.params}, "cpu") is None


# -- the trainer's own behaviour ----------------------------------------------------

def test_stragglers_are_reported(tmp_path, monkeypatch):
    """A step slower than ``straggler_factor`` x the EMA is recorded and
    passed to ``on_straggler``; the step's time includes its device work."""
    clock = iter([0.0, 1.0, 10.0, 11.0, 20.0, 30.0, 40.0, 41.0])
    monkeypatch.setattr("repro_torch.train.trainer.time.perf_counter", lambda: next(clock))
    seen = []
    cfg = port_config(tiny_config("phi3-mini-3.8b", num_layers=1, vocab_size=64))
    t = Trainer(cfg, TrainerConfig(total_steps=4, checkpoint_every=10, checkpoint_dir=str(tmp_path),
                                   global_batch=2, seq_len=8), device="cpu",
                on_straggler=lambda *ev: seen.append(ev))
    out = t.run()
    assert out["stragglers"] == [{"step": 2, "dt": 10.0, "ema": 1.0}] and seen == [(2, 10.0, 1.0)]


def test_eval_loss_and_device_default(tmp_path):
    t = _mk(tmp_path, total_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in t.data.next_batch().items()}
    loss = eval_loss(t.cfg, t.params, batch)
    assert math.isfinite(loss) and abs(loss - math.log(64)) < 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(t.cfg, t.tcfg)


# -- the launcher ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_reduced_is_the_reference_reduced(arch):
    assert _fields(launch.reduced(tbase.get_config(arch))) == _fields(jreduced(jget(arch)))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_main_trains_every_arch_at_reduced(arch, tmp_path, capsys):
    """Two steps of each arch at ``--reduced`` (batch 2; internvl2's
    sequence holds its 256 patches and 8 tokens).  The loss is finite; the
    SSM archs' gradients are NaN, as the reference's are at the recipe's
    chunk of 32 (ROADMAP Facts)."""
    seq = 264 if arch == "internvl2-2b" else 16
    out = launch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", str(seq), "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and out["recoveries"] == 0
    first = out["history"][0]
    assert first["step"] == 1 and math.isfinite(first["loss"])
    assert math.isnan(first["grad_norm"]) == (arch in SSM_ARCHS)
    assert "done at step 2; recoveries=0" in capsys.readouterr().out


def test_main_recovers_with_microbatches_and_compression(tmp_path):
    out = launch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--microbatches", "2", "--compression", "sign",
                       "--quant", "bnn_weight_only", "--inject-failure", "1", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and out["recoveries"] == 1
    # step 1 logged, the failure at step 1 restored to step 0's checkpoint, step 1 logged again
    assert [h["step"] for h in out["history"]] == [1, 0, 1]


def test_main_refuses_distributed():
    with pytest.raises(SystemExit):
        launch.main(["--arch", "phi3-mini-3.8b", "--distributed", "--device", "cpu"])
