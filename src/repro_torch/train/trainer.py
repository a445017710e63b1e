"""Training loop with fault tolerance (the reference's ``train/trainer.py``).

  * periodic atomic checkpoints (params + optimizer + data-pipeline state)
    through ``train/checkpoint.py``, one at step 0 and one at the end;
  * crash recovery: any step exception restores the latest valid checkpoint
    onto the trainer's device and replays (the data pipeline is
    (seed, step)-deterministic, so the restored run reaches the parameters
    of an uninterrupted one);
  * straggler mitigation: each step's wall time, the device's work included
    (the metrics' ``float()`` waits for it), is tracked with an EMA; steps
    slower than ``straggler_factor`` x EMA are recorded and passed to
    ``on_straggler``;
  * optional error-feedback gradient compression (``optim/compression.py``)
    between accumulation and the optimizer;
  * fault injection for tests: ``fail_at_steps`` raises inside the step.

The step updates the parameters and optimizer state in place
(``AdamW.update_``).  LM checkpoints hold the port's tree: ``"layers"`` is a
list of per-layer dicts, where the reference stacks them, so the two
packages do not restore each other's LM checkpoints (``convert`` carries
parameters across).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PipelineState, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import Compressor
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import rescale
from repro_torch.train.train_step import _accumulate_grads, loss_fn, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    microbatches: int = 1
    straggler_factor: float = 3.0
    compression: str = "none"
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 64
    fail_at_steps: tuple[int, ...] = ()   # fault injection (tests)


class Trainer:
    """Trains ``cfg`` from ``init_params(cfg, tcfg.seed)`` on ``device``
    (default ``"cuda"``, which raises without a GPU)."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        *,
        optimizer: Optional[AdamW] = None,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW(lr=1e-3)
        self.on_straggler = on_straggler
        self.compressor = Compressor(kind=tcfg.compression)
        self.history: list[dict] = []
        self.straggler_events: list[dict] = []
        self.recoveries = 0

        self.data = SyntheticTokens(
            cfg, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            seed=tcfg.seed,
        )
        self.params = init_params(cfg, tcfg.seed, device=self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.error_fb = (
            self.compressor.init_error(self.params)
            if tcfg.compression != "none" else None
        )
        self._step_fn = self._build_step()
        self.step = 0

    # -- internals -----------------------------------------------------------

    def _build_step(self):
        base = make_train_step(self.cfg, self.optimizer, microbatches=self.tcfg.microbatches)
        if self.tcfg.compression == "none":
            return base

        def step_with_compression(params, opt_state, error, batch):
            grads, metrics = _accumulate_grads(params, batch, self.cfg, self.tcfg.microbatches)
            grads, error, _ = self.compressor.compress_decompress(grads, error)
            params, opt_state, om = self.optimizer.update_(grads, opt_state, params)
            return params, opt_state, error, dict(metrics, **om)

        return step_with_compression

    def _save(self):
        bundle = {"params": self.params, "opt": self.opt_state}
        extras = {"data": self.data.state.to_dict(), "step": self.step}
        ckpt.save(self.tcfg.checkpoint_dir, self.step, bundle, extras)

    def _restore(self) -> bool:
        like = {"params": self.params, "opt": self.opt_state}
        got = rescale(self.cfg, self.tcfg.checkpoint_dir, like, self.device)
        if got is None:
            return False
        bundle, step, extras = got
        self.params = bundle["params"]
        self.opt_state = bundle["opt"]
        self.step = int(extras.get("step", step))
        self.data.state = PipelineState.from_dict(
            extras.get("data", {"seed": self.tcfg.seed, "step": self.step})
        )
        return True

    # -- loop -----------------------------------------------------------------

    def run(self) -> dict:
        ema = None
        injected = set(self.tcfg.fail_at_steps)
        self._save()  # step-0 baseline checkpoint
        while self.step < self.tcfg.total_steps:
            batch_np = self.data.next_batch()
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}
            t0 = time.perf_counter()
            try:
                if self.step in injected:
                    injected.discard(self.step)
                    raise RuntimeError(f"injected node failure at step {self.step}")
                if self.error_fb is None:
                    self.params, self.opt_state, metrics = self._step_fn(
                        self.params, self.opt_state, batch
                    )
                else:
                    (self.params, self.opt_state, self.error_fb, metrics) = (
                        self._step_fn(self.params, self.opt_state, self.error_fb, batch)
                    )
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception as e:  # noqa: BLE001 — node failure path
                self.recoveries += 1
                restored = self._restore()
                self.history.append(
                    {"step": self.step, "event": "failure",
                     "error": str(e)[:200], "restored": restored}
                )
                if not restored:
                    raise
                continue

            dt = time.perf_counter() - t0
            if ema is not None and dt > self.tcfg.straggler_factor * ema:
                ev = {"step": self.step, "dt": dt, "ema": ema}
                self.straggler_events.append(ev)
                if self.on_straggler:
                    self.on_straggler(self.step, dt, ema)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt

            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                self.history.append({"step": self.step, **metrics, "dt": dt})
            if self.step % self.tcfg.checkpoint_every == 0:
                self._save()
        self._save()
        return {
            "final_step": self.step,
            "history": self.history,
            "stragglers": self.straggler_events,
            "recoveries": self.recoveries,
        }


@torch.no_grad()
def eval_loss(cfg: ModelConfig, params: dict, batch: dict) -> float:
    loss, _ = loss_fn(params, batch, cfg)
    return float(loss)
