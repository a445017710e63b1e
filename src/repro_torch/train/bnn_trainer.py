"""Batched straight-through-estimator trainer for deployable BNNs.

The train half of the train->deploy loop (the reference's
``train/bnn_trainer.py``).  Latent float weights are trained with an STE
loop whose forward pass is, *by construction*,
bit-for-bit the deployed network: hidden activations are hard signs with the
oracle's tie rule (pre-activation 0 -> +1), weights binarize with
``bnn.binarize_ste`` (latent >= 0 -> +1), and pre-activations are exact small
integers in float32 — so :meth:`BnnTrainer.forward_bits` at any training step
equals ``bnn.forward`` on the would-be exported bit matrices, and therefore
equals the compiled pipeline, the fused executor, and the switch fabric
(:func:`repro_torch.core.export.verify_roundtrip` proves the whole chain).

The training task is in-network traffic classification, generated from the
dataplane's scenario library (:func:`make_traffic_task`): each class is one
``dataplane.traffic`` scenario, the packet's header bits are the BNN input,
and the network's single output bit is the classification the switch would
act on (drop/mirror/mark).  Scaling beyond one output bit means one-vs-all
heads; the deployed artifact acts on bits, so the trainer keeps the deploy
semantics honest by training exactly what the switch executes.

Real traces fit the same mold: :func:`make_capture_task` temporal-splits any
labeled activation-bit trace — e.g. a pcap capture featurized by
``dataplane.pcap.featurize`` and labeled through ``dataplane.pcap
.label_packets`` — into the trainer's task tuple, and
:class:`BnnTrainer` accepts that tuple via its ``task`` argument in place
of the synthetic-scenario default (``examples/pcap_replay.py`` closes the
loop capture -> train -> switch).

Checkpointing follows the reference's conventions: atomic
``train.checkpoint`` bundles of ``{"latent", "opt"}`` plus step extras, with
restore-latest resume.  Batch order is ``(seed, step)``-deterministic (drawn
with numpy, so both packages see the same batches), so a resumed run replays
the interrupted one bit-consistently.

The trainer runs on ``device=`` (default ``"cuda"``).  Its products stay in
float32 there — no TF32, no bf16, no autocast (:func:`float32_products`) —
because :func:`forward_bits` is bit-exact with the deployed network only
while every pre-activation is an exact small integer in float32.  The
initial latent is drawn from a CPU ``torch.Generator`` seeded with
``cfg.seed`` (the same latent on every device); the reference draws from its own generator, which the port
does not reproduce, so parity tests carry the reference's latent across
(``convert.bnn_latent_from_jax``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bnn
from repro_torch.core.bnn import BnnSpec, binarize_ste
from repro_torch.core.export import ExportedModel, bit_weights_from_latent, export_latent
from repro_torch.core.pipeline import RMT, ChipSpec
from repro_torch.dataplane import traffic
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch import tree
from repro_torch.train import checkpoint as ckpt


# Activations binarize through the same primitive as weights
# (``bnn.binarize_ste``): hard sign with the oracle's tie rule (0 -> +1)
# and a |u| <= 1 pass-through gate.  Pre-activations are normalized to
# roughly unit scale before the sign so the gate bites.


def init_latent(spec: BnnSpec, generator: torch.Generator) -> list[torch.Tensor]:
    """Uniform(-1, 1) latent weights — balanced signs, full STE gradient —
    drawn from ``generator`` on its device."""
    latent = []
    for i in range(spec.num_layers):
        shape = (spec.layer_sizes[i + 1], spec.layer_sizes[i])
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=generator.device)
        latent.append(2.0 * u - 1.0)
    return latent


@contextlib.contextmanager
def float32_products():
    """Float32 products inside: TF32 matmuls off and autocast off on every
    device, restored on exit."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def forward_logits(latent: Sequence[torch.Tensor], x_pm1: torch.Tensor) -> torch.Tensor:
    """STE forward pass on ±1 activations; returns scaled final pre-acts.

    Each layer's pre-activation is divided by ``sqrt(fan_in)`` (unit variance
    for random ±1 operands) *before* the sign — positive scaling never moves
    a sign, so the binarized trajectory is untouched while the STE gate and
    the loss see well-scaled values.
    """
    h = x_pm1
    for w in latent[:-1]:
        pre = h @ binarize_ste(w).T
        h = binarize_ste(pre / np.sqrt(w.shape[1]))
    w = latent[-1]
    return (h @ binarize_ste(w).T) / np.sqrt(w.shape[1])


def forward_bits(latent: Sequence[torch.Tensor], x_bits: torch.Tensor) -> torch.Tensor:
    """{0,1} outputs of the *deployed* network at the current latent state.

    Bit-exact with ``bnn.forward(bit_weights_from_latent(latent), x_bits)``:
    pre-activations are sums of ±1 terms, exact in float32, and the positive
    per-layer scaling cannot flip a sign or perturb a zero tie.
    """
    x_pm1 = (2 * x_bits.to(torch.float32)) - 1.0
    return (forward_logits(latent, x_pm1) >= 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Task generation
# ---------------------------------------------------------------------------

def make_traffic_task(
    scenarios: Sequence[str],
    n_per_class: int,
    input_bits: int,
    seed: int = 0,
    eval_per_class: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A labeled classification task from dataplane traffic scenarios.

    Class ``i``'s packets are drawn from ``scenarios[i]``.  The split is
    *temporal*, as a real capture-then-deploy pipeline would be: one trace
    per class, the first ``n_per_class`` packets train, the last
    ``eval_per_class`` are held out — unseen packets (sensor walks continue,
    bursts re-jitter) from the same traffic worlds the model deploys into.

    Returns shuffled ``(train_x, train_y, eval_x, eval_y)``; eval arrays are
    empty when ``eval_per_class == 0``.  Packets are (n, input_bits) int32
    {0,1}, labels (n,) int32 class indices.
    """
    tr_x, tr_y, ev_x, ev_y = [], [], [], []
    for i, name in enumerate(scenarios):
        trace = traffic.generate(
            name, n_per_class + eval_per_class, input_bits, seed=seed + i
        )
        tr_x.append(trace[:n_per_class])
        tr_y.append(np.full(n_per_class, i, np.int32))
        ev_x.append(trace[n_per_class:])
        ev_y.append(np.full(eval_per_class, i, np.int32))

    def shuffle(xs, ys, salt):
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = np.random.default_rng((seed, salt)).permutation(x.shape[0])
        return x[perm], y[perm]

    train = shuffle(tr_x, tr_y, 0)
    held = shuffle(ev_x, ev_y, 1)
    return train[0], train[1], held[0], held[1]


def make_capture_task(
    bits: np.ndarray,
    labels: np.ndarray,
    *,
    train_frac: float = 0.8,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A trainer task from one labeled packet trace (e.g. a featurized pcap).

    The split is *temporal*, matching :func:`make_traffic_task` and real
    capture-then-deploy practice: the first ``train_frac`` of the trace (in
    arrival order) trains — shuffled for SGD — and the rest is held out in
    arrival order, so evaluation replays the unseen tail of the capture.

    ``bits`` is ``(n, input_bits)`` int {0,1} (``dataplane.pcap.featurize``
    output), ``labels`` ``(n,)`` binary ints (``dataplane.pcap
    .label_packets`` output, or ground truth).  Returns ``(train_x,
    train_y, eval_x, eval_y)`` for :class:`BnnTrainer`'s ``task`` argument.
    """
    bits = np.asarray(bits, np.int32)
    labels = np.asarray(labels, np.int32)
    if bits.ndim != 2 or labels.shape != (bits.shape[0],):
        raise ValueError(
            f"need (n, input_bits) bits and (n,) labels, got {bits.shape} "
            f"and {labels.shape}"
        )
    if not np.isin(bits, (0, 1)).all():
        raise ValueError("bits must be {0,1}")
    if not np.isin(labels, (0, 1)).all():
        raise ValueError(
            "labels must be binary {0,1}; the deployed switch acts on the "
            "single output bit"
        )
    if not 0.0 < train_frac < 1.0:
        raise ValueError(f"train_frac must be in (0, 1), got {train_frac}")
    k = int(round(train_frac * bits.shape[0]))
    if k == 0 or k == bits.shape[0]:
        raise ValueError(
            f"trace of {bits.shape[0]} packets leaves an empty split at "
            f"train_frac={train_frac}"
        )
    perm = np.random.default_rng((seed, 2)).permutation(k)
    return bits[:k][perm], labels[:k][perm], bits[k:], labels[k:]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BnnTrainConfig:
    """Defaults train the example's headline task in a few CPU seconds."""

    layer_sizes: tuple[int, ...] = (32, 128, 64, 1)
    scenarios: tuple[str, ...] = ("iot_telemetry", "ddos_burst")
    steps: int = 600
    batch: int = 512
    train_packets_per_class: int = 8192
    eval_packets_per_class: int = 5000
    lr: float = 0.02
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 200
    log_every: int = 50

    def __post_init__(self):
        if len(self.scenarios) != 2:
            raise ValueError(
                "binary classification only: exactly 2 scenarios "
                f"(got {len(self.scenarios)}); the deployed switch acts on "
                "the single output bit"
            )
        if self.layer_sizes[-1] != 1:
            raise ValueError(
                f"final layer must be 1 neuron (the class bit), got "
                f"{self.layer_sizes[-1]}"
            )
        for name in self.scenarios:
            traffic.get_scenario(name)  # fail fast on typos


class BnnTrainer:
    """Train a BNN on traffic, then export it into the dataplane fabric.

    By default the task is synthesized from ``cfg.scenarios`` via
    :func:`make_traffic_task`; pass ``task`` (a ``(train_x, train_y,
    eval_x, eval_y)`` tuple, e.g. from :func:`make_capture_task` over a
    featurized pcap) to train on an external trace instead.
    """

    def __init__(self, cfg: BnnTrainConfig, task=None, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = BnnSpec(cfg.layer_sizes)
        # Drawn on the CPU and moved: a seed gives one initial latent on
        # every device.
        self.latent = [
            w.to(self.device)
            for w in init_latent(self.spec, torch.Generator().manual_seed(cfg.seed))
        ]
        # Latent weights live in [-1, 1]; decay pulls them toward the 0
        # binarization boundary, so it is off.
        self.optimizer = AdamW(lr=cfg.lr, weight_decay=0.0, use_master=False)
        self.opt_state = self.optimizer.init(self.latent)
        self.step = 0
        self.history: list[dict] = []
        if task is None:
            task = make_traffic_task(
                cfg.scenarios,
                cfg.train_packets_per_class,
                self.spec.input_bits,
                seed=cfg.seed,
                eval_per_class=cfg.eval_packets_per_class,
            )
        else:
            if len(task) != 4:
                raise ValueError(
                    "task must be (train_x, train_y, eval_x, eval_y), got "
                    f"{len(task)} items"
                )
            task = tuple(np.asarray(a) for a in task)
            for xs, ys, part in (
                (task[0], task[1], "train"),
                (task[2], task[3], "eval"),
            ):
                if xs.ndim != 2 or xs.shape[1] != self.spec.input_bits:
                    raise ValueError(
                        f"task {part}_x must be (n, {self.spec.input_bits}) "
                        f"to match layer_sizes {cfg.layer_sizes}, got "
                        f"{xs.shape}"
                    )
                if ys.shape != (xs.shape[0],):
                    raise ValueError(
                        f"task {part}_y shape {ys.shape} does not match "
                        f"{part}_x's {xs.shape[0]} packets"
                    )
        (self._train_x, self._train_y, self.eval_x, self.eval_y) = task

    # -- internals ----------------------------------------------------------

    def _train_step(self, latent, opt_state, x_pm1, y):
        with float32_products():
            lat = [w.detach().requires_grad_(True) for w in latent]
            with torch.enable_grad():
                logits = forward_logits(lat, x_pm1)[:, 0]
                margin = (2.0 * y - 1.0) * logits
                # BCE with logits: softplus(-margin), as logaddexp(-margin, 0)
                loss = torch.mean(torch.logaddexp(-margin, torch.zeros_like(margin)))
                grads = torch.autograd.grad(loss, lat)
            with torch.no_grad():
                acc = torch.mean(((logits >= 0) == (y == 1)).to(torch.float32))
                latent, opt_state, om = self.optimizer.update(list(grads), opt_state, latent)
                # BinaryNet clip: keeps latents where the STE weight gate has signal.
                latent = [torch.clamp(w, -1.0, 1.0) for w in latent]
        return latent, opt_state, {"loss": loss.detach(), "accuracy": acc, **om}

    def _batch(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        idx = np.random.default_rng((self.cfg.seed, step)).integers(
            0, self._train_x.shape[0], self.cfg.batch
        )
        x_pm1 = 2.0 * self._train_x[idx].astype(np.float32) - 1.0
        y = self._train_y[idx].astype(np.float32)
        return (torch.from_numpy(x_pm1).to(self.device),
                torch.from_numpy(y).to(self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save(self) -> None:
        if self.cfg.checkpoint_dir:
            ckpt.save(
                self.cfg.checkpoint_dir,
                self.step,
                {"latent": self.latent, "opt": self.opt_state},
                {"step": self.step},
            )

    def _restore(self) -> bool:
        if not self.cfg.checkpoint_dir:
            return False
        like = {"latent": self.latent, "opt": self.opt_state}
        got = ckpt.restore_latest(self.cfg.checkpoint_dir, like)
        if got is None:
            return False
        bundle, step, extras = got
        self.latent = [w.to(self.device) for w in bundle["latent"]]
        self.opt_state = tree.map(lambda t: t.to(self.device), bundle["opt"])
        self.step = int(extras.get("step", step))
        return True

    # -- public -------------------------------------------------------------

    def train(self) -> dict:
        """Run to ``cfg.steps`` (resuming from a checkpoint if one exists).

        Instrumented through ``repro_torch.obs``: a ``compile:train_step`` span
        around the first step, per-step latency into the
        ``train.step_seconds`` histogram, and loss/accuracy gauges at log
        points — all no-ops while observability is off.
        """
        resumed = self._restore()
        start_step = self.step
        observing = obs.enabled()
        first = True
        t0 = time.perf_counter()
        with obs.span(
            "stream:train_run", cat="stream",
            start_step=start_step, steps=self.cfg.steps,
        ):
            while self.step < self.cfg.steps:
                x, y = self._batch(self.step)
                with obs.span(
                    "compile:train_step" if first else "execute:train_step",
                    cat="compile" if first else "execute",
                    step=self.step,
                ):
                    s0 = time.perf_counter()
                    self.latent, self.opt_state, metrics = self._train_step(
                        self.latent, self.opt_state, x, y
                    )
                    if observing:
                        self._sync()
                        step_dt = time.perf_counter() - s0
                self.step += 1
                if observing:
                    m = obs.registry()
                    m.counter("train.steps_total").inc()
                    if first:
                        m.histogram("train.compile_seconds").observe(step_dt)
                    else:
                        m.histogram("train.step_seconds").observe(step_dt)
                first = False
                if (
                    self.step % self.cfg.log_every == 0
                    or self.step == 1
                    or self.step == self.cfg.steps
                ):
                    self.history.append(
                        {
                            "step": self.step,
                            **{k: float(v) for k, v in metrics.items()},
                        }
                    )
                    if observing:
                        m = obs.registry()
                        m.gauge("train.loss").set(float(metrics["loss"]))
                        m.gauge("train.accuracy").set(
                            float(metrics["accuracy"])
                        )
                if (
                    self.cfg.checkpoint_every
                    and self.step % self.cfg.checkpoint_every == 0
                ):
                    self._save()
            self._sync()
        seconds = time.perf_counter() - t0
        self._save()
        ran = self.step - start_step
        return {
            "final_step": self.step,
            "resumed": resumed,
            "seconds": seconds,
            "steps_per_second": ran / seconds if seconds > 0 else float("inf"),
            "history": self.history,
        }

    def forward_bits(self, x_bits) -> np.ndarray:
        """Deployed-network outputs of the current latent state (train-time
        witness for the export round-trip)."""
        x = torch.as_tensor(np.asarray(x_bits), device=self.device)
        with torch.inference_mode(), float32_products():
            return forward_bits(self.latent, x).cpu().numpy()

    def evaluate(self, x_bits, y) -> dict:
        """Accuracy of the deployed (binarized) network on labeled packets."""
        with obs.span(
            "execute:train_eval", cat="execute",
            packets=int(np.asarray(y).shape[0]),
        ):
            t0 = time.perf_counter()
            bits = self.forward_bits(x_bits)[:, 0]
            dt = time.perf_counter() - t0
        acc = float((bits == np.asarray(y)).mean())
        if obs.enabled():
            m = obs.registry()
            m.histogram("train.eval_seconds").observe(dt)
            m.gauge("train.eval_accuracy").set(acc)
        return {"accuracy": acc, "packets": int(np.asarray(y).shape[0])}

    def evaluate_held_out(self) -> dict:
        """Accuracy on the temporal held-out split (unseen packets from the
        training traffic worlds — the deploy-time distribution)."""
        return self.evaluate(self.eval_x, self.eval_y)

    def export(self, chip: ChipSpec = RMT) -> ExportedModel:
        """Round latents to bits and compile into the dataplane (deploy)."""
        return export_latent(self.latent, chip)

    def oracle_bits(self, x_bits) -> np.ndarray:
        """Oracle predictions on the exported bit matrices (sanity hook)."""
        weights = [torch.from_numpy(w).to(self.device) for w in bit_weights_from_latent(self.latent)]
        x = torch.as_tensor(np.asarray(x_bits), device=self.device)
        return bnn.forward(weights, x).cpu().numpy()
