"""Export trained BNNs into deployable switch-pipeline artifacts.

This is the deploy half of the train->deploy loop: latent float weights (or
{0,1} bit matrices from any source) are rounded to the chip's weight format,
compiled by :func:`~repro_torch.core.compiler.compile_bnn` into a pipeline program,
lowered to the dataplane's dense op-tables, and *verified* — the exported
artifact is only trustworthy because :func:`verify_roundtrip` proves the
mathematical oracle (``bnn.forward``), the fused executor, and the simulated
switch fabric agree bit-for-bit on real packets.

Rounding convention (must match training): a latent weight binarizes to bit 1
iff it is ``>= 0`` — exactly :func:`repro_torch.core.bitops.sign_to_bits`, and
exactly the sign :func:`repro_torch.core.bnn.binarize_ste` takes in the training
forward pass.  Ties at 0.0 go to +1 on both sides, so a trained model and its
export can never disagree on the boundary.

The dataplane subsystem is imported lazily (inside functions) so ``core``
stays importable without it, mirroring ``PipelineProgram.lower``.  The
on-disk format is the reference's (``weights.npz`` + ``manifest.json``), so
a model saved by either package loads in the other to the same program
fingerprint.  The checks run on ``device=`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core import bnn
from repro_torch.core.bnn import BnnSpec
from repro_torch.core.compiler import compile_bnn
from repro_torch.core.pipeline import RMT, ChipSpec, PipelineProgram
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.dataplane.fabric import SwitchFabric
    from repro_torch.dataplane.lowering import LoweredProgram


class ExportError(Exception):
    """Weights cannot be exported, or a round-trip verification failed."""


def _numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def bit_weights_from_latent(latent: Sequence) -> list[np.ndarray]:
    """Latent float weights -> {0,1} int32 bit matrices (bit 1 iff w >= 0).

    Thin numpy wrapper over :func:`repro_torch.core.bnn.params_from_latent`
    — one implementation of the rounding convention, shared with training.
    Takes tensors (on any device) or arrays.
    """
    latent = [torch.as_tensor(w) if not isinstance(w, torch.Tensor) else w for w in latent]
    return [_numpy(w) for w in bnn.params_from_latent(latent)]


@dataclasses.dataclass(frozen=True)
class ExportedModel:
    """A deployable model: bit weights + compiled program + lowered tables.

    ``weights`` are the ground truth — ``program`` and ``lowered`` are
    deterministic functions of them and the chip, and :func:`load` proves it
    by recompiling and checking the program fingerprint against the manifest.
    """

    spec: BnnSpec
    weights: tuple[np.ndarray, ...]     # {0,1} int32, one (n_out, n_in) per layer
    chip: ChipSpec
    program: PipelineProgram
    lowered: "LoweredProgram"
    compile_seconds: float
    lower_seconds: float

    def oracle_forward(self, packets, *, device="cuda") -> np.ndarray:
        """Reference predictions from the mathematical oracle, on ``device``."""
        dev = resolve_device(device)
        weights = [torch.from_numpy(w).to(dev) for w in self.weights]
        x = torch.as_tensor(np.asarray(packets), device=dev)
        return bnn.forward(weights, x).cpu().numpy()

    def fabric(
        self, *, mode: str = "multi_hop", chip: ChipSpec | None = None
    ) -> "SwitchFabric":
        """Partition the program onto simulated switches (deploy target)."""
        from repro_torch.dataplane.fabric import SwitchFabric

        return SwitchFabric.partition(self.program, mode=mode, chip=chip)

    def save(self, directory: str) -> str:
        """Persist the bit matrices + a manifest binding them to the compile.

        Only the weights and metadata are stored; ``load`` recompiles and
        verifies the program fingerprint, so a stale or hand-edited artifact
        cannot silently masquerade as the trained model.
        """
        os.makedirs(directory, exist_ok=True)
        np.savez(
            os.path.join(directory, "weights.npz"),
            **{f"layer_{i}": w for i, w in enumerate(self.weights)},
        )
        manifest = {
            "layer_sizes": list(self.spec.layer_sizes),
            "chip": self.chip.name,
            "native_popcnt": self.chip.native_popcnt,
            "program_fingerprint": self.program.fingerprint(),
            "lowered_fingerprint": self.lowered.fingerprint(),
            "elements": self.program.num_elements,
        }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return directory


def export_bits(
    weights: Sequence[np.ndarray], chip: ChipSpec = RMT
) -> ExportedModel:
    """Compile {0,1} bit matrices into a deployable :class:`ExportedModel`."""
    raw = [_numpy(w) for w in weights]
    if not raw:
        raise ExportError("no weight matrices to export")
    for i, w in enumerate(raw):
        if w.ndim != 2:
            raise ExportError(f"layer {i}: weights must be 2-D, got {w.shape}")
        # Validate before the int32 cast: float latents passed by mistake
        # (export_latent is the rounding entry point) must not truncate to
        # {0,1}-looking garbage.
        if not np.isin(w, (0, 1)).all():
            raise ExportError(f"layer {i}: weights must be {{0,1}} bits")
    ws = tuple(w.astype(np.int32) for w in raw)
    for i, (a, b) in enumerate(zip(ws, ws[1:])):
        if b.shape[1] != a.shape[0]:
            raise ExportError(
                f"layer {i + 1} fan-in {b.shape[1]} != layer {i} fan-out {a.shape[0]}"
            )
    spec = BnnSpec((ws[0].shape[1],) + tuple(w.shape[0] for w in ws))

    t0 = time.perf_counter()
    program = compile_bnn(list(ws), chip)
    t1 = time.perf_counter()
    lowered = program.lower()
    t2 = time.perf_counter()
    return ExportedModel(
        spec=spec,
        weights=ws,
        chip=chip,
        program=program,
        lowered=lowered,
        compile_seconds=t1 - t0,
        lower_seconds=t2 - t1,
    )


def export_latent(latent: Sequence, chip: ChipSpec = RMT) -> ExportedModel:
    """Round latent float weights to bits and compile (the trainer's exit)."""
    return export_bits(bit_weights_from_latent(latent), chip)


def load(directory: str, chip: ChipSpec = RMT) -> ExportedModel:
    """Load a saved artifact, recompile, and verify the manifest fingerprint."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, "weights.npz")) as z:
        ws = [z[f"layer_{i}"] for i in range(len(z.files))]
    exported = export_bits(ws, chip)
    want = manifest["program_fingerprint"]
    if exported.program.fingerprint() != want:
        raise ExportError(
            f"recompiled program fingerprint {exported.program.fingerprint()} "
            f"!= manifest {want} (artifact stale, or chip mismatch: saved for "
            f"{manifest['chip']!r}, loading for {chip.name!r})"
        )
    return exported


# ---------------------------------------------------------------------------
# Round-trip verification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundTripReport:
    """Outcome of a train->compile->deploy bit-exactness check.

    A "mismatch" is a packet whose output bit *vector* differs anywhere —
    per-packet, not per-bit, because one wrong bit is one misclassified
    packet on the wire.
    """

    packets: int
    output_bits: int
    mode: str
    hops: int
    executor_mismatches: int     # oracle vs fused executor (single switch)
    fabric_mismatches: int       # oracle vs partitioned switch fabric
    reference_mismatches: int | None  # caller bits (e.g. STE fwd) vs fabric
    verify_seconds: float

    @property
    def ok(self) -> bool:
        return (
            self.executor_mismatches == 0
            and self.fabric_mismatches == 0
            and not self.reference_mismatches
        )

    def summary(self) -> str:
        ref = (
            "-"
            if self.reference_mismatches is None
            else str(self.reference_mismatches)
        )
        return (
            f"roundtrip[{self.mode}]: packets={self.packets} hops={self.hops} "
            f"mismatches(executor={self.executor_mismatches} "
            f"fabric={self.fabric_mismatches} reference={ref}) "
            f"{'BIT-EXACT' if self.ok else 'FAILED'}"
        )


def _row_mismatches(a: np.ndarray, b: np.ndarray) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(axis=1).sum())


def verify_roundtrip(
    exported: ExportedModel,
    packets,
    *,
    mode: str = "multi_hop",
    fabric_chip: ChipSpec | None = None,
    fabric: "SwitchFabric | None" = None,
    backend: str = "jnp",
    chunk_size: int | None = None,
    reference_bits=None,
    check: bool = True,
    device="cuda",
) -> RoundTripReport:
    """Prove oracle == fused executor == switch fabric on ``packets``.

    ``reference_bits`` lets a caller pin a fourth witness — the trainer
    passes its STE forward-pass outputs, which is the acceptance criterion
    "train-time vs fabric-simulated predictions are bit-exact".  Pass a
    pre-built ``fabric`` to reuse one instance (e.g. to read its telemetry
    afterwards) instead of partitioning a fresh one from ``mode`` /
    ``fabric_chip``.  With ``check=True`` (default) any mismatch raises
    :class:`ExportError`; ``check=False`` returns the report for inspection.
    Every witness runs on ``device``.
    """
    from repro_torch.dataplane.executor import execute

    packets = np.asarray(packets)
    if packets.ndim != 2 or packets.shape[1] != exported.spec.input_bits:
        raise ExportError(
            f"expected (n, {exported.spec.input_bits}) packets, got {packets.shape}"
        )
    t0 = time.perf_counter()
    want = exported.oracle_forward(packets, device=device)
    got_exec = execute(
        exported.lowered, packets, backend=backend, chunk_size=chunk_size,
        device=device,
    )
    if fabric is not None and (
        fabric.program.fingerprint() != exported.program.fingerprint()
    ):
        raise ExportError(
            "supplied fabric was partitioned from a different program than "
            "this export (stale fabric after a retrain?)"
        )
    fab = fabric if fabric is not None else exported.fabric(mode=mode, chip=fabric_chip)
    got_fabric = fab.run(
        packets, backend=backend, chunk_size=chunk_size, device=device
    ).outputs

    ref_mismatches = None
    if reference_bits is not None:
        reference_bits = _numpy(reference_bits)
        if reference_bits.shape != got_fabric.shape:
            raise ExportError(
                f"reference bits shape {reference_bits.shape} != fabric "
                f"output shape {got_fabric.shape}"
            )
        ref_mismatches = _row_mismatches(reference_bits, got_fabric)

    report = RoundTripReport(
        packets=packets.shape[0],
        output_bits=exported.spec.output_bits,
        mode=fab.mode,
        hops=fab.num_hops,
        executor_mismatches=_row_mismatches(want, got_exec),
        fabric_mismatches=_row_mismatches(want, got_fabric),
        reference_mismatches=ref_mismatches,
        verify_seconds=time.perf_counter() - t0,
    )
    if check and not report.ok:
        raise ExportError(report.summary())
    return report
