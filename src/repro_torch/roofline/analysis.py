"""Roofline terms of one measured dry-run step on one H100 (the reference's
``roofline/analysis.py``).

  compute term    = bf16/fp16 FLOPs / BF16_TENSOR_FLOPS
                    + float32 (and other) FLOPs / FP32_FLOPS
                    + the hand-written kernels' operations at their own peaks
  memory term     = counted bytes / HBM_BYTES_PER_S
  collective term = 0: one device has no collectives

The counts come from ``roofline.ops`` (an op-level count of one eager
step), where the reference reads them from compiled HLO.  Eager PyTorch
fuses nothing, so the memory term is what the step's ops move as they run,
not a floor: ``floor_s`` is one, the larger of ``floor_bytes`` (the
resident state and the inputs, each read once) at the memory rate and the
model FLOPs at the bf16 peak.  The peaks are
``roofline.hw``'s H100 figures.  The field and key names stay the
reference's (``hlo_flops``, ``hlo_bytes``) so that a reader can put the two
tables side by side.  ``mfu`` is what the reference cannot have: model
FLOPs over the *measured* step over the bf16 peak.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw
from repro_torch.roofline.ops import OpCounts

_TENSOR_CORE_DTYPES = ("bfloat16", "float16")


def flops_rate(dtype: str) -> float:
    """The peak FLOP/s of a product whose output has type ``dtype``: the
    tensor cores' bf16 rate for bf16 and fp16, else float32 outside them
    (no TF32)."""
    return hw.BF16_TENSOR_FLOPS if dtype in _TENSOR_CORE_DTYPES else hw.FP32_FLOPS


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # counted FLOPs of the step (aten products)
    hlo_bytes: float               # counted bytes (aten ops + kernels)
    collective_bytes_per_chip: float
    model_flops: float             # 6·N·D or 2·N·D
    compute_s: float
    memory_s: float
    collective_s: float
    collective_detail: dict
    per_device_hbm_bytes: float | None = None
    xla_cost_flops: float | None = None  # no XLA here: always None
    measured_step_s: float | None = None
    floor_bytes: float | None = None     # resident state and inputs, each read once

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def floor_s(self) -> float:
        """The least time a step could take: ``floor_bytes`` at the memory
        rate or the model FLOPs at the bf16 peak, whichever is longer."""
        return max((self.floor_bytes or 0.0) / hw.HBM_BYTES_PER_S,
                   self.model_flops / (self.chips * hw.BF16_TENSOR_FLOPS))

    @property
    def floor_fraction(self) -> float | None:
        """``floor_s`` over the measured step."""
        return self.floor_s / self.measured_step_s if self.measured_step_s else None

    @property
    def useful_flops_fraction(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPs/s at roofline step time vs aggregate peak — the MFU
        upper bound of this step."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / t / (self.chips * hw.BF16_TENSOR_FLOPS)

    @property
    def mfu(self) -> float | None:
        """Model FLOPs over the measured step over the bf16 peak."""
        if not self.measured_step_s:
            return None
        return self.model_flops / self.measured_step_s / (self.chips * hw.BF16_TENSOR_FLOPS)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collective_detail": self.collective_detail,
            "per_device_hbm_bytes": self.per_device_hbm_bytes,
            "xla_cost_flops": self.xla_cost_flops,
            "measured_step_s": self.measured_step_s,
            "mfu": self.mfu,
            "floor_bytes": self.floor_bytes,
            "floor_s": self.floor_s,
            "floor_fraction": self.floor_fraction,
        }


def build(
    *,
    arch: str,
    shape: str,
    counts: OpCounts,
    model_flops: float,
    mesh_name: str = "h100",
    chips: int = 1,
    per_device_hbm_bytes: float | None = None,
    measured_step_s: float | None = None,
    floor_bytes: float | None = None,
) -> Roofline:
    compute_s = sum(f / flops_rate(dtype) for dtype, f in counts.flops_by_dtype.items())
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=counts.flops,
        hlo_bytes=counts.total_bytes,
        collective_bytes_per_chip=0.0,
        model_flops=model_flops,
        compute_s=compute_s + counts.kernel_seconds,
        memory_s=counts.total_bytes / hw.HBM_BYTES_PER_S,
        collective_s=0.0,
        collective_detail={},
        per_device_hbm_bytes=per_device_hbm_bytes,
        measured_step_s=measured_step_s,
        floor_bytes=floor_bytes,
    )


def model_flops_estimate(n_active_params: float, tokens: float, kind: str) -> float:
    """6·N·D for training, 2·N·D forward-only (decode: D = batch tokens)."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active_params * tokens
