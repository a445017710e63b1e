"""Analytic throughput model for N2Net on an RMT chip.

Reproduces the paper's evaluation numbers:
  * 960M packets/s pipeline rate;
  * "960 million neurons per second when using 2048b activations";
  * higher neuron rates at smaller activations via parallelism;
  * the headline "960 million two-layer BNNs per second using 32b
    activations and layers of 64 and 32 neurons" — which requires the whole
    network to fit one pipeline pass (<= 32 elements).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import bnn
from repro_torch.core.pipeline import (
    RMT,
    ChipSpec,
    PipelineProgram,
    elements_for_neuron_group,
    max_parallel_neurons,
)


@dataclasses.dataclass(frozen=True)
class ThroughputReport:
    packets_per_second: float
    passes: int
    networks_per_second: float   # one network evaluation per packet
    neurons_per_second: float
    elements_used: int
    elements_available: int

    def csv(self) -> str:
        return (
            f"{self.packets_per_second:.3e},{self.passes},"
            f"{self.networks_per_second:.3e},{self.neurons_per_second:.3e},"
            f"{self.elements_used},{self.elements_available}"
        )


def neuron_rate(n_act: int, chip: ChipSpec = RMT) -> float:
    """Paper's Table-1-style rate: neurons/s at a given activation width.

    At 2048b one neuron rides each packet -> 960M neurons/s; smaller
    activations multiply by the parallelism (e.g. 32b -> 64x).
    """
    return chip.packets_per_second * max_parallel_neurons(n_act, chip)


def analytic_elements(spec: bnn.BnnSpec, chip: ChipSpec = RMT) -> int:
    """Element count from the paper's cost model (no compilation)."""
    total = 0
    sizes = spec.layer_sizes
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        n_act = 1 << (n_in - 1).bit_length()  # paper model assumes pow2
        par = min(n_out, max_parallel_neurons(n_act, chip))
        groups = -(-n_out // par)
        total += groups * elements_for_neuron_group(n_act, par, chip)
    return total


def report_for_spec(spec: bnn.BnnSpec, chip: ChipSpec = RMT) -> ThroughputReport:
    """Throughput from the analytic cost model."""
    used = analytic_elements(spec, chip)
    passes = max(1, -(-used // chip.num_elements))
    pps = chip.packets_per_second / passes
    total_neurons = sum(spec.layer_sizes[1:])
    return ThroughputReport(
        packets_per_second=pps,
        passes=passes,
        networks_per_second=pps,
        neurons_per_second=pps * total_neurons,
        elements_used=used,
        elements_available=chip.num_elements,
    )


def report_for_program(prog: PipelineProgram) -> ThroughputReport:
    """Throughput of an actually-compiled program (recirculation-aware)."""
    chip = prog.chip
    passes = prog.passes
    pps = chip.packets_per_second / passes
    total_neurons = sum(lp.n_out for lp in prog.layer_plans)
    return ThroughputReport(
        packets_per_second=pps,
        passes=passes,
        networks_per_second=pps,
        neurons_per_second=pps * total_neurons,
        elements_used=prog.num_elements,
        elements_available=chip.num_elements,
    )
