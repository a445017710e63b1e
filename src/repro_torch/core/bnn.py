"""Binary neural network definition + mathematical oracle.

This is the *model-level* ground truth that the switch-pipeline interpreter
(``core.interpreter``), the dataplane executor and the CUDA kernels are
validated against.

Conventions (matching the paper):
  * activations and weights are signs in {-1,+1}, stored as {0,1} bits
    (bit 1 == +1);
  * a neuron computes ``y = SIGN(popcount(XNOR(x, w)) >= N/2)`` which is
    exactly ``sign(sum_i x_i * w_i)`` with the tie (sum == 0) resolving to +1;
  * layers are fully connected (the only kind N2Net compiles).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import bitops


@dataclasses.dataclass(frozen=True)
class BnnSpec:
    """A fully-connected BNN: ``layer_sizes[0]`` inputs, then one entry per
    layer's neuron count.  E.g. the paper's headline model is
    ``BnnSpec((32, 64, 32))`` — 32b activations, layers of 64 and 32 neurons.
    """

    layer_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.layer_sizes) < 2:
            raise ValueError("need at least (input_size, one layer)")
        for s in self.layer_sizes:
            if s <= 0:
                raise ValueError(f"layer size must be positive, got {s}")

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes) - 1

    @property
    def input_bits(self) -> int:
        return self.layer_sizes[0]

    @property
    def output_bits(self) -> int:
        return self.layer_sizes[-1]


def init_params(spec: BnnSpec, generator: torch.Generator) -> list[torch.Tensor]:
    """Random ±1 weights as {0,1} int32 bit matrices, one (out, in) per layer,
    drawn from ``generator`` on its device."""
    params = []
    for i in range(spec.num_layers):
        fan_in, fan_out = spec.layer_sizes[i], spec.layer_sizes[i + 1]
        params.append(
            torch.randint(
                0, 2, (fan_out, fan_in), generator=generator,
                dtype=torch.int32, device=generator.device,
            )
        )
    return params


def neuron_preact(x_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """popcount(XNOR(x, w)) per neuron — the paper's pre-activation.

    x_bits: (..., n_in) in {0,1};  w_bits: (n_out, n_in) in {0,1}.
    Returns (..., n_out) agreement counts.
    """
    agree = 1 - torch.bitwise_xor(x_bits[..., None, :], w_bits)  # XNOR
    return agree.sum(-1)


def layer_forward(
    x_bits: torch.Tensor, w_bits: torch.Tensor, thresholds=None
) -> torch.Tensor:
    """One BNN layer: SIGN(popcount(XNOR) >= thr), as {0,1} int32 bits.

    The default threshold is ``ceil(n_in/2)`` (``2*pre >= n_in``);
    ``thresholds`` (scalar or ``(n_out,)``) overrides it — the learned-
    threshold variant the compiler expresses through the SIGN immediate.
    """
    n_in = x_bits.shape[-1]
    pre = neuron_preact(x_bits, w_bits)
    if thresholds is None:
        return (2 * pre >= n_in).to(torch.int32)
    thr = torch.as_tensor(thresholds, device=pre.device)
    return (pre >= thr).to(torch.int32)


def forward(
    params: Sequence[torch.Tensor], x_bits: torch.Tensor, thresholds=None
) -> torch.Tensor:
    """Full BNN forward pass on {0,1} bit activations.

    ``thresholds`` optionally carries one entry per layer (``None``, scalar,
    or ``(n_out,)``) mirroring ``compile_bnn(..., thresholds=...)``.
    """
    h = x_bits
    if thresholds is None:
        thresholds = [None] * len(params)
    if len(thresholds) != len(params):
        raise ValueError(
            f"{len(thresholds)} threshold entries for {len(params)} layers"
        )
    for w, thr in zip(params, thresholds):
        h = layer_forward(h, w, thr)
    return h


def forward_pm1(params: Sequence[torch.Tensor], x_pm1: torch.Tensor) -> torch.Tensor:
    """Same network evaluated in ±1 arithmetic (float path, used to prove the
    XNOR-popcount identity: both paths must agree bit-for-bit)."""
    h = x_pm1
    for w in params:
        w_pm1 = bitops.bits_to_sign(w, h.dtype)
        pre = h @ w_pm1.T
        h = torch.where(pre >= 0, 1.0, -1.0).to(h.dtype)
    return h


def packed_forward(params: Sequence[torch.Tensor], x_bits: torch.Tensor) -> torch.Tensor:
    """Forward pass on bit-*packed* words via XNOR + HAKMEM popcount.

    This is the arithmetic the switch (and the packed CUDA kernel) actually
    performs; validated against :func:`forward`.
    """
    h = x_bits
    for w in params:
        n_in = h.shape[-1]
        hp = bitops.pack_bits(bitops.pad_to_word_multiple(h))
        wp = bitops.pack_bits(bitops.pad_to_word_multiple(w))
        dot = bitops.packed_dot(hp[..., None, :], wp, n_in)  # (..., n_out)
        h = (dot >= 0).to(torch.int32)
    return h


# ---------------------------------------------------------------------------
# Training support (BinaryNet-style straight-through estimator).  The paper is
# forward-only; STE training is the framework addition that makes BNN layers
# trainable (``train.bnn_trainer``) and usable inside the LM's BinaryDense
# (``kernels.ops.ste_sign`` is this same primitive).
# ---------------------------------------------------------------------------

class _BinarizeSte(torch.autograd.Function):
    """sign(w) forward; the gradient passes where |w| <= 1 (BinaryNet
    clipping) and is 0 elsewhere."""

    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        one = torch.ones((), dtype=w.dtype, device=w.device)
        return torch.where(bitops.sign_bit(w), one, -one)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * (w.abs() <= 1.0).to(g.dtype)


def binarize_ste(w_latent: torch.Tensor) -> torch.Tensor:
    """sign(w) in ±1 (``w >= 0`` -> +1, ``bitops.sign_bit``) with identity
    gradient inside |w| <= 1 (straight-through)."""
    return _BinarizeSte.apply(w_latent)


def params_from_latent(latent: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Latent fp weights -> {0,1} bit matrices for inference export."""
    return [bitops.sign_to_bits(w) for w in latent]
