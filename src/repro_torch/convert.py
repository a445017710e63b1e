"""Carry a BNN's weights from the reference package into the port.

The reference keeps parameters as JAX arrays; this module takes them as
numpy arrays (``[np.asarray(w) for w in params]``), so the port never
imports JAX.  The port then compiles and lowers its own program from the
converted weights.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def params_from_jax(
    params: Sequence, thresholds: Sequence | None = None
) -> tuple[list[torch.Tensor], list[torch.Tensor] | None]:
    """Validate and convert reference parameters.

    ``params``: one ``(n_out, n_in)`` {0,1} matrix per layer, each layer's
    ``n_in`` equal to the previous layer's ``n_out``.  ``thresholds``: as in
    ``compile_bnn`` — ``None``, or one entry per layer that is ``None``
    (the default ``ceil(n_in/2)``), a scalar, or ``(n_out,)`` ints in
    ``[0, n_in + 1]``.

    Returns ``(weights, thresholds)``: int32 CPU tensors, and ``None`` or one
    ``(n_out,)`` int32 tensor per layer with every default filled in (which
    compiles and evaluates exactly as the default does).
    """
    weights = []
    for li, w in enumerate(params):
        w = np.asarray(w)
        if w.ndim != 2:
            raise ValueError(f"layer {li}: weights must be (n_out, n_in), got {w.shape}")
        if not np.isin(w, (0, 1)).all():
            raise ValueError(f"layer {li}: weights must be {{0,1}} bits")
        if weights and w.shape[1] != weights[-1].shape[0]:
            raise ValueError(
                f"layer {li}: fan-in {w.shape[1]} != previous layer's "
                f"{weights[-1].shape[0]} outputs"
            )
        weights.append(torch.from_numpy(w.astype(np.int32)))
    if not weights:
        raise ValueError("need at least one layer")
    if thresholds is None:
        return weights, None
    if len(thresholds) != len(weights):
        raise ValueError(f"{len(thresholds)} threshold entries for {len(weights)} layers")
    out = []
    for li, (w, thr) in enumerate(zip(weights, thresholds)):
        n_out, n_in = w.shape
        if thr is None:
            vec = np.full(n_out, (n_in + 1) // 2, np.int64)
        else:
            vec = np.broadcast_to(np.asarray(thr, np.int64), (n_out,))
        if vec.min() < 0 or vec.max() > n_in + 1:
            raise ValueError(f"layer {li}: thresholds must lie in [0, {n_in + 1}]")
        out.append(torch.from_numpy(vec.astype(np.int32)))
    return weights, out
