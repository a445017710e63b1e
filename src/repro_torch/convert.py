"""Carry weights from the reference package into the port: a BNN's layers
(:func:`params_from_jax`), a BNN trainer's latent weights
(:func:`bnn_latent_from_jax`) and an LM's parameter tree
(:func:`lm_params_from_jax`).

The reference keeps parameters as JAX arrays; this module takes them as
numpy arrays (``[np.asarray(w) for w in params]``), so the port never
imports JAX.  The port then compiles and lowers its own program from the
converted BNN weights, or runs its LM over the converted tree.
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


def lm_params_from_jax(tree: dict, cfg, *, device="cuda") -> dict:
    """Carry an LM's parameters from the reference package into the port.

    ``tree``: the reference's ``init_params`` pytree with every leaf as a
    numpy array (``jax.tree.map(np.asarray, params)``), layers stacked on a
    leading L axis.  bf16 leaves may come as float32 (exact) or as numpy's
    bfloat16 extension type.  Returns the port's parameters: the same keys,
    ``"layers"`` as one dict per layer, on ``device``:

    * packed sign words (uint32) -> int32 bit views, bit for bit;
    * ``alpha`` and the MoE ``router`` stay float32 (the reference keeps
      them so, whatever the model's type);
    * every other float leaf -> ``cfg.param_dtype()``.
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    dtype = cfg.param_dtype()

    def leaf(path: tuple, a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32).copy()).to(dev)
        if a.dtype.kind in "iu":
            return torch.from_numpy(a.astype(np.int32)).to(dev)
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(dev, torch.float32 if path[-1] == "alpha" or "router" in path else dtype)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf(path, node)

    out = {k: walk(v, (k,)) for k, v in tree.items() if k != "layers"}
    stacked = walk(tree["layers"], ("layers",))
    n_layers = len(next(iter(_leaves(stacked))))
    out["layers"] = [_index(stacked, i) for i in range(n_layers)]
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i].clone()


def bnn_latent_from_jax(latent: Sequence, *, device="cuda") -> list[torch.Tensor]:
    """Carry a BNN trainer's latent weights from the reference package into
    the port: one ``(n_out, n_in)`` float array per layer (``[np.asarray(w)
    for w in trainer.latent]``) -> float32 tensors on ``device``, bit for
    bit.  The port's trainer takes them as its ``latent`` (with a fresh
    ``optimizer.init``)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = []
    for li, w in enumerate(latent):
        w = np.asarray(w)
        if w.ndim != 2 or w.dtype.kind != "f":
            raise ValueError(f"layer {li}: latent must be a 2-D float array, got {w.dtype} {w.shape}")
        if out and w.shape[1] != out[-1].shape[0]:
            raise ValueError(
                f"layer {li}: fan-in {w.shape[1]} != previous layer's {out[-1].shape[0]} outputs"
            )
        out.append(torch.from_numpy(w.astype(np.float32)).to(dev))
    return out
