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


# Leaves the reference keeps float32 whatever the model's type: the packed
# projections' ``alpha``, the MoE ``router`` and Mamba2's ``A_log``, ``D`` and
# ``dt_bias`` (``layers/moe.py``, ``layers/mamba2.py``).
_FLOAT32_LEAVES = ("alpha", "A_log", "D", "dt_bias")


def lm_params_from_jax(tree: dict, cfg, *, device="cuda") -> dict:
    """Carry an LM's parameters from the reference package into the port.

    ``tree``: the reference's ``init_params`` pytree with every leaf as a
    numpy array (``jax.tree.map(np.asarray, params)``).  Its ``layers`` are
    stacked on a leading L axis, or for the hybrid on two, (groups,
    hybrid_period); a hybrid's ``tail`` is stacked on one axis and its
    ``shared`` block not at all.  bf16 leaves may come as float32 (exact)
    or as numpy's bfloat16 extension type.  Returns the port's parameters:
    the same keys, ``"layers"`` as one dict per layer (for the hybrid, a
    list of groups of them), ``"tail"`` as a list, on ``device``:

    * packed sign words (uint32) -> int32 bit views, bit for bit;
    * ``alpha``, the MoE ``router`` and Mamba2's ``A_log``, ``D`` and
      ``dt_bias`` stay float32 (the reference keeps them so, whatever the
      model's type);
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
        keep = path[-1] in _FLOAT32_LEAVES or "router" in path
        return t.to(dev, torch.float32 if keep else dtype)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf(path, node)

    def unstack(node) -> list:
        return [_index(node, i) for i in range(len(next(iter(_leaves(node)))))]

    out = {}
    for key, value in tree.items():
        node = walk(value, (key,))
        if key == "tail":
            node = unstack(node)
        elif key == "layers":
            node = unstack(node)
            if cfg.family == "hybrid":
                node = [unstack(group) for group in node]
        out[key] = node
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
