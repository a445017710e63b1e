"""Atomic, restartable checkpoints of trees of tensors, in the reference's
layout (``repro/train/checkpoint.py``)::

    <dir>/step_000123/
        manifest.json          # tree structure, shapes, dtypes, crc32s, extras
        arr_00000.npy ...      # one file per leaf, in the reference's leaf order
    <dir>/LATEST               # committed pointer, written atomically last

A tree is nested lists, tuples, NamedTuples and dicts of tensors
(``repro_torch.tree``); leaves are numbered in the reference's flattening
order, so either package can restore the other's checkpoints.  bf16 leaves
are stored as their uint16 bits with the logical dtype ``bfloat16`` in the
manifest, as the reference stores them.

Commit protocol: write into ``step_N.tmp``, fsync files, rename to
``step_N``, then atomically replace ``LATEST``.  A crash at any point leaves
either the previous checkpoint (pointer not swapped) or a complete new one —
never a half state.  ``restore_latest`` validates the manifest (presence +
crc32) and falls back to older steps if the newest is corrupt.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as _tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array to store, and its logical dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype."""
    arr = np.require(arr, requirements="C")  # keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Any, extras: dict | None = None) -> str:
    """Atomically persist a tree (a bundle of params, optimizer and data state)."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {
        "step": step,
        "treedef": _tree.describe(tree),
        "extras": extras or {},
        "leaves": [],
    }
    for i, leaf in enumerate(_tree.leaves(tree)):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        path = os.path.join(tmp, fname)
        np.save(path, arr)
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
             "crc32": crc}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def _validate(path: str) -> dict | None:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for entry in manifest["leaves"]:
            fpath = os.path.join(path, entry["file"])
            with open(fpath, "rb") as f:
                if zlib.crc32(f.read()) != entry["crc32"]:
                    return None
        return manifest
    except Exception:  # noqa: BLE001 — any corruption means invalid
        return None


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def restore_latest(directory: str, like: Any):
    """-> (tree, step, extras) from the newest VALID checkpoint, or None.

    ``like`` provides the tree structure (e.g. freshly-initialized state);
    the returned tree has its structure with CPU tensors of the stored
    dtypes as leaves.
    """
    candidates = available_steps(directory)
    # prefer the committed pointer, fall back through history on corruption
    latest_path = os.path.join(directory, "LATEST")
    order: list[int] = []
    if os.path.exists(latest_path):
        with open(latest_path) as f:
            name = f.read().strip()
        try:
            order.append(int(name.split("_")[1]))
        except (IndexError, ValueError):
            pass
    order += [s for s in reversed(candidates) if s not in order]

    n_like = len(_tree.leaves(like))
    for step in order:
        path = os.path.join(directory, f"step_{step:08d}")
        manifest = _validate(path)
        if manifest is None:
            continue
        if len(manifest["leaves"]) != n_like:
            continue
        leaves = [
            _from_numpy(np.load(os.path.join(path, e["file"])), e["dtype"])
            for e in manifest["leaves"]
        ]
        return _tree.unflatten(like, leaves), manifest["step"], manifest.get("extras", {})
    return None
