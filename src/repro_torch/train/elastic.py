"""Resume a run from its latest checkpoint (the reference's
``train/elastic.py``).

The reference restores the latest checkpoint and reshards it onto a new
device mesh: recomputed PartitionSpecs, ``device_put`` of params and
optimizer state.  On one card there is no mesh to resize, so resharding has
no meaning; what is left is the 1 x 1-mesh case its tests exercise:
restore, then place every leaf on the device with its stored dtype.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt


def rescale(cfg: ModelConfig, directory: str, like: Any, device="cuda") -> Optional[tuple]:
    """Restore the latest valid checkpoint under ``directory`` (``like``
    gives the tree structure) onto ``device``.

    -> (bundle on ``device``, step, extras) or None if no valid checkpoint.
    ``cfg`` is the reference's argument (its mesh rules read it); one card
    needs nothing of it.
    """
    dev = resolve_device(device)
    got = ckpt.restore_latest(directory, like)
    if got is None:
        return None
    bundle, step, extras = got
    return tree.map(lambda t: t.to(dev), bundle), step, extras
