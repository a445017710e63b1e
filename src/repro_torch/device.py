"""Where the port's entry points run.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
GPU that default raises instead of quietly running on the CPU; callers that
want the CPU (the tests) say so.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and no
    CUDA device is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return device
