"""Optimizers on trees of tensors (the reference's ``optim/``): AdamW and
error-feedback gradient compression."""
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule, global_norm
from repro_torch.optim.compression import Compressor

__all__ = ["AdamW", "AdamWState", "Compressor", "cosine_schedule", "global_norm"]
