"""Optimizers on trees of tensors (the reference's ``optim/``)."""
