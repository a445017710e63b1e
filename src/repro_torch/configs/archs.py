"""Imports every architecture config module the port runs, to populate the
registry.  The reference registers ten; the port has the dense GQA model so
far (the other families wait for their slices, see ROADMAP.md)."""
from repro_torch.configs import phi3_mini_3p8b  # noqa: F401

ASSIGNED_ARCHS = ("phi3-mini-3.8b",)
