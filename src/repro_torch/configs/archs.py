"""Imports every architecture config module the port runs, to populate the
registry.  The reference registers ten; the port runs the dense GQA, dense
MLA and MoE models so far (the SSM, hybrid, VLM and audio families wait for
their slices, see ROADMAP.md)."""
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    deepseek_v2_236b,
    minicpm3_4b,
    phi3_mini_3p8b,
    qwen3_moe_30b_a3b,
    stablelm_3b,
)

ASSIGNED_ARCHS = (
    "stablelm-3b",
    "minicpm3-4b",
    "chatglm3-6b",
    "phi3-mini-3.8b",
    "deepseek-v2-236b",
    "qwen3-moe-30b-a3b",
)
