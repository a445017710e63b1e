"""Imports every architecture config module to populate the registry: the
reference's ten, in its order."""
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    deepseek_v2_236b,
    hubert_xlarge,
    internvl2_2b,
    mamba2_1p3b,
    minicpm3_4b,
    phi3_mini_3p8b,
    qwen3_moe_30b_a3b,
    stablelm_3b,
    zamba2_1p2b,
)

ASSIGNED_ARCHS = (
    "zamba2-1.2b",
    "stablelm-3b",
    "minicpm3-4b",
    "chatglm3-6b",
    "phi3-mini-3.8b",
    "internvl2-2b",
    "deepseek-v2-236b",
    "qwen3-moe-30b-a3b",
    "hubert-xlarge",
    "mamba2-1.3b",
)
