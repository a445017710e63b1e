"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b family; unverified].  Partial rotary (25%),
full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        rotary_pct=0.25,
    )
