"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2D/partial RoPE, extreme GQA [arXiv:2406.12793; hf].
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rotary_pct=0.5,  # GLM applies rotary to half the head dims (2D RoPE)
        decode_cache_carry=False,  # kv=2 cache sequence-shards over model
    )
