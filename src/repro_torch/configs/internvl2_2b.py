"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
— InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone only per the assignment: the ViT frontend is a STUB —
``input_specs()`` supplies precomputed patch embeddings (B, num_patches,
d_model) that are prepended to the token embeddings.  Full attention ->
``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        input_mode="tokens+patches",
        num_patches=256,
        decode_cache_carry=False,  # kv=8 cache sequence-shards over model
    )
