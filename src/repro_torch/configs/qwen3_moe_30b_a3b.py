"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768 [hf:Qwen/Qwen3-30B-A3B; hf].
head_dim=128 (explicit in the release).  Full attention -> ``long_500k``
skipped.  FSDP on (30B total params).
"""
from repro_torch.configs.base import ModelConfig, MoeConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        moe=MoeConfig(
            num_experts=128,
            top_k=8,
            expert_ffn_dim=768,
            num_shared=0,
        ),
        fsdp=True,
        decode_cache_carry=False,  # kv=4 cache sequence-shards over model
    )
