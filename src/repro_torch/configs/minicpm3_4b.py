"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
[hf:openbmb/MiniCPM3-4B; hf].  Multi-head Latent Attention with low-rank q
and compressed kv cache.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import MlaConfig, ModelConfig, register


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        attention="mla",
        mla=MlaConfig(
            kv_lora_rank=256,
            q_lora_rank=768,
            qk_nope_dim=64,
            qk_rope_dim=32,
            v_head_dim=64,
        ),
    )
