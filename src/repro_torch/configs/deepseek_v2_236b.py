"""deepseek-v2-236b [moe]: 60L d_model=5120 128H vocab=102400 — MLA
kv_lora=512, MoE: 2 shared + 160 routed top-6, expert d_ff=1536
[arXiv:2405.04434; hf].

Notes vs the released model: every layer is MoE here (the release uses a
dense first layer) so the stack stays homogeneous and scannable — recorded
in DESIGN.md §8.  FSDP on: 236B params must shard over the data axis too.
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import MlaConfig, ModelConfig, MoeConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        attention="mla",
        mla=MlaConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoeConfig(
            num_experts=160,
            top_k=6,
            expert_ffn_dim=1536,
            num_shared=2,
        ),
        fsdp=True,
        microbatches=16,
        opt_half_moments=True,
        opt_master=False,
    )
